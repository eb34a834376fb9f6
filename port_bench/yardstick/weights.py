"""Random weights of the whole stack, drawn on the device from the seed.

The distributions are the port's own random draw (a dense kernel and its
bias U(-1/sqrt(in), 1/sqrt(in)), an embedding N(0, 0.02), norms at 1 and
0), but the draws are grouped: every leaf of one distribution and bound
lies in one flat buffer filled by one call of a `torch.Generator` on the
card, and the leaves are views of it. The q/k/v and gate/up leaves that
generation fuses into wider products sit in buffers of their own, so the
unfused copies die once the fused tree replaces them.

The same seed gives the same values, so the reference draws its own copy
after the program's state is freed.
"""

from __future__ import annotations

from collections import OrderedDict

import torch

ALIGN = 128          # elements; every view starts on a 256-byte boundary


def _leaves(spec: dict, llm_dtype, esm_dtype):
    """(path, shape, dtype, dist, bound, group) for every leaf, in a fixed
    order."""
    out = []

    def dense(path, i, o, dt, bias=True, group="keep"):
        b = 1.0 / i ** 0.5
        out.append((path + ("kernel",), (i, o), dt, "u", b, group))
        if bias:
            out.append((path + ("bias",), (o,), dt, "u", b, group))

    def norm(path, n, dt, bias):
        out.append((path + ("scale",), (n,), dt, "one", 0.0, "keep"))
        if bias:
            out.append((path + ("bias",), (n,), dt, "zero", 0.0, "keep"))

    e, f = spec["esm_dim"], spec["esm_ffn"]
    out.append((("esm", "embed_tokens", "embedding"), (spec["esm_vocab"], e),
                esm_dtype, "n", 0.02, "keep"))
    norm(("esm", "final_norm"), e, esm_dtype, True)
    for i in range(spec["esm_layers"]):
        p = ("esm", "layers", i)
        norm(p + ("attn_norm",), e, esm_dtype, True)
        b = 1.0 / e ** 0.5
        out.append((p + ("qkv", "kernel"), (3, e, e), esm_dtype, "u", b,
                    "keep"))
        out.append((p + ("qkv", "bias"), (3, e), esm_dtype, "u", b, "keep"))
        dense(p + ("o_proj",), e, e, esm_dtype)
        norm(p + ("ffn_norm",), e, esm_dtype, True)
        dense(p + ("fc1",), e, f, esm_dtype)
        dense(p + ("fc2",), f, e, esm_dtype)
    fp32 = torch.float32
    dense(("cstp", "protein_projection"), spec["cstp_in"], spec["cstp_out"],
          fp32)
    hid, nt = spec["hidden_size"], spec["n_tokens"]
    dense(("switch", "layers", 0), spec["switch_in"], hid * nt, fp32)
    for j in range(1, spec["switch_depth"]):
        dense(("switch", "layers", j), hid * nt, hid * nt, fp32)

    opt = spec["family"] == "opt"
    dt = llm_dtype
    out.append((("llm", "embed_tokens", "embedding"),
                (spec["vocab_size"], hid), dt, "n", 0.02, "keep"))
    if opt:
        out.append((("llm", "embed_positions", "embedding"),
                    (spec["max_position_embeddings"] + 2, hid), dt, "n",
                    0.02, "keep"))
    norm(("llm", "final_norm"), hid, dt, opt)
    if not spec["tie_word_embeddings"]:
        dense(("llm", "lm_head"), hid, spec["vocab_size"], dt, bias=False)
    qd = spec["num_heads"] * spec["head_dim"]
    kvd = spec["num_kv_heads"] * spec["head_dim"]
    ff = spec["intermediate_size"]
    for i in range(spec["num_layers"]):
        p = ("llm", "layers", i)
        norm(p + ("attn_norm",), hid, dt, opt)
        for name, o in (("q_proj", qd), ("k_proj", kvd), ("v_proj", kvd)):
            dense(p + (name,), hid, o, dt, bias=spec["attention_bias"],
                  group="fuse")
        dense(p + ("o_proj",), qd, hid, dt, bias=opt)
        norm(p + ("ffn_norm",), hid, dt, opt)
        if opt:
            dense(p + ("fc1",), hid, ff, dt)
            dense(p + ("fc2",), ff, hid, dt)
        else:
            dense(p + ("gate_proj",), hid, ff, dt, bias=False, group="fuse")
            dense(p + ("up_proj",), hid, ff, dt, bias=False, group="fuse")
            dense(p + ("down_proj",), ff, hid, dt, bias=False)
    return out


def _put(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
            continue
        if k not in node:
            node[k] = [] if isinstance(nxt, int) else {}
        node = node[k]
    node[path[-1]] = value


def _numel(shape):
    n = 1
    for s in shape:
        n *= s
    return n


def make_weights(spec: dict, seed: int, device, *,
                 llm_dtype=torch.bfloat16, esm_dtype=torch.bfloat16) -> dict:
    """{"esm", "cstp", "switch", "llm"} trees in the port's layout, drawn
    from `seed` on `device`."""
    leaves = _leaves(spec, llm_dtype, esm_dtype)
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for lf in leaves:
        path, shape, dt, dist, bound, group = lf
        groups.setdefault((dt, dist, bound, group), []).append(lf)
    gen = torch.Generator(device=device)
    tree: dict = {}
    for gi, ((dt, dist, bound, _), members) in enumerate(groups.items()):
        gen.manual_seed((int(seed) * 1_000_003 + gi) % (2 ** 63))
        offsets, n = [], 0
        for m in members:
            offsets.append(n)
            n += -(-_numel(m[1]) // ALIGN) * ALIGN
        buf = torch.empty((n,), dtype=dt, device=device)
        if dist == "u":
            buf.uniform_(-bound, bound, generator=gen)
        elif dist == "n":
            buf.normal_(0.0, bound, generator=gen)
        elif dist == "one":
            buf.fill_(1.0)
        else:
            buf.zero_()
        for m, off in zip(members, offsets):
            _put(tree, m[0], buf[off:off + _numel(m[1])].view(m[1]))
    return tree


def make_lora(spec: dict, rank: int, seed: int, device) -> dict:
    """Fresh fp32 adapters on every projection the port's LoRA defaults
    adapt (q/k/v/o, and gate/up/down or nothing for OPT's fc1/fc2), drawn
    as the port draws them: A U(-1/sqrt(in), 1/sqrt(in)), B zero; one
    flat buffer and one call for A."""
    h, d = spec["hidden_size"], spec["head_dim"]
    q, kv = spec["num_heads"] * d, spec["num_kv_heads"] * d
    f = spec["intermediate_size"]
    dims = {"q_proj": (h, q), "k_proj": (h, kv), "v_proj": (h, kv),
            "o_proj": (q, h)}
    if spec["family"] != "opt":
        dims.update({"gate_proj": (h, f), "up_proj": (h, f),
                     "down_proj": (f, h)})
    n_a = sum(i * rank for i, _ in dims.values()) * spec["num_layers"]
    n_b = sum(rank * o for _, o in dims.values()) * spec["num_layers"]
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1_000_003 + 977) % (2 ** 63))
    a_buf = torch.empty((n_a,), dtype=torch.float32, device=device)
    a_buf.uniform_(-1.0, 1.0, generator=gen)
    b_buf = torch.zeros((n_b,), dtype=torch.float32, device=device)
    layers, oa, ob = [], 0, 0
    for _ in range(spec["num_layers"]):
        lp = {}
        for name, (i, o) in dims.items():
            a = a_buf[oa:oa + i * rank].view(i, rank).mul_(1.0 / i ** 0.5)
            lp[name] = {"A": a, "B": b_buf[ob:ob + rank * o].view(rank, o)}
            oa += i * rank
            ob += rank * o
        layers.append(lp)
    return {"layers": layers}
