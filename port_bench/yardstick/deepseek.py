"""The deepseek_v2 configurations (`configs/deepseek-*.json`): their size
table, the port's configuration checked against it, their random weights
in the port's layout, and the work the model and the grouped expert GEMM
do, counted from shapes.

The size table carries the file's published keys under their own names
(the reference, `reference/deepseek_v2.py`, reads them) and the protein
side's sizes under the names of `yardstick/spec.py`. Weights follow
`yardstick/weights.py`: grouped draws on the device from the seed, the
port's init distributions (a dense kernel and each expert's U(+-1 /
sqrt(in)), norms 1; embeddings below), the products that generation
fuses (q and kv_a, the SwiGLUs' gate and up, the experts' gate and up) in
buffers of their own, one a layer: each dies once its layer is fused, so
set-up never holds the unfused experts of every layer beside their fused
copies.

One draw departs from `yardstick/weights.py`: the decoder's token
embeddings are N(0, 1) (`EMBED_STD`, torch.nn.Embedding's own default),
not N(0, 0.02). At 0.02 a token's row (0.019 rms) is small beside what
the first layer adds to it, and that addition is nearly the same on every
row: attention averages values over a prompt the rows share. The rows'
hidden states then converge, every row of a decode step routes to the
same 6-8 experts, and the step reads a tenth of the expert weights a
deployment's step reads (PERF.md, section 5). At N(0, 1) each row keeps
its token's direction through the depth, and the rows spread over the
experts.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict

import torch

from port_bench.yardstick import weights as W
from port_bench.yardstick import work

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
EMBED_STD = 1.0        # the decoder's token embeddings (module docstring)
EMBED = ("llm", "embed_tokens", "embedding")


def model_spec(conf: dict) -> dict:
    """The file's keys, plus the protein side's sizes and the head's."""
    esm, switch = conf["esm"], conf["switch"]
    depth = 1 if switch["projector_type"] == "linear" else int(
        switch["projector_type"][3:].split("x")[0])
    spec = {k: v for k, v in conf.items()
            if k not in ("esm", "cstp", "switch", "assumed", "reduced")}
    spec.update({
        "family": conf["model_type"],
        "num_layers": conf["num_hidden_layers"],
        "esm_layers": esm["num_hidden_layers"],
        "esm_dim": esm["hidden_size"],
        "esm_heads": esm["num_attention_heads"],
        "esm_ffn": esm["intermediate_size"],
        "esm_vocab": esm["vocab_size"],
        "cstp_in": conf["cstp"]["protein_dim"],
        "cstp_out": conf["cstp"]["proj_dim"],
        "n_tokens": switch["n_tokens"],
        "switch_in": switch["input_dim"],
        "switch_depth": depth,
    })
    return spec


def program_config(conf: dict):
    """The port's OpusConfig from the preset the file names (or the tiny
    test preset), refused where its numbers differ from the file's."""
    from opus_pllm_tpu_torch.core import config as C
    if conf["preset"] == "tiny":
        base = C.OpusConfig.tiny(conf["model_type"])
        llm = base.llm
    else:
        llm = getattr(C.DecoderConfig, conf["preset"])()
    spec = model_spec(conf)
    if conf["preset"] == "tiny":
        cfg = dataclasses.replace(base, llm=dataclasses.replace(
            llm, dtype=conf["torch_dtype"]))
    else:
        sw = conf["switch"]
        cfg = C.OpusConfig(
            esm=dataclasses.replace(C.ESM2Config.t33_650M(),
                                    dtype=conf["esm"]["dtype"]),
            cstp=C.CSTPConfig(),
            switch=C.SwitchProjectorConfig(
                input_dim=sw["input_dim"], llm_hidden_size=llm.hidden_size,
                n_tokens=sw["n_tokens"],
                projector_type=sw["projector_type"]),
            llm=llm)
    llm = cfg.llm
    rs = conf["rope_scaling"]
    got = {"model_type": llm.family, "vocab_size": llm.vocab_size,
           "hidden_size": llm.hidden_size,
           "intermediate_size": llm.intermediate_size,
           "num_hidden_layers": llm.num_layers,
           "num_attention_heads": llm.num_heads,
           "kv_lora_rank": llm.kv_lora_rank,
           "qk_nope_head_dim": llm.qk_nope_head_dim,
           "qk_rope_head_dim": llm.qk_rope_head_dim,
           "v_head_dim": llm.v_head_dim,
           "n_routed_experts": llm.n_routed_experts,
           "num_experts_per_tok": llm.num_experts_per_tok,
           "moe_intermediate_size": llm.moe_intermediate_size,
           "n_shared_experts": llm.n_shared_experts,
           "first_k_dense_replace": llm.first_k_dense_replace,
           "norm_topk_prob": llm.norm_topk_prob,
           "routed_scaling_factor": llm.routed_scaling_factor,
           "rope_theta": llm.rope_theta, "rms_norm_eps": llm.rms_norm_eps,
           "tie_word_embeddings": llm.tie_word_embeddings,
           "rope_scaling": {"factor": llm.rope_factor,
                            "original_max_position_embeddings":
                                llm.rope_original_max_position,
                            "beta_fast": llm.rope_beta_fast,
                            "beta_slow": llm.rope_beta_slow,
                            "mscale": llm.rope_mscale,
                            "mscale_all_dim": llm.rope_mscale_all_dim},
           "esm_layers": cfg.esm.num_layers, "esm_dim": cfg.esm.embed_dim,
           "esm_heads": cfg.esm.num_heads, "n_tokens": cfg.switch.n_tokens,
           "switch_in": cfg.switch.input_dim,
           "switch_depth": cfg.switch.mlp_depth}
    want = dict(spec, rope_scaling={k: rs[k] for k in got["rope_scaling"]})
    bad = {k: (v, want[k]) for k, v in got.items() if want[k] != v}
    if bad or conf.get("q_lora_rank") is not None \
            or conf.get("moe_layer_freq", 1) != 1:
        raise ValueError(f"the port's preset {conf['preset']} differs from "
                         f"the configuration file: {bad}")
    return cfg, spec


def _llm_leaves(spec: dict, dt):
    """(path, shape, dtype, dist, bound, group) of every decoder layer."""
    out = []
    h, nh = spec["hidden_size"], spec["num_attention_heads"]
    r, dn = spec["kv_lora_rank"], spec["qk_nope_head_dim"]
    dr, dv = spec["qk_rope_head_dim"], spec["v_head_dim"]

    def dense(path, i, o, group="keep"):
        out.append((path + ("kernel",), (i, o), dt, "u", 1.0 / i ** 0.5,
                    group))

    def norm(path, n):
        out.append((path + ("scale",), (n,), dt, "one", 0.0, "keep"))

    def swiglu(path, f, group):
        dense(path + ("gate_proj",), h, f, group)
        dense(path + ("up_proj",), h, f, group)
        dense(path + ("down_proj",), f, h)

    e, fe = spec["n_routed_experts"], spec["moe_intermediate_size"]
    for i in range(spec["num_hidden_layers"]):
        p = ("llm", "layers", i)
        fuse = f"fuse{i}"
        norm(p + ("attn_norm",), h)
        dense(p + ("q_proj",), h, nh * (dn + dr), fuse)
        dense(p + ("kv_a_proj",), h, r + dr, fuse)
        norm(p + ("kv_a_norm",), r)
        dense(p + ("kv_b_proj",), r, nh * (dn + dv))
        dense(p + ("o_proj",), nh * dv, h)
        norm(p + ("ffn_norm",), h)
        if i < spec["first_k_dense_replace"]:
            swiglu(p, spec["intermediate_size"], fuse)
            continue
        dense(p + ("router",), h, e)
        for name, (a, b, group) in (("gate_proj", (h, fe, fuse)),
                                    ("up_proj", (h, fe, fuse)),
                                    ("down_proj", (fe, h, "keep"))):
            out.append((p + ("experts", name, "kernel"), (e, a, b), dt, "u",
                        1.0 / a ** 0.5, group))
        swiglu(p + ("shared",), fe * spec["n_shared_experts"], fuse)
    return out


def make_weights(spec: dict, seed: int, device, *,
                 llm_dtype=torch.bfloat16, esm_dtype=torch.bfloat16) -> dict:
    """{"esm", "cstp", "switch", "llm"} trees in the port's layout (the
    decoder's layers unfused), drawn from `seed` on `device`."""
    front = dict(spec, num_layers=0, num_heads=1, head_dim=1,
                 num_kv_heads=1, intermediate_size=1,
                 max_position_embeddings=1, attention_bias=False)
    leaves = [lf[:4] + (EMBED_STD,) + lf[5:] if lf[0] == EMBED else lf
              for lf in W._leaves(front, llm_dtype, esm_dtype)] \
        + _llm_leaves(spec, llm_dtype)
    groups: "OrderedDict[tuple, list]" = OrderedDict()
    for lf in leaves:
        _, _, dt, dist, bound, group = lf
        groups.setdefault((dt, dist, bound, group), []).append(lf)
    gen = torch.Generator(device=device)
    tree: dict = {}
    for gi, ((dt, dist, bound, _), members) in enumerate(groups.items()):
        gen.manual_seed((int(seed) * 1_000_003 + gi) % (2 ** 63))
        offsets, n = [], 0
        for m in members:
            offsets.append(n)
            n += -(-W._numel(m[1]) // W.ALIGN) * W.ALIGN
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
            W._put(tree, m[0], buf[off:off + W._numel(m[1])].view(m[1]))
    return tree


def draw_weights(conf: dict, spec: dict, seed: int, device) -> dict:
    return make_weights(spec, seed, device,
                        llm_dtype=DTYPES[conf["torch_dtype"]],
                        esm_dtype=DTYPES[conf["esm"]["dtype"]])


# ---- work, counted from shapes ----

def _swiglu_params(h: int, f: int) -> int:
    return 3 * h * f


def expert_params(spec: dict) -> int:
    """One routed expert's weights."""
    return _swiglu_params(spec["hidden_size"], spec["moe_intermediate_size"])


def routed_layers(spec: dict) -> int:
    return spec["num_hidden_layers"] - spec["first_k_dense_replace"]


def layer_params_active(spec: dict, dense: bool) -> int:
    """Weights one token multiplies in a layer: MLA's four projections,
    and the SwiGLU or the router, the top-k experts and the shared ones."""
    h, nh = spec["hidden_size"], spec["num_attention_heads"]
    r, dn = spec["kv_lora_rank"], spec["qk_nope_head_dim"]
    dr, dv = spec["qk_rope_head_dim"], spec["v_head_dim"]
    attn = h * nh * (dn + dr) + h * (r + dr) + r * nh * (dn + dv) \
        + nh * dv * h
    if dense:
        return attn + _swiglu_params(h, spec["intermediate_size"])
    fe = spec["moe_intermediate_size"]
    return (attn + h * spec["n_routed_experts"]
            + spec["num_experts_per_tok"] * _swiglu_params(h, fe)
            + _swiglu_params(h, fe * spec["n_shared_experts"]))


def decoder_flops(spec: dict, tokens: float, attn_pairs: float) -> float:
    """Forward FLOPs of the decoder layers over `tokens` tokens and
    `attn_pairs` (query, key) pairs summed, without the head: 2 a weight a
    token, and 2 (nope + rope) + 2 v a pair and head (attention at
    192 / 128 decompressed, as the model states it)."""
    nh = spec["num_attention_heads"]
    qk = spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]
    per_pair = 2.0 * nh * (qk + spec["v_head_dim"])
    k = spec["first_k_dense_replace"]
    weights = k * layer_params_active(spec, True) \
        + routed_layers(spec) * layer_params_active(spec, False)
    return 2.0 * weights * tokens \
        + spec["num_hidden_layers"] * per_pair * attn_pairs


def head_flops(spec: dict, tokens: float) -> float:
    return 2.0 * spec["hidden_size"] * spec["vocab_size"] * tokens


def decode_weight_bytes(spec: dict, bytes_per: int = 2) -> dict:
    """Bytes of the weights a decode step reads: every weight outside the
    routed experts (the embedding table's rows excepted), and one routed
    expert's."""
    h, v = spec["hidden_size"], spec["vocab_size"]
    e = spec["n_routed_experts"]
    k = spec["first_k_dense_replace"]
    dense_layer = layer_params_active(spec, True)
    routed_layer = layer_params_active(spec, False) \
        - spec["num_experts_per_tok"] * expert_params(spec)
    fixed = k * dense_layer + routed_layers(spec) * routed_layer + h * v
    norms = spec["num_hidden_layers"] * (2 * h + spec["kv_lora_rank"]) + h
    return {"fixed": bytes_per * (fixed + norms),
            "expert": bytes_per * expert_params(spec),
            "experts": e, "routed_layers": routed_layers(spec)}


def moe_grouped_gemm(pairs: int, k: int, n: int, hit: float,
                     swiglu: bool):
    """The grouped GEMM over `pairs` rows: 2 K N FLOPs a row; the weights
    of the `hit` experts with a row, the rows in and the output out."""
    n_out = n // 2 if swiglu else n
    flops = 2.0 * pairs * k * n
    nbytes = work.BF16 * (hit * k * n + pairs * k + pairs * n_out) + 4 * (
        hit + 1)
    return flops, nbytes
