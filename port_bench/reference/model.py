"""Plain PyTorch reference of the OPUS-PLLM stack, in float32 with TF32 off.

ESM2 (fair-esm `esm2_t33_650M_UR50D`: pre-LN blocks, rotary q/k with
theta 1e4 over half-split pairs, exact GELU, the token-dropout rescale
(1 - 0.15 * 0.8) / (1 - masked share), a final LayerNorm, the mean over
residues), CSTP's protein projection (L2 normalise, one linear), the
`mlpNx_gelu` switch, the splice of the soft tokens in place of the `<seq>`
sentinel, and the decoder families qwen2 (RMSNorm, rotary, GQA, q/k/v
biases, SwiGLU) and opt (LayerNorm, learned positions at offset 2, biases,
fc1 -> GELU -> fc2). One sequence per row, no cache, no padding inside a
row: right padding between rows is masked out of every key set.

Weights are read from the parameter dictionaries that `port_bench`'s own
weight maker fills (`yardstick/weights.py`), one layer at a time, cast to
float32 here. `Precision` decides what a product sees: "fp32" is the
reference; "fp8" is the control of the correctness check (the bf16 parts'
weights and inputs rounded to float8 e4m3 with per-channel / per-row
scales, the fp32 parts' to bfloat16).

Nothing here imports the port, jax or the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

SEQ_SENTINEL = -200
ESM_ALPHABET = [
    "<cls>", "<pad>", "<eos>", "<unk>",
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
    "<null_1>", "<mask>",
]
_ESM_ID = {t: i for i, t in enumerate(ESM_ALPHABET)}
FP8_MAX = 448.0
OPT_POS_OFFSET = 2


def no_tf32() -> None:
    """Full fp32 products on the GPU (the reference's precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def esm_ids(seq: str) -> List[int]:
    """<cls> residues <eos>; unknown letters -> <unk>."""
    return ([_ESM_ID["<cls>"]]
            + [_ESM_ID.get(c, _ESM_ID["<unk>"]) for c in seq.upper()]
            + [_ESM_ID["<eos>"]])


def byte_ids(prompt: str, bos: int = 1, offset: int = 4) -> List[int]:
    """The byte tokenizer's ids of `prompt`: BOS, then UTF-8 bytes + offset,
    each `<seq>` one sentinel."""
    ids = [bos]
    for i, chunk in enumerate(prompt.split("<seq>")):
        if i:
            ids.append(SEQ_SENTINEL)
        ids.extend(b + offset for b in chunk.encode("utf-8"))
    return ids


def _ste(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """`rounded`'s values with x's gradient (a cast to a narrow type would
    round the gradient too, and float8 flushes it to zero)."""
    return x + (rounded - x).detach()


def _fq8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one absmax scale along `dim`."""
    with torch.no_grad():
        s = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-12) / FP8_MAX
        r = (x / s).to(torch.float8_e4m3fn).float() * s
    return _ste(x, r)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        r = x.to(torch.bfloat16).float()
    return _ste(x, r)


class Precision:
    """How a product rounds its operands: "fp32" (the reference) or "fp8"
    (the control: bf16 parts in float8, fp32 parts in bfloat16)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode

    def linear(self, x, p, stated: str = "bf16"):
        w = p["kernel"].float()
        x = x.float()
        if self.mode == "fp8":
            if stated == "bf16":
                w, x = _fq8(w, 0), _fq8(x, -1)
            else:
                w, x = _bf16(w), _bf16(x)
        y = x @ w
        if "bias" in p:
            y = y + p["bias"].float()
        return y

    def lora(self, x, ab, scaling: float):
        """scaling (x A) B of an fp32 adapter (bf16 operands in the
        control)."""
        a, b, x = ab["A"], ab["B"], x.float()
        if self.mode == "fp8":
            a, b, x = _bf16(a.float()), _bf16(b.float()), _bf16(x)
        return scaling * ((x @ a.float()) @ b.float())


def _ln(p, x, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps)


def _rms(p, x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * p["scale"].float()


def _rope(x, pos, theta):
    """x (..., S, H, D) rotated by half-split pairs at integer `pos` (S,)
    or (B, S)."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = pos.double()[..., None] * inv
    ang = torch.cat([ang, ang], -1)
    cos, sin = torch.cos(ang).float()[..., None, :], \
        torch.sin(ang).float()[..., None, :]
    half = d // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], -1)
    return x * cos + rot * sin


def _attend(q, k, v, allowed):
    """q (B, S, Hq, D), k/v (B, S, Hkv, D), allowed (B, S, S) bool."""
    hq, hkv = q.shape[2], k.shape[2]
    if hq != hkv:
        k = k.repeat_interleave(hq // hkv, dim=2)
        v = v.repeat_interleave(hq // hkv, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(q.shape[-1])
    logits = logits.masked_fill(~allowed[:, None], float("-inf"))
    w = torch.softmax(logits, -1).nan_to_num(0.0)
    return torch.einsum("bhqk,bkhd->bqhd", w, v)


# --------------------------------------------------------------------------
# Protein side: ESM2 -> CSTP -> switch
# --------------------------------------------------------------------------

def esm2_pooled(esm, heads: int, seq: str, prec: Precision):
    """One protein -> its pooled final-layer embedding (E,) fp32."""
    dev = esm["embed_tokens"]["embedding"].device
    ids = torch.tensor(esm_ids(seq), device=dev)
    n = ids.shape[0]
    x = esm["embed_tokens"]["embedding"][ids].float() * (1.0 - 0.15 * 0.8)
    pos = torch.arange(n, device=dev)
    allowed = torch.ones((1, n, n), dtype=torch.bool, device=dev)
    e = x.shape[-1]
    d = e // heads
    x = x[None]
    for lp in esm["layers"]:
        r = _ln(lp["attn_norm"], x)
        q, k, v = (prec.linear(r, {"kernel": lp["qkv"]["kernel"][j],
                                   "bias": lp["qkv"]["bias"][j]})
                   .reshape(1, n, heads, d) for j in range(3))
        q, k = _rope(q, pos, 1e4), _rope(k, pos, 1e4)
        a = _attend(q, k, v, allowed).reshape(1, n, e)
        x = x + prec.linear(a, lp["o_proj"])
        r = _ln(lp["ffn_norm"], x)
        x = x + prec.linear(F.gelu(prec.linear(r, lp["fc1"])), lp["fc2"])
    x = _ln(esm["final_norm"], x)[0]
    return x[1:n - 1].mean(0)


def soft_tokens(params, spec, seq: str, prec: Precision):
    """ESM2 -> CSTP protein projection -> switch: (n_tokens, H) fp32."""
    emb = esm2_pooled(params["esm"], spec["esm_heads"], seq, prec)
    if "cstp" in params:
        emb = emb / emb.norm().clamp_min(1e-12)
        emb = prec.linear(emb[None], params["cstp"]["protein_projection"],
                          "fp32")[0]
    h = emb[None]
    layers = params["switch"]["layers"]
    h = prec.linear(h, layers[0], "fp32")
    for p in layers[1:]:
        h = prec.linear(F.gelu(h), p, "fp32")
    return h.reshape(spec["n_tokens"], -1)


def splice_row(llm, ids: Sequence[int], soft: torch.Tensor):
    """Text embeddings with the one sentinel replaced by the soft tokens:
    (n, H) fp32."""
    table = llm["embed_tokens"]["embedding"]
    at = list(ids).index(SEQ_SENTINEL)
    dev = table.device
    head = table[torch.tensor(ids[:at], device=dev, dtype=torch.long)]
    tail = table[torch.tensor(ids[at + 1:], device=dev, dtype=torch.long)]
    return torch.cat([head.float(), soft.float(), tail.float()])


# --------------------------------------------------------------------------
# Decoder
# --------------------------------------------------------------------------

def _decoder_layer(lp, fam, spec, x, pos, allowed, prec, lora=None,
                   scaling: float = 1.0):
    b, s, _ = x.shape
    hq, hkv, d = spec["num_heads"], spec["num_kv_heads"], spec["head_dim"]
    lin = (lambda name, h: prec.linear(h, lp[name])
           + (prec.lora(h, lora[name], scaling)
              if lora is not None and name in lora else 0.0))
    if fam == "opt":
        r = _ln(lp["attn_norm"], x)
    else:
        r = _rms(lp["attn_norm"], x, spec["rms_norm_eps"])
    q = lin("q_proj", r).reshape(b, s, hq, d)
    k = lin("k_proj", r).reshape(b, s, hkv, d)
    v = lin("v_proj", r).reshape(b, s, hkv, d)
    if fam != "opt":
        q, k = _rope(q, pos, spec["rope_theta"]), _rope(k, pos,
                                                        spec["rope_theta"])
    x = x + lin("o_proj", _attend(q, k, v, allowed).reshape(b, s, hq * d))
    if fam == "opt":
        r = _ln(lp["ffn_norm"], x)
        act = {"gelu": F.gelu, "relu": F.relu}[spec["activation"]]
        return x + lin("fc2", act(lin("fc1", r)))
    r = _rms(lp["ffn_norm"], x, spec["rms_norm_eps"])
    return x + lin("down_proj", F.silu(lin("gate_proj", r))
                   * lin("up_proj", r))


def decoder_hidden(llm, spec, embeds, lengths, prec: Precision, lora=None,
                   scaling: float = 1.0, layer_fn=None):
    """embeds (B, S, H) fp32, right-padded to S; row b holds lengths[b]
    positions from 0 -> final-normed hidden states (B, S, H) fp32.
    `layer_fn(i, fn, x)` may wrap each layer's call (checkpointing)."""
    fam = spec["family"]
    b, s, _ = embeds.shape
    dev = embeds.device
    pos = torch.arange(s, device=dev)[None].expand(b, s)
    valid = pos < torch.as_tensor(lengths, device=dev)[:, None]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    allowed = causal[None] & valid[:, None, :]
    x = embeds.float()
    if fam == "opt":
        x = x + llm["embed_positions"]["embedding"][pos + OPT_POS_OFFSET] \
            .float()
    for i, lp in enumerate(llm["layers"]):
        la = lora["layers"][i] if lora is not None else None

        def run(h, lp=lp, la=la):
            return _decoder_layer(lp, fam, spec, h, pos, allowed, prec, la,
                                  scaling)
        x = layer_fn(i, run, x) if layer_fn is not None else run(x)
    if fam == "opt":
        return _ln(llm["final_norm"], x)
    return _rms(llm["final_norm"], x, spec["rms_norm_eps"])


def head(llm, spec, hidden, prec: Precision):
    """Final-normed hidden (..., H) -> logits (..., V) fp32."""
    w = (llm["embed_tokens"]["embedding"].t() if "lm_head" not in llm
         else llm["lm_head"]["kernel"])
    return prec.linear(hidden, {"kernel": w})


def right_pad(rows: Sequence[torch.Tensor]):
    """(n_b, H) rows -> (B, max n, H) zero-padded, and the lengths."""
    n = max(r.shape[0] for r in rows)
    out = rows[0].new_zeros((len(rows), n, rows[0].shape[-1]))
    for i, r in enumerate(rows):
        out[i, :r.shape[0]] = r
    return out, [r.shape[0] for r in rows]


def position_logits(params, spec, prompts: Sequence[Sequence[int]],
                    proteins: Sequence[str], served: Sequence[Sequence[int]],
                    prec: Precision) -> List[torch.Tensor]:
    """Teacher-forced over each prompt (byte ids with one sentinel), its
    protein and its served tokens -> per row the (T, V) fp32 logits that
    predict served token 0 .. T - 1."""
    llm = params["llm"]
    rows, starts = [], []
    for ids, seq, toks in zip(prompts, proteins, served):
        soft = soft_tokens(params, spec, seq, prec)
        pr = splice_row(llm, ids, soft)
        tail = llm["embed_tokens"]["embedding"][
            torch.tensor(list(toks[:-1]), device=pr.device,
                         dtype=torch.long)].float()
        rows.append(torch.cat([pr, tail]))
        starts.append(pr.shape[0] - 1)
    x, lengths = right_pad(rows)
    hid = decoder_hidden(llm, spec, x, lengths, prec)
    return [head(llm, spec, hid[i, s0:s0 + len(t)], prec)
            for i, (s0, t) in enumerate(zip(starts, served))]


def nucleus_floor(logits: torch.Tensor, temp: float,
                  top_p: float) -> torch.Tensor:
    """The lowest logit inside each position's nucleus (T,): the fewest
    most likely tokens whose mass at temperature `temp` reaches `top_p`
    (the argmax alone at temperature 0)."""
    if temp <= 0:
        return logits.max(-1).values
    srt = torch.sort(logits.float(), dim=-1, descending=True).values
    p = torch.softmax(srt / temp, -1)
    kept = ((p.cumsum(-1) - p) < top_p).sum(-1)
    return srt.gather(1, (kept - 1).clamp_min(0)[:, None])[:, 0]


def nucleus_gaps(ref_logits: torch.Tensor, tokens, temp: float,
                 top_p: float) -> torch.Tensor:
    """How far each chosen token's logit lies below the nucleus (T,); 0
    inside it."""
    t = torch.as_tensor(tokens, device=ref_logits.device,
                        dtype=torch.long)
    floor = nucleus_floor(ref_logits, temp, top_p)
    return (floor - ref_logits.gather(1, t[:, None])[:, 0]).clamp_min(0)


def nucleus_sample(logits: torch.Tensor, temp: float, top_p: float,
                   generator: torch.Generator) -> torch.Tensor:
    """One token a position (T,), drawn from the nucleus at temperature
    `temp` (Gumbel-max)."""
    floor = nucleus_floor(logits, temp, top_p)
    z = logits.float() / max(temp, 1e-6)
    z = z.masked_fill(logits < floor[:, None], float("-inf"))
    u = torch.rand(z.shape, generator=generator, device=z.device)
    return (z - torch.log(-torch.log(u.clamp_min(1e-30)))).argmax(-1)
