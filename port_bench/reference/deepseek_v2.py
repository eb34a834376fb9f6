"""Plain PyTorch reference of DeepSeek-V2 (the decoder of the
`deepseek-v2-lite` configuration), in float32 with TF32 off.

The equations of the published modelling code (`modeling_deepseek.py` in
huggingface.co/deepseek-ai/DeepSeek-V2-Lite), written out with no cache,
no absorption and no kernels:

- RMSNorm in fp32 (eps `rms_norm_eps`), before attention, before the MLP
  and at the end; no embedding scale; an untied head.
- Attention (DeepseekV2Attention, q_lora_rank None): q = q_proj(x) split
  per head into nope and rope dims; kv_a_proj_with_mqa(x) split into the
  latent c (kv_lora_rank) and one rope key shared by the heads; c
  RMS-normed (kv_a_layernorm) and decompressed by kv_b_proj into per-head
  nope keys and values; the rope dims of q and k rotated by YaRN rope
  after regrouping their interleaved pairs (evens, then odds); causal
  softmax at scale (nope + rope)^-1/2 x yarn_get_mscale(factor,
  mscale_all_dim)^2; o_proj.
- YaRN (DeepseekV2YarnRotaryEmbedding): inverse frequencies blending
  base^(-2i/d) and the same / factor by a linear ramp between the
  correction dims of beta_fast and beta_slow rotations at
  original_max_position_embeddings; cos and sin times
  yarn_get_mscale(factor, mscale) / yarn_get_mscale(factor,
  mscale_all_dim).
- The first `first_k_dense_replace` layers: a SwiGLU of width
  `intermediate_size`. Every later one (moe_layer_freq 1): the router's
  softmax over `n_routed_experts` in fp32, the top `num_experts_per_tok`
  (greedy), their weights normalised when `norm_topk_prob` else times
  `routed_scaling_factor`, each routed expert a SwiGLU of width
  `moe_intermediate_size` over the tokens routed to it, the weighted sum,
  plus the shared experts as one SwiGLU of width
  moe_intermediate_size x n_shared_experts.

Departures: none in the equations. The weights are random, drawn by the
harness in the program's layout (`yardstick/deepseek.py`), and the prompt
is the byte tokenizer's; the router's auxiliary loss is training-only and
left out, as inference leaves it out.

Weights are upcast to fp32 where they are used (one projection, one
expert at a time), so the bf16 draw is held once and each layer's fp32
copy lives only while it runs. `Precision` (reference/model.py) decides
what a product sees: "fp32" is the reference, "fp8" the control.

Nothing here imports the port, jax or the JAX package.
"""

from __future__ import annotations

import math
from typing import List, Sequence

import torch
import torch.nn.functional as F

from port_bench.reference import model as ref
from port_bench.reference.model import Precision

no_tf32 = ref.no_tf32


def _rms(p, x, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) \
        * p["scale"].float()


def yarn_get_mscale(scale: float = 1.0, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations, dim, base, max_pos):
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_tables(spec, positions):
    """cos, sin (S, rope) of the published YaRN rope at `positions`."""
    d = spec["qk_rope_head_dim"]
    base = spec["rope_theta"]
    rs = spec["rope_scaling"]
    factor = rs["factor"]
    exps = torch.arange(0, d, 2, dtype=torch.float32,
                        device=positions.device) / d
    extra = 1.0 / base ** exps
    inter = 1.0 / (factor * base ** exps)
    orig = rs["original_max_position_embeddings"]
    low = max(math.floor(_correction_dim(rs["beta_fast"], d, base, orig)),
              0)
    high = min(math.ceil(_correction_dim(rs["beta_slow"], d, base, orig)),
               d - 1)
    if low == high:
        high += 0.001
    ramp = ((torch.arange(d // 2, dtype=torch.float32,
                          device=positions.device) - low)
            / (high - low)).clamp(0, 1)
    mask = 1.0 - ramp
    inv = inter * (1 - mask) + extra * mask
    freqs = positions.float()[:, None] * inv[None]
    emb = torch.cat([freqs, freqs], -1)
    m = yarn_get_mscale(factor, rs["mscale"]) / yarn_get_mscale(
        factor, rs["mscale_all_dim"])
    return emb.cos() * m, emb.sin() * m


def _rope(x, cos, sin):
    """x (B, H, S, d): interleaved pairs regrouped, then rotate_half."""
    b, h, s, d = x.shape
    x = x.view(b, h, s, d // 2, 2).transpose(4, 3).reshape(b, h, s, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def softmax_scale(spec) -> float:
    s = (spec["qk_nope_head_dim"] + spec["qk_rope_head_dim"]) ** -0.5
    rs = spec.get("rope_scaling")
    if rs and rs.get("mscale_all_dim"):
        m = yarn_get_mscale(rs["factor"], rs["mscale_all_dim"])
        s = s * m * m
    return s


def _attention(lp, spec, x, cos, sin, allowed, prec):
    b, s, _ = x.shape
    nh = spec["num_attention_heads"]
    dn, dr = spec["qk_nope_head_dim"], spec["qk_rope_head_dim"]
    dv, r = spec["v_head_dim"], spec["kv_lora_rank"]
    q = prec.linear(x, lp["q_proj"]).view(b, s, nh, dn + dr).transpose(1, 2)
    q_nope, q_pe = q[..., :dn], q[..., dn:]
    ckv = prec.linear(x, lp["kv_a_proj"])
    c, k_pe = ckv[..., :r], ckv[..., r:].view(b, s, 1, dr).transpose(1, 2)
    kv = prec.linear(_rms(lp["kv_a_norm"], c, spec["rms_norm_eps"]),
                     lp["kv_b_proj"]).view(b, s, nh, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]
    q_pe, k_pe = _rope(q_pe, cos, sin), _rope(k_pe, cos, sin)
    qs = torch.cat([q_nope, q_pe], -1)
    ks = torch.cat([k_nope, k_pe.expand(b, nh, s, dr)], -1)
    logits = (qs @ ks.transpose(-1, -2)) * softmax_scale(spec)
    logits = logits.masked_fill(~allowed[:, None], float("-inf"))
    w = torch.softmax(logits, -1).nan_to_num(0.0)
    a = (w @ v).transpose(1, 2).reshape(b, s, nh * dv)
    return prec.linear(a, lp["o_proj"])


def _swiglu(p, x, prec):
    return prec.linear(F.silu(prec.linear(x, p["gate_proj"]))
                       * prec.linear(x, p["up_proj"]), p["down_proj"])


def _moe(lp, spec, x, prec):
    shape = x.shape
    t = x.reshape(-1, shape[-1])
    scores = torch.softmax(prec.linear(t, lp["router"], "fp32"), -1)
    w, ids = torch.topk(scores, spec["num_experts_per_tok"], dim=-1)
    if spec["norm_topk_prob"]:
        w = w / (w.sum(-1, keepdim=True) + 1e-20)
    else:
        w = w * spec["routed_scaling_factor"]
    ex = lp["experts"]
    out = torch.zeros_like(t)
    for e in range(spec["n_routed_experts"]):
        tok, slot = (ids == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        one = {n: {"kernel": ex[n]["kernel"][e]}
               for n in ("gate_proj", "up_proj", "down_proj")}
        out.index_add_(0, tok, _swiglu(one, t[tok], prec)
                       * w[tok, slot][:, None])
    return out.view(shape) + _swiglu(lp["shared"], x, prec)


def decoder_hidden(llm, spec, embeds, lengths, prec: Precision):
    """embeds (B, S, H) fp32, right-padded; row b holds lengths[b]
    positions from 0 -> final-normed hidden states (B, S, H) fp32."""
    b, s, _ = embeds.shape
    dev = embeds.device
    pos = torch.arange(s, device=dev)
    cos, sin = yarn_tables(spec, pos)
    valid = pos[None] < torch.as_tensor(lengths, device=dev)[:, None]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=dev))
    allowed = causal[None] & valid[:, None, :]
    eps = spec["rms_norm_eps"]
    x = embeds.float()
    for i, lp in enumerate(llm["layers"]):
        x = x + _attention(lp, spec, _rms(lp["attn_norm"], x, eps), cos, sin,
                           allowed, prec)
        h = _rms(lp["ffn_norm"], x, eps)
        x = x + (_swiglu(lp, h, prec)
                 if i < spec["first_k_dense_replace"]
                 else _moe(lp, spec, h, prec))
    return _rms(llm["final_norm"], x, eps)


def position_logits(params, spec, prompts: Sequence[Sequence[int]],
                    proteins: Sequence[str], served: Sequence[Sequence[int]],
                    prec: Precision) -> List[torch.Tensor]:
    """Teacher-forced over each prompt (byte ids with one sentinel), its
    protein (ESM2 -> CSTP -> switch, reference/model.py) and its served
    tokens -> per row the (T, V) fp32 logits that predict served token 0
    .. T - 1."""
    llm = params["llm"]
    rows, starts = [], []
    for ids, seq, toks in zip(prompts, proteins, served):
        soft = ref.soft_tokens(params, spec, seq, prec)
        pr = ref.splice_row(llm, ids, soft)
        tail = llm["embed_tokens"]["embedding"][
            torch.tensor(list(toks[:-1]), device=pr.device,
                         dtype=torch.long)].float()
        rows.append(torch.cat([pr, tail]))
        starts.append(pr.shape[0] - 1)
    x, lengths = ref.right_pad(rows)
    hid = decoder_hidden(llm, spec, x, lengths, prec)
    return [ref.head(llm, spec, hid[i, s0:s0 + len(t)], prec)
            for i, (s0, t) in enumerate(zip(starts, served))]
