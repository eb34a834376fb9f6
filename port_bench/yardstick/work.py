"""The chip's published peaks and the work of each hand-written kernel of
the port and of each model step, counted from shapes.

Peaks: one NVIDIA H100 SXM (data sheet, dense): 989 TFLOP/s bf16, 3.35
TB/s HBM3. A kernel call's bound is the larger of its FLOPs over the first
and its bytes over the second. Bytes count each input read once and each
output written once; FLOPs count what the inputs need: the rows and the
(query, key) pairs the masks let through, not the tiles a kernel pads to.
Functions return (flops, bytes).
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


# ---- ESM2 encoder kernels (kernels/fused_encoder.py), bf16, d = 64 ----

def ln_qkv_rope(rows: int, e: int, s: int):
    """LN -> one (rows, E) x (E, 3E) product -> rope; out (3, rows, E)."""
    flops = 2.0 * rows * e * 3 * e
    nbytes = BF16 * (rows * e + 3 * e * e + 3 * e + 2 * e + 3 * rows * e) \
        + 4 * 2 * s * 64
    return flops, nbytes


def encoder_attention(heads: int, d: int, valid, sq_valid: float):
    """Non-causal attention over the valid rows of each batch row: 4 d
    FLOPs per valid (query, key) pair and head; q, k, v and out of the
    valid rows. `valid` = Σ_b v_b, `sq_valid` = Σ_b v_b²."""
    flops = 4.0 * d * heads * sq_valid
    nbytes = BF16 * 4 * heads * d * valid
    return flops, nbytes


def out_proj(rows: int, e: int):
    """x + a @ W + b."""
    return 2.0 * rows * e * e, BF16 * (3 * rows * e + e * e + e)


def ffn(rows: int, e: int, f: int):
    """x + fc2(gelu(fc1(LN(x))))."""
    flops = 2.0 * rows * e * f * 2
    nbytes = BF16 * (2 * rows * e + 2 * e * f + f + e + 2 * e)
    return flops, nbytes


# ---- decoder kernels ----

def flash_attention(b: int, sq: int, skv: int, hq: int, hkv: int, d: int,
                    pairs: float):
    """Forward over the mask-true (query, key) pairs (`pairs`, summed over
    the batch); q, k, v, the bool mask and out."""
    flops = 4.0 * d * hq * pairs
    nbytes = BF16 * (2 * b * sq * hq * d + 2 * b * skv * hkv * d) \
        + b * sq * skv
    return flops, nbytes


def flash_attention_bwd(b: int, s: int, hq: int, hkv: int, d: int,
                        pairs: float, part: str):
    """dq (2 products a pair: dP = dO V^T, dQ = dS K, plus the recompute
    S = Q K^T) or dk/dv (S = Q K^T, dP, dV = P^T dO, dK = dS^T Q)."""
    per_pair = {"dq": 3, "dkv": 4}[part]
    flops = 2.0 * d * hq * pairs * per_pair
    qo = BF16 * b * s * hq * d
    kv = BF16 * b * s * hkv * d
    if part == "dq":       # q, k, v, dO in; dq out; the mask
        nbytes = 3 * qo + 2 * kv + b * s * s
    else:                  # q, k, v, dO in; dk, dv out
        nbytes = 2 * qo + 4 * kv + b * s * s
    return flops, nbytes


def int8_matmul(m: int, k: int, n: int):
    """bf16 x (M, K) @ int8 W (K, N) * fp32 column scales -> bf16."""
    return 2.0 * m * k * n, BF16 * m * k + k * n + 4 * n + BF16 * m * n


def decode_attention_int8(b: int, hq: int, hkv: int, d: int,
                          keys: float):
    """One query token a row over `keys` valid cached positions (summed
    over the rows): int8 K and V plus one fp32 scale each per (position,
    head), q and out."""
    flops = 4.0 * d * hq * keys
    nbytes = hkv * keys * (2 * d + 2 * 4) + BF16 * 2 * b * hq * d
    return flops, nbytes


# ---- model FLOPs (for mfu): 2 FLOPs per weight and token, attention ----

def decoder_layer_params(spec: dict) -> int:
    h, d = spec["hidden_size"], spec["head_dim"]
    qd, kvd = spec["num_heads"] * d, spec["num_kv_heads"] * d
    f = spec["intermediate_size"]
    attn = h * qd + 2 * h * kvd + qd * h
    mlp = 2 * h * f if spec["family"] == "opt" else 3 * h * f
    return attn + mlp


def decoder_flops(spec: dict, tokens: float, attn_pairs: float) -> float:
    """Forward FLOPs of the decoder layers over `tokens` tokens and
    `attn_pairs` (query, key) pairs (summed), without the head."""
    layer = 2.0 * decoder_layer_params(spec) * tokens \
        + 4.0 * spec["num_heads"] * spec["head_dim"] * attn_pairs
    return spec["num_layers"] * layer


def head_flops(spec: dict, tokens: float) -> float:
    return 2.0 * spec["hidden_size"] * spec["vocab_size"] * tokens


def esm_flops(spec: dict, n: int) -> float:
    """ESM2 forward over one protein of n tokens (with <cls>, <eos>)."""
    e, f = spec["esm_dim"], spec["esm_ffn"]
    return spec["esm_layers"] * (2.0 * n * (4 * e * e + 2 * e * f)
                                 + 4.0 * n * n * e)


def bridge_flops(spec: dict) -> float:
    """CSTP's protein projection and the switch, one protein."""
    hn = spec["hidden_size"] * spec["n_tokens"]
    f = spec["cstp_in"] * spec["cstp_out"] + spec["switch_in"] * hn
    f += (spec["switch_depth"] - 1) * hn * hn
    return 2.0 * f
