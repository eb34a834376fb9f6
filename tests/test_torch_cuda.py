"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes the main path can also produce (stage (a)'s precompute over
the llama, qwen2 and opt text LMs included): the four fused-encoder
kernels (ln_qkv_rope, out_proj and ffn at every tile width of their TMA +
wgmma core, bit-identical across calls), the int4 v2 matmul, both quantized
decode attentions and the bf16 one (with the benchmark's kernel probe
installed too), flash
attention, the int8 matmul, the two flash-attention backward kernels and
the int4 v1 matmul (an N that a quantized matmul's kernel does not take
takes the dequantize route, the JAX `_matmul_xla` function, with no
launch); then
the gradients through the autograd Functions and the launch counts of one
tiny train step; flash at the serving engine's option masks and a tiny
engine with every option; `generate`'s decode step replayed as a CUDA
graph against the same step run eagerly; the grouped expert GEMM at
DeepSeek-V2-Lite's decode and prefill shapes and the deepseek_v2 decode
graph against its eager step (a CUDA kernel has no CPU mode: these skip
where torch sees no GPU). Run on a GPU machine with:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: tests/conftest.py configures JAX, which a GPU machine
need not have; nothing here imports it).

Tolerance as in chip_smoke.py: max|kernel - plain_fp32| <= 2 *
max|plain_bf16 - plain_fp32| + 4e-3, i.e. the kernel may not lose more than
the bf16 output format forces plus half a bf16 ulp at magnitude 1-2.
plain_fp32 runs the plain version on the same values in fp32 (the int4
matmul rounds x to bf16 in both), plain_bf16 in bf16.
"""

import dataclasses

import numpy as np
import pytest
import torch

from opus_pllm_tpu_torch.core.config import (CSTPConfig, DecoderConfig,
                                             ESM2Config, LoRAConfig,
                                             OpusConfig,
                                             SwitchProjectorConfig,
                                             TrainConfig)
from opus_pllm_tpu_torch.kernels import decode_attention as da
from opus_pllm_tpu_torch.kernels import flash_attention as fa
from opus_pllm_tpu_torch.kernels import flash_attention_bwd as fab
from opus_pllm_tpu_torch.kernels import fused_encoder as fe
from opus_pllm_tpu_torch.kernels import quant, quant4
from opus_pllm_tpu_torch.models import decoder, esm2, layers, opus
from opus_pllm_tpu_torch.models.layers import rope_cos_sin
from opus_pllm_tpu_torch.train import multimodal_trainer as mmt

pytestmark = pytest.mark.cuda
ATOL = 4e-3


@pytest.fixture(autouse=True)
def _need_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")


def _gen():
    return torch.Generator(device="cuda").manual_seed(0)


def _rnd(g, *shape, scale=1.0):
    return (torch.randn(shape, generator=g, device="cuda") * scale).to(
        torch.bfloat16)


def _check_dequant_route(out, x, w):
    """An N a kernel's tensor maps cannot describe: the JAX `_matmul_xla`
    function written out, x rounded to bf16 times `w` (the weights
    dequantized to bf16 with the scales rounded to bf16), fp32
    accumulation, one rounding to x's dtype; fp32 summation order apart."""
    ref = x.to(torch.bfloat16).float() @ w.float()
    torch.cuda.synchronize()
    bound = 1e-5 * ref.abs().max().item()
    if x.dtype == torch.bfloat16:
        bound = bound + 2 ** -8 * ref.abs()
    assert out.dtype == x.dtype and out.shape == ref.shape
    assert ((out.float() - ref).abs() <= bound).all()


def _int4_bf16_weights(q, s):
    """(K, N) int4 values times their group scales rounded to bf16, in
    bf16, as `_matmul_xla` builds them."""
    k, n = q.shape
    return (q.float().reshape(k // 128, 128, n)
            * s.bfloat16().float()[:, None, :]).reshape(k, n).bfloat16()


def _check(kern, plain, bf_in, extra=(), scaled=False):
    """scaled: ATOL times max(1, max|plain_fp32|), for gradients."""
    ref32 = plain(*(t.float() for t in bf_in), *extra).float()
    ref_bf = plain(*bf_in, *extra).float()
    out = kern(*bf_in, *extra)
    torch.cuda.synchronize()
    err = (out.float() - ref32).abs().max().item()
    atol = ATOL * (max(1.0, ref32.abs().max().item()) if scaled else 1.0)
    bound = 2 * (ref_bf - ref32).abs().max().item() + atol
    assert out.shape == ref32.shape and err <= bound, (err, bound)


@pytest.mark.parametrize("b,s,e", [(2, 1, 256), (3, 70, 256), (1, 200, 1280)])
def test_ln_qkv_rope(b, s, e):
    g = _gen()
    cos, sin = rope_cos_sin(torch.arange(s, device="cuda"), 64)
    ln = torch.stack([1 + 0.1 * torch.randn(e, generator=g, device="cuda"),
                      0.1 * torch.randn(e, generator=g, device="cuda")]
                     ).to(torch.bfloat16)
    _check(fe.ln_qkv_rope, fe.ln_qkv_rope_plain,
           (_rnd(g, b, s, e), _rnd(g, 3, e, e, scale=e ** -0.5),
            _rnd(g, 3, e, scale=0.1), ln), (cos, sin))


def _key_mask(g, b, s, kind):
    """(B, S) key rows: None; ragged lengths with one row of length 1; or
    a row whose tail tiles are all padding beside an unpadded one."""
    if kind == "none":
        return None
    lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    lengths[0] = 1
    if kind == "tail" and b > 1:
        lengths[0], lengths[1] = s, min(s, 3)
    return torch.arange(s, device="cuda")[None] < lengths[:, None]


@pytest.mark.parametrize("s", [1, 70, 129, 200, 512])
@pytest.mark.parametrize("kind", ["none", "ragged", "tail"])
def test_encoder_attention(s, kind):
    """H = 20 (ESM2-650M), B = 3: padded key tiles are skipped, full ones
    unmasked, ragged edges masked; one launch a call."""
    g = _gen()
    mask = _key_mask(g, 3, s, kind)
    fe.reset_launches()
    _check(fe.encoder_attention, fe.encoder_attention_plain,
           (_rnd(g, 3, 3, 20, s, 64),), (mask,))
    assert fe.launches["encoder_attention"] == 1


def test_encoder_attention_row_without_valid_key_is_zero():
    """The chosen rule: a batch row with no valid key gets out 0, as the
    plain version gives it; the other rows are unaffected."""
    g = _gen()
    qkv = _rnd(g, 3, 2, 20, 200, 64)
    mask = torch.ones((2, 200), dtype=torch.bool, device="cuda")
    mask[1] = False
    out = fe.encoder_attention(qkv, mask)
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    _check(fe.encoder_attention, fe.encoder_attention_plain, (qkv,), (mask,))


@pytest.mark.parametrize("m,e", [(1, 256), (130, 256), (257, 1280)])
def test_out_proj_and_ffn(m, e):
    g = _gen()
    x = _rnd(g, 1, m, e)
    _check(fe.out_proj, fe.out_proj_plain,
           (_rnd(g, 1, m, e, scale=0.5), _rnd(g, e, e, scale=e ** -0.5),
            _rnd(g, e, scale=0.1), x))
    f = 4 * e
    ln = torch.stack([torch.ones(e, device="cuda"),
                      torch.zeros(e, device="cuda")]).to(torch.bfloat16)
    _check(fe.ffn, fe.ffn_plain,
           (x, _rnd(g, e, f, scale=e ** -0.5), _rnd(g, f, scale=0.1),
            _rnd(g, f, e, scale=f ** -0.5), _rnd(g, e, scale=0.1), ln))


def _encoder_inputs(g, b, s, e, f):
    cos, sin = rope_cos_sin(torch.arange(s, device="cuda"), 64)
    ln = torch.stack([1 + 0.1 * torch.randn(e, generator=g, device="cuda"),
                      0.1 * torch.randn(e, generator=g, device="cuda")]
                     ).to(torch.bfloat16)
    x = _rnd(g, b, s, e)
    qkv_in = (x, _rnd(g, 3, e, e, scale=e ** -0.5), _rnd(g, 3, e, scale=0.1),
              ln)
    ffn_in = (x, _rnd(g, e, f, scale=e ** -0.5), _rnd(g, f, scale=0.1),
              _rnd(g, f, e, scale=f ** -0.5), _rnd(g, e, scale=0.1), ln)
    return qkv_in, (cos, sin), ffn_in


@pytest.mark.parametrize("s", [1, 70, 128, 512])
@pytest.mark.parametrize("e,f", [(128, 384), (1280, 5120)])
def test_ln_qkv_rope_and_ffn_on_the_wgmma_core(s, e, f):
    """B = 3: B*S ragged at S = 1 and 70 (rows past M zero-filled by TMA,
    not stored); E = 128 puts a QKV tile boundary at every j * E. One
    counted launch a call, and the same bits from two calls."""
    qkv_in, rope, ffn_in = _encoder_inputs(_gen(), 3, s, e, f)
    fe.reset_launches()
    _check(fe.ln_qkv_rope, fe.ln_qkv_rope_plain, qkv_in, rope)
    _check(fe.ffn, fe.ffn_plain, ffn_in)
    assert fe.launches["ln_qkv_rope"] == 1 and fe.launches["ffn"] == 1
    assert torch.equal(fe.ln_qkv_rope(*qkv_in, *rope),
                       fe.ln_qkv_rope(*qkv_in, *rope))
    assert torch.equal(fe.ffn(*ffn_in), fe.ffn(*ffn_in))


@pytest.mark.parametrize("bn", fe.FFN_TILE_WIDTHS)
@pytest.mark.parametrize("s", [70, 512])
def test_every_tile_width_matches_plain(monkeypatch, bn, s):
    """Each product at each tile width the core takes (the plan picks one
    per shape; 160 only where the epilogue is not per head); at E = 1280 a
    256-wide QKV tile ends at j * E."""
    qkv_in, rope, ffn_in = _encoder_inputs(_gen(), 3, s, 1280, 5120)
    monkeypatch.setattr(fe, "tile_width", lambda *args, **kw: bn)
    if bn in fe.TILE_WIDTHS:
        _check(fe.ln_qkv_rope, fe.ln_qkv_rope_plain, qkv_in, rope)
    _check(fe.ffn, fe.ffn_plain, ffn_in)


def _out_proj_inputs(g, b, s, e):
    return (_rnd(g, b, s, e, scale=0.5), _rnd(g, e, e, scale=e ** -0.5),
            _rnd(g, e, scale=0.1), _rnd(g, b, s, e))


@pytest.mark.parametrize("s", [1, 70, 128, 512])
@pytest.mark.parametrize("e", [128, 1280])
def test_out_proj_on_the_wgmma_core(monkeypatch, s, e):
    """B = 3 (B*S ragged at S = 1 and 70): the planned width, then every
    width out_proj takes (OUT_TILE_WIDTHS) that divides E; one counted
    launch a call and the same bits from two calls."""
    args = _out_proj_inputs(_gen(), 3, s, e)
    fe.reset_launches()
    _check(fe.out_proj, fe.out_proj_plain, args)
    assert fe.launches["out_proj"] == 1
    assert torch.equal(fe.out_proj(*args), fe.out_proj(*args))
    for bn in fe.OUT_TILE_WIDTHS:
        if e % bn:
            continue
        monkeypatch.setattr(fe, "tile_width", lambda *a, b=bn, **kw: b)
        _check(fe.out_proj, fe.out_proj_plain, args)
        assert torch.equal(fe.out_proj(*args), fe.out_proj(*args))


def test_tile_width_the_core_does_not_take_raises(monkeypatch):
    """A width the core does not take (64; 160 for the QKV product, whose
    tiles hold whole heads; 256 for out_proj, whose tile buffer would
    leave the ring three stages) is refused by the C entry point and the
    wrapper raises: nothing falls back."""
    qkv_in, rope, ffn_in = _encoder_inputs(_gen(), 1, 8, 640, 640)
    for bn in (64, 160):
        monkeypatch.setattr(fe, "tile_width", lambda *args, b=bn, **kw: b)
        with pytest.raises(RuntimeError, match="ln_qkv_rope"):
            fe.ln_qkv_rope(*qkv_in, *rope)
    monkeypatch.setattr(fe, "tile_width", lambda *args, **kw: 64)
    with pytest.raises(RuntimeError, match="ffn"):
        fe.ffn(*ffn_in)
    with pytest.raises(RuntimeError, match="out_proj"):
        fe.out_proj(*_out_proj_inputs(_gen(), 1, 8, 640))
    monkeypatch.setattr(fe, "tile_width", lambda *args, **kw: 256)
    with pytest.raises(RuntimeError, match="out_proj"):
        fe.out_proj(*_out_proj_inputs(_gen(), 1, 8, 1280))


def test_wrappers_raise_instead_of_falling_back():
    x = torch.zeros((1, 8, 256), device="cuda")          # fp32: refused
    w = torch.zeros((3, 256, 256), device="cuda")
    with pytest.raises(TypeError):
        fe.ln_qkv_rope(x, w, w[:, 0], w[:2, 0], x[0, :, :64], x[0, :, :64])
    bad = torch.zeros((3, 1, 2, 8, 32), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):
        fe.encoder_attention(bad)


def test_esm2_auto_takes_kernels_and_matches_plain():
    cfg = ESM2Config(num_layers=2, embed_dim=256, num_heads=4,
                     dtype="bfloat16")
    params = esm2.init(cfg, generator=_gen(), device="cuda")
    toks, _ = esm2.tokenize(["MKTAYIAKQRQISFVKSHFSRQ", "ACDEF"])
    toks = torch.from_numpy(toks).cuda()
    fe.reset_launches()
    got = esm2.pooled_embedding(params, cfg, toks, impl="auto")
    assert fe.launches == {k: cfg.num_layers for k in fe.launches}
    plain_bf = esm2.pooled_embedding(params, cfg, toks, impl="torch")
    to32 = lambda t: ({k: to32(v) for k, v in t.items()} if isinstance(t, dict)
                      else [to32(v) for v in t] if isinstance(t, list)
                      else t.float())
    ref = esm2.pooled_embedding(to32(params), cfg, toks, impl="torch")
    err = (got - ref).abs().max().item()
    assert err <= 2 * (plain_bf - ref).abs().max().item() + ATOL


@pytest.mark.parametrize("k", [512, 4096, 14336])
@pytest.mark.parametrize("n", [130, 1024, 4096, 14336])
def test_int4_matmul(k, n):
    """M in {1, 3, 8, 17, 33, 64} (one or two 8-row tiles a CTA, ragged
    M), bf16 and fp32 x. The tensor-core kernel, whose K splits over
    clusters of 1 to 8 CTAs (quant4.v2_plan), one launch a call; N = 130
    (N % 4 != 0, which a tensor map cannot describe) takes the dequantize
    route, with no launch."""
    g = _gen()
    q, s = quant4.quantize_grouped(
        torch.randn((k, n), generator=g, device="cuda"))
    packed = quant4.pack_int4_v2(q)
    w = _int4_bf16_weights(q, s)
    del q
    takes = n != 130
    for m in (1, 3, 8, 17, 33, 64):
        x = _rnd(g, m, k)
        assert quant4.kernel_shape(x, packed) == takes
        quant4.reset_launches()
        if takes:
            _check(lambda x: quant4.int4_matmul(x, packed, s),
                   lambda x: quant4.int4_matmul_plain(x, packed, s), (x,))
        else:
            _check_dequant_route(quant4.int4_matmul(x, packed, s), x, w)
        assert quant4.launches == {"int4_matmul": int(takes),
                                   "int4_matmul_v1": 0}
        # fp32 x: the output stays fp32 and differs from the plain version
        # (or, at N = 130, from the dequantize route's function) by
        # summation order only
        out = quant4.int4_matmul(x.float(), packed, s)
        if takes:
            ref = quant4.int4_matmul_plain(x.float(), packed, s)
            assert out.dtype == torch.float32
            assert ((out - ref).abs().max().item()
                    <= 1e-5 * ref.abs().max().item())
        else:
            _check_dequant_route(out, x.float(), w)


def test_int4_matmul_cluster_plans_are_deterministic():
    """The decode shapes' plans span cluster sizes 1 to 8; each gives the
    same bits on a repeated call (a fixed reduction order, no atomics) and
    matches the plain version."""
    g = _gen()
    seen = set()
    for k, n in ((4096, 1024), (4096, 4096), (4096, 14336), (14336, 4096),
                 (4096, 128256)):
        seen.add(quant4.v2_plan(8, n, k)[1])
        q, s = quant4.quantize_grouped(
            torch.randn((k, n), generator=g, device="cuda"))
        packed = quant4.pack_int4_v2(q)
        del q
        x = _rnd(g, 8, k)
        out = quant4.int4_matmul(x, packed, s)
        assert torch.equal(out, quant4.int4_matmul(x, packed, s))
        _check(lambda x: quant4.int4_matmul(x, packed, s),
               lambda x: quant4.int4_matmul_plain(x, packed, s), (x,))
        del packed, s
    assert seen == {1, 4, 5, 8}


def _decode_mask(g, b, cap, mask):
    """(B, cap) slot masks: "ragged" right-ragged lengths; "left" the
    static decode's (left padding, a prompt, then an unwritten tail);
    "holes" ragged lengths with every third 16-slot slab and every fifth
    slot cleared, slot 0 kept in every row."""
    lengths = torch.randint(1, cap + 1, (b,), generator=g, device="cuda")
    slots = torch.arange(cap, device="cuda")[None]
    if mask == "left":
        pad = torch.randint(0, cap, (b,), generator=g, device="cuda")
        return (slots >= pad[:, None]) & (slots < pad[:, None]
                                          + lengths[:, None])
    m = slots < lengths[:, None]
    if mask == "holes":
        m &= ((slots // 16) % 3 != 1) & (slots % 5 != 4)
        m[:, 0] = True
    return m


def _cache(g, b, hkv, cap, d, kind, mask="ragged"):
    quant = decoder._quantize_kv4 if kind == "int4" else decoder._quantize_kv
    kv = [quant(torch.randn((b, cap, hkv, d), generator=g, device="cuda"))
          for _ in range(2)]
    m = _decode_mask(g, b, cap, mask)
    contig = lambda leaf: {k: v.contiguous() for k, v in leaf.items()}
    return contig(kv[0]), contig(kv[1]), m[:, None, None, :]


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("cap", [1, 63, 64, 65, 255, 391, 2048, 4097])
@pytest.mark.parametrize("mask", ["ragged", "left", "holes"])
def test_decode_attention(kind, d, group, cap, mask):
    """Every row has a valid slot; slabs false everywhere are skipped,
    ragged edges masked, the splits merged; one launch a call."""
    g = _gen()
    b, hkv = 3, 2
    kl, vl, mask4 = _cache(g, b, hkv, cap, d, kind, mask)
    q = _rnd(g, b, 1, hkv * group, d, scale=0.5)
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    da.reset_launches()
    _check(lambda q: fn(q, kl, vl, mask4),
           lambda q: da.decode_attention_plain(q, kl, vl, mask4), (q,))
    assert da.launches[f"decode_attention_{kind}"] == 1


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_attention_rows_without_a_slot_and_in_one_tile(kind):
    """A row with no valid slot gets out exactly 0 (as the plain version
    gives it); a row valid only inside one 64-slot tile of a split range,
    and the other rows, match the plain version."""
    g = _gen()
    b, hkv, cap = 4, 8, 391
    kl, vl, mask4 = _cache(g, b, hkv, cap, 128, kind)
    mask4 = mask4.clone()
    mask4[1] = False
    mask4[2] = False
    mask4[2, ..., 130:141] = True
    q = _rnd(g, b, 1, 4 * hkv, 128, scale=0.5)
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    out = fn(q, kl, vl, mask4)
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    assert da.decode_splits(b, hkv, cap) > 1
    _check(lambda q: fn(q, kl, vl, mask4),
           lambda q: da.decode_attention_plain(q, kl, vl, mask4), (q,))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("b,cap", [(3, 2048), (8, 391), (32, 2048)])
def test_decode_attention_is_deterministic(kind, b, cap):
    """The cluster merge runs in a fixed order: two calls, the same bits."""
    g = _gen()
    kl, vl, mask4 = _cache(g, b, 8, cap, 128, kind, "left")
    q = _rnd(g, b, 1, 32, 128, scale=0.5)
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    assert torch.equal(fn(q, kl, vl, mask4), fn(q, kl, vl, mask4))


def test_quantized_wrappers_raise_instead_of_falling_back():
    q, s = quant4.quantize_grouped(torch.randn((512, 8), device="cuda"))
    x = torch.zeros((2, 512), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):            # N % 4 != 0 at the launcher
        quant4._kernel(x, quant4.pack_int4_v2(q[:, :5]), s[:, :5])
    with pytest.raises(ValueError):            # words on the CPU
        quant4.int4_matmul(x, quant4.pack_int4_v2(q).cpu(), s)
    kl, vl, mask4 = _cache(_gen(), 1, 1, 8, 128, "int8")
    q1 = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):            # int mask
        da.decode_attention_int8(q1, kl, vl, mask4.int())
    with pytest.raises(ValueError):            # int8 leaves to the int4 one
        da.decode_attention_int4(q1, kl, vl, mask4)


def _annotate_mask(g, b, cap, prompt):
    """(B, cap) masks of the static decode: row i's prompt of 1..`prompt`
    tokens left-padded to `prompt` slots, then 0..cap - prompt written
    steps; rows 0 and 1 hold one prompt token, so their first 64-slot
    tiles are masked everywhere."""
    n = torch.randint(1, prompt + 1, (b,), generator=g, device="cuda")
    steps = torch.randint(0, cap - prompt + 1, (b,), generator=g,
                          device="cuda")
    n[:2] = 1
    steps[0], steps[-1] = 0, cap - prompt
    slots = torch.arange(cap, device="cuda")[None]
    return (slots >= prompt - n[:, None]) & (slots < prompt + steps[:, None])


# (B, Hq, Hkv, D, cap, prompt): the qwen2.5-7b annotate cell (valid slots
# ending at 327..455), Galactica-6.7B's heads, Llama-3-8B's, D = 64
BF16_DECODE_SHAPES = [(128, 28, 4, 128, 455, 327), (8, 32, 32, 128, 391, 327),
                      (8, 32, 8, 128, 391, 327), (17, 16, 4, 64, 200, 120),
                      (3, 8, 1, 128, 65, 64), (2, 8, 8, 64, 1, 1)]


@pytest.mark.parametrize("b,hq,hkv,d,cap,prompt", BF16_DECODE_SHAPES)
def test_decode_attention_bf16(b, hq, hkv, d, cap, prompt):
    """The bf16 kernel against its plain version (attention_xla) over a
    left-padded bf16 cache, one launch a call, the same bits on a second
    call. Tolerance as the module's (2 x the plain bf16 path's error +
    4e-3): the plain path rounds q / sqrt(D), the normalized weights and
    the output to bf16, the kernel the output only (the weights keep ~16
    bits), so only its summation order may add error beyond the plain
    bf16 path's."""
    g = _gen()
    mask4 = _annotate_mask(g, b, cap, prompt)[:, None, None, :]
    q = _rnd(g, b, 1, hq, d, scale=0.5)
    k, v = _rnd(g, b, cap, hkv, d), _rnd(g, b, cap, hkv, d)
    assert da.supports_bf16(q, k, mask4)
    da.reset_launches()
    _check(lambda q, k, v: da.decode_attention_bf16(q, k, v, mask4),
           lambda q, k, v: layers.attention_xla(q, k, v, mask4), (q, k, v))
    assert da.launches == {"decode_attention_int8": 0,
                           "decode_attention_int4": 0,
                           "decode_attention_bf16": 1}
    assert torch.equal(da.decode_attention_bf16(q, k, v, mask4),
                       da.decode_attention_bf16(q, k, v, mask4))


def test_decode_attention_bf16_row_without_a_slot_is_zero():
    """A row with no valid slot gets out exactly 0; a row valid inside one
    tile of a split range, and the other rows, match the plain version;
    an fp32 q is refused (the gate takes bf16 only)."""
    g = _gen()
    b, hq, hkv, cap = 4, 32, 8, 391
    mask4 = _decode_mask(g, b, cap, "left")[:, None, None, :].clone()
    mask4[1] = False
    mask4[2] = False
    mask4[2, ..., 130:141] = True
    q = _rnd(g, b, 1, hq, 128, scale=0.5)
    k, v = _rnd(g, b, cap, hkv, 128), _rnd(g, b, cap, hkv, 128)
    assert da.decode_splits(b, hkv, cap) > 1
    out = da.decode_attention_bf16(q, k, v, mask4)
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    keep = [0, 2, 3]
    _check(lambda q, k, v: da.decode_attention_bf16(q, k, v, mask4)[keep],
           lambda q, k, v: layers.attention_xla(q, k, v, mask4)[keep],
           (q, k, v))
    with pytest.raises(TypeError):
        da.decode_attention_bf16(q.float(), k, v, mask4)


def test_decode_step_under_the_kernel_probe():
    """One decode step over a bf16 cache through the bf16 kernel while the
    benchmark's KernelProbe wraps the launchers: the probe records the
    quantized launcher only (it reads a quantized leaf's scales), so the
    step runs, and the probe's bounds read, without error."""
    from opus_pllm_tpu_torch.infer import engine
    from port_bench.yardstick.instrument import KernelProbe
    cfg = DecoderConfig(family="qwen2", vocab_size=1024, hidden_size=512,
                        intermediate_size=1024, num_layers=2, num_heads=7,
                        num_kv_heads=1, head_dim=128, attention_bias=True,
                        dtype="bfloat16")
    g = _gen()
    llm = decoder.init(cfg, generator=g, device="cuda")
    x = _rnd(g, 4, 12, 512, scale=0.5)
    am = torch.ones((4, 12), dtype=torch.bool, device="cuda")
    am[1:, :6] = False
    probe = KernelProbe()
    da.reset_launches()
    with probe.installed():
        out = engine.generate(llm, cfg, x, am, decoder.positions_from_mask(
            am), torch.Generator(device="cuda").manual_seed(0),
            max_new_tokens=2, temperature=0.0, eos_token_id=-1)
    torch.cuda.synchronize()
    assert out.steps == 2
    assert da.launches["decode_attention_bf16"] == 2 * cfg.num_layers
    assert "decode_attention" not in probe.bounds()


def _flash_inputs(g, b, sq, skv, hq, hkv, d, mask_kind):
    q = _rnd(g, b, sq, hq, d)
    k, v = _rnd(g, b, skv, hkv, d), _rnd(g, b, skv, hkv, d)
    mask = None
    if mask_kind == "prefill":
        # the serving prefill's mask: causal within each row's valid prompt
        n = torch.randint(1, sq + 1, (b,), generator=g, device="cuda")
        n[0] = sq
        ar = torch.arange(skv, device="cuda")
        rows = torch.arange(sq, device="cuda")
        mask = ((ar[None, None, None, :] <= rows[None, None, :, None])
                & (ar[None, None, None, :] < n[:, None, None, None]))
    elif mask_kind == "padded":
        # the static prefill's: left padding over a longer cache
        lengths = torch.randint(1, skv + 1, (b,), generator=g, device="cuda")
        mask = (torch.arange(skv, device="cuda")[None] < lengths[:, None]
                )[:, None, None, :].expand(b, 1, sq, skv)
    elif mask_kind == "static":
        # the static prefill's: left padding and causality over a longer
        # cache, so the rows before a row's padding ends see no key
        pad = torch.randint(0, sq, (b,), generator=g, device="cuda")
        cols = torch.arange(skv, device="cuda")[None, None, None, :]
        rows = torch.arange(sq, device="cuda")[None, None, :, None]
        mask = (cols <= rows) & (cols >= pad[:, None, None, None])
    elif mask_kind == "hole":
        # keys 64..127 false for every row (a whole tile mid-sweep) and one
        # row with no key at all
        mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device="cuda")
        mask[..., 64:128] = False
        mask[:, :, min(3, sq - 1)] = False
    return q, k, v, mask


def _no_key_rows(mask, causal, b, sq, skv, hq):
    """(B, Sq, Hq) bool: the query rows with no key to attend."""
    keep = torch.ones((b, 1, sq, skv), dtype=torch.bool, device="cuda")
    if causal:
        keep = keep & torch.tril(keep[0, 0])
    if mask is not None:
        keep = keep & mask
    return (~keep.any(-1))[:, 0, :, None].expand(b, sq, hq)


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,mask_kind,causal", [
    (2, 64, 64, 4, 2, 128, None, False),
    (2, 70, 70, 4, 2, 128, "prefill", False),       # ragged, GQA 2
    (1, 130, 200, 8, 2, 128, "padded", False),      # Sq != Skv, GQA 4
    (2, 100, 100, 4, 4, 128, None, True),           # causal tile skipping
    (1, 200, 200, 4, 1, 128, "prefill", True),
    (2, 17, 33, 2, 1, 64, "padded", False),         # D = 64, called directly
    (1, 2, 5, 2, 2, 128, None, False),
    # the edges of the tiles (query rows 128 / GP, GP = 1, 2, 4, 8 heads
    # packed a CTA; 64 keys): just under, at and just past a multiple
    (2, 63, 63, 8, 1, 128, "prefill", False),       # G = 8
    (2, 64, 64, 8, 4, 128, None, True),             # G = 2
    (1, 65, 129, 16, 2, 128, "padded", False),      # G = 8, stride-0 mask
    (2, 129, 129, 8, 8, 128, "prefill", True),      # G = 1
    (2, 127, 200, 8, 2, 128, "hole", False),        # a dead tile mid-sweep
    (2, 33, 191, 4, 1, 64, "static", False),        # D = 64, rows no key
    (1, 300, 391, 32, 8, 128, "static", False),     # the static prefill's
    (2, 96, 96, 12, 4, 128, "prefill", False),      # G = 3: one head a CTA
    # the families' group sizes (one head a CTA) and the text encoder's
    # causal, right-padded mask
    (2, 130, 130, 7, 1, 128, "prefill", False),     # G = 7
    (2, 150, 190, 28, 4, 128, "static", False),     # Qwen2.5's 28 / 4
    (2, 150, 190, 8, 8, 128, "static", False),      # OPT's MHA, G = 1
])
def test_flash_attention(b, sq, skv, hq, hkv, d, mask_kind, causal):
    g = _gen()
    q, k, v, mask = _flash_inputs(g, b, sq, skv, hq, hkv, d, mask_kind)
    fa.reset_launches()
    _check(lambda q, k, v: fa.flash_attention(q, k, v, mask, causal=causal),
           lambda q, k, v: fa.flash_attention_plain(q, k, v, mask,
                                                    causal=causal),
           (q, k, v))
    assert fa.launches["flash_attention"] == 1
    # the lse: fp32 in both, from the same bf16 values
    _, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                return_lse=True)
    _, ref = fa.flash_attention_plain(q.float(), k.float(), v.float(), mask,
                                      causal=causal, return_lse=True)
    assert lse.shape == (b, hq, sq)
    assert (lse - ref).abs().max().item() <= ATOL
    # a row with no valid key: out exactly 0, lse -1e30
    empty = _no_key_rows(mask, causal, b, sq, skv, hq)
    out = fa.flash_attention(q, k, v, mask, causal=causal)
    assert torch.all(out[empty] == 0)
    assert torch.all(lse.transpose(1, 2)[empty] == -1e30)


@pytest.mark.parametrize("kind", ["verify", "chunk", "prefix_merge"])
def test_flash_attention_at_the_serving_options_shapes(kind):
    """The engine options' masks (serve.engine): a speculative verify pass
    (Sq = 4 per-row lengths over 1024 slots), a chunk (queries at offsets
    inside the keys) and a prefix merge (Sq != Skv)."""
    from opus_pllm_tpu_torch.serve.engine import (admission_inputs,
                                                  chunk_inputs, verify_mask)
    g = _gen()
    if kind == "verify":
        lengths = torch.randint(64, 961, (17,), generator=g, device="cuda")
        b, sq, skv, mask = 17, 4, 1024, verify_mask(lengths, 4, 1024)
    elif kind == "chunk":
        off = torch.tensor([0, 256, 512, 700], device="cuda")
        n_valid = torch.tensor([256, 256, 100, 200], device="cuda")
        b, sq, skv = 4, 256, 1024
        mask = chunk_inputs(n_valid, off, sq, skv)[1]
    else:
        n_valid = torch.randint(1, 129, (8,), generator=g, device="cuda")
        b, sq, skv, mask = 8, 128, 192, admission_inputs(n_valid, 128, 64)[1]
    assert bool(mask.any(-1).all())
    q, k, v = (_rnd(g, b, sq, 32, 128), _rnd(g, b, skv, 8, 128),
               _rnd(g, b, skv, 8, 128))
    _check(lambda q, k, v: fa.flash_attention(q, k, v, mask),
           lambda q, k, v: fa.flash_attention_plain(q, k, v, mask),
           (q, k, v))


def test_engine_options_on_the_card():
    """A tiny bf16 decoder (D = 128, so flash takes every prefill, chunk
    and verify pass) behind the engine with a bank, speculative ticks,
    a pinned prefix and chunked prefill: every request is answered and
    the launch counts are exact."""
    from opus_pllm_tpu_torch.core.config import DecoderConfig, LoRAConfig
    from opus_pllm_tpu_torch.lora import lora
    from opus_pllm_tpu_torch.serve.engine import ServeRequest, ServingEngine
    cfg = DecoderConfig(family="llama", vocab_size=256, hidden_size=256,
                        intermediate_size=512, num_layers=3, num_heads=4,
                        num_kv_heads=2, head_dim=128, dtype="bfloat16")
    g = _gen()
    params = decoder.init(cfg, generator=g, device="cuda")
    lc = LoRAConfig(rank=4, alpha=8.0)
    bank = {"a": lora.fold_scaling(lora.init(cfg, lc, generator=g),
                                   lora.scaling(lc))}
    eng = ServingEngine(params, cfg, max_slots=4, max_len=128,
                        prefill_buckets=(16,), chunk_prefill=16,
                        draft_layers=1, spec_k=3, spec_adaptive=False,
                        lora_bank=bank, steps_per_tick=2)
    eng.register_prefix("p", token_ids=np.arange(5, 12))
    fa.reset_launches()
    emb = lambda n: _rnd(g, n, 256, scale=0.3)
    done = eng.run([ServeRequest(0, embeds=emb(9), max_new_tokens=7,
                                 adapter_id="a"),
                    ServeRequest(1, embeds=emb(40), max_new_tokens=5),
                    ServeRequest(2, embeds=emb(4), max_new_tokens=6,
                                 prefix_id="p")])
    assert [len(done[i].tokens) for i in range(3)] == [7, 5, 6]
    iters = eng._tick * eng.steps_per_tick
    assert fa.launches["flash_attention"] == 3 * (
        eng.counters["prefills"] + iters)


def test_flash_attention_strided_kv_and_layer_dispatch():
    """K/V as the transposed view a dequantized cache gives, and
    `layers.attention(impl="auto")` taking the kernel for a prefill but not
    for a one-token step."""
    g = _gen()
    q, _, _, mask = _flash_inputs(g, 2, 40, 40, 4, 2, 128, "prefill")
    k = _rnd(g, 2, 2, 40, 128).transpose(1, 2)        # (B, S, H, D) view
    v = _rnd(g, 2, 2, 40, 128).transpose(1, 2)
    fa.reset_launches()
    _check(lambda q, k, v: layers.attention(q, k, v, mask),
           lambda q, k, v: fa.flash_attention_plain(q, k, v, mask), (q, k, v))
    assert fa.launches["flash_attention"] == 1
    layers.attention(q[:, :1], k, v, mask[:, :, :1])
    assert fa.launches["flash_attention"] == 1
    # both backward kernels read the same view through its strides
    dout = _rnd(g, 2, 40, 4, 128)
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True)
    delta = fab._delta(out, dout)
    plain = lambda q, k, v, dout: fab.flash_attention_bwd_plain(
        q, k, v, mask, out, lse, dout)
    _check(lambda q, k, v, dout: fab.flash_attention_bwd_dq(
        q, k, v, mask, lse, delta, dout),
        lambda *a: plain(*a)[0], (q, k, v, dout), scaled=True)
    _check(lambda q, k, v, dout: fab.flash_attention_bwd_dkv(
        q, k, v, mask, lse, delta, dout),
        lambda *a: torch.stack(plain(*a)[1:]), (q, k, v, dout), scaled=True)


@pytest.mark.parametrize("m,k,n", [(256, 512, 256), (300, 48, 130),
                                   (257, 4096, 1000), (2616, 4096, 1024)])
def test_int8_matmul(m, k, n):
    """Ragged M and N, K a multiple of 16 but not of 32, and the static
    prefill's M. N = 130 / 1000 are not 16-byte row strides: the
    dequantize route, with no launch."""
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((k, n), generator=g,
                                                   device="cuda"))
    x = _rnd(g, m, k)
    tma = n % 16 == 0
    assert quant.kernel_shape(x, n) == tma
    quant.reset_launches()
    if tma:
        _check(lambda x: quant.int8_matmul(x, wq, s),
               lambda x: quant.int8_matmul_plain(x, wq, s), (x,))
    else:
        _check_dequant_route(quant.int8_matmul(x, wq, s), x,
                             (wq.float() * s.bfloat16().float()).bfloat16())
    assert quant.launches == {"int8_matmul": int(tma)}


@pytest.mark.parametrize("m,k,n", [(256, 4112, 1040), (257, 4112, 1040),
                                   (300, 4112, 1040), (8304, 4112, 1040),
                                   (256, 4096, 128256)])
def test_int8_matmul_tma(m, k, n):
    """The TMA + wgmma kernel: ragged M (one row past a tile, 8304 = 64.875
    tiles), N a multiple of 16 but not of the 128-column tile, K a multiple
    of 16 but not of the 64-row step, and the full vocab head; three
    launches, and two calls agree bit for bit."""
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((k, n), generator=g,
                                                   device="cuda"))
    x = _rnd(g, m, k)
    quant.reset_launches()
    _check(lambda x: quant.int8_matmul(x, wq, s),
           lambda x: quant.int8_matmul_plain(x, wq, s), (x,))
    assert torch.equal(quant.int8_matmul(x, wq, s),
                       quant.int8_matmul(x, wq, s))
    assert quant.launches == {"int8_matmul": 3}


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 1024), (4096, 14336),
                                 (14336, 4096)])
def test_int8_matmul_llama_shapes(k, n):
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((k, n), generator=g,
                                                   device="cuda"))
    _check(lambda x: quant.int8_matmul(x, wq, s),
           lambda x: quant.int8_matmul_plain(x, wq, s), (_rnd(g, 320, k),))


def test_int8_dispatch_routes():
    """Below M = 256 (decode, the head) and for fp32 x the wrapper takes the
    dequantize route; on the kernel's shapes it launches."""
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((512, 256), generator=g,
                                                   device="cuda"))
    quant.reset_launches()
    x = _rnd(g, 17, 512)
    torch.testing.assert_close(quant.int8_matmul(x, wq, s),
                               quant.dequant_matmul(x, wq, s))
    quant.int8_matmul(_rnd(g, 256, 512).float(), wq, s)
    assert quant.launches["int8_matmul"] == 0
    quant.qdense({"kernel_q": wq, "scale": s}, _rnd(g, 2, 128, 512))
    assert quant.launches["int8_matmul"] == 1


def test_new_wrappers_raise_instead_of_falling_back():
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((512, 256), generator=g,
                                                   device="cuda"))
    x = _rnd(g, 256, 512)
    with pytest.raises(ValueError):            # weights not contiguous
        quant.int8_matmul(x, wq.t().contiguous().t(), s)
    with pytest.raises(TypeError):             # fp16 scale
        quant.int8_matmul(x, wq, s.half())
    with pytest.raises(ValueError):            # weights on the CPU
        quant.int8_matmul(x, wq.cpu(), s)
    q = _rnd(g, 1, 8, 2, 128)
    with pytest.raises(ValueError):            # fp32 q
        fa.flash_attention(q.float(), q.float(), q.float())
    q96 = _rnd(g, 1, 8, 2, 96)
    with pytest.raises(ValueError):            # no D = 96 instance
        fa.flash_attention(q96, q96, q96)
    with pytest.raises(ValueError):            # per-head mask
        fa.flash_attention(q, q, q, torch.ones((1, 2, 8, 8), dtype=torch.bool,
                                               device="cuda"))


# ---------------------------------------------------------------------------
# Training: the flash backward kernels, the int4 v1 matmul, the autograd
# Functions and one tiny train step
# ---------------------------------------------------------------------------

def _train_mask(g, b, s):
    """opus.forward's training mask: right-padded rows, causal."""
    n = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
    n[0] = s
    return layers.causal_mask(torch.arange(s, device="cuda")[None]
                              < n[:, None])


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,mask_kind,causal", [
    (2, 70, 70, 4, 2, 128, "train", False),         # ragged, GQA 2
    (1, 130, 200, 8, 2, 128, "padded", False),      # Sq != Skv, GQA 4
    (2, 100, 100, 4, 4, 128, None, True),           # causal tile skipping
    (1, 200, 200, 8, 2, 128, "prefill", True),
    (2, 17, 33, 2, 1, 64, "padded", False),         # D = 64
    (1, 2, 5, 2, 2, 128, None, False),
    # the edges of the tiles (dq as the forward; dk/dv 64 keys a CTA over
    # 64-row query tiles), G = 1, 2, 4, 8, rows with no valid key
    (2, 63, 63, 8, 1, 128, "train", False),         # G = 8
    (2, 64, 65, 8, 4, 128, None, True),             # G = 2
    (1, 65, 129, 16, 2, 128, "padded", False),      # stride-0 mask
    (2, 129, 127, 8, 8, 128, "prefill", True),      # G = 1
    (2, 127, 200, 8, 2, 128, "hole", False),        # a dead tile mid-sweep
    (2, 33, 191, 4, 1, 64, "static", False),        # D = 64, rows no key
    (2, 96, 96, 12, 4, 128, "train", False),        # G = 3
])
def test_flash_attention_bwd(b, sq, skv, hq, hkv, d, mask_kind, causal):
    """dq and stacked dk/dv against the plain backward, from the forward
    kernel's out and lse; gradients exceed 1, so ATOL scales with them."""
    g = _gen()
    q, k, v, mask = _flash_inputs(g, b, sq, skv, hq, hkv, d, mask_kind)
    if mask_kind == "train":
        mask = _train_mask(g, b, sq)
    dout = _rnd(g, b, sq, hq, d)
    out, lse = fa.flash_attention(q, k, v, mask, causal=causal,
                                  return_lse=True)
    delta = fab._delta(out, dout)
    plain = lambda q, k, v, dout: fab.flash_attention_bwd_plain(
        q, k, v, mask, out, lse, dout, causal=causal)
    fab.reset_launches()
    _check(lambda q, k, v, dout: fab.flash_attention_bwd_dq(
        q, k, v, mask, lse, delta, dout, causal=causal),
        lambda *a: plain(*a)[0], (q, k, v, dout), scaled=True)
    _check(lambda q, k, v, dout: fab.flash_attention_bwd_dkv(
        q, k, v, mask, lse, delta, dout, causal=causal),
        lambda *a: torch.stack(plain(*a)[1:]), (q, k, v, dout), scaled=True)
    assert fab.launches == {"flash_attention_bwd_dq": 1,
                            "flash_attention_bwd_dkv": 1}


def test_flash_attention_bwd_fully_masked_row_is_zero():
    """A query row with no valid key gets exactly zero dq and adds nothing
    to dk / dv (the TPU kernel's convention)."""
    g = _gen()
    q, k, v, _ = _flash_inputs(g, 1, 40, 40, 4, 2, 128, None)
    mask = torch.ones((1, 1, 40, 40), dtype=torch.bool, device="cuda")
    mask[0, 0, 7] = False
    dout = _rnd(g, 1, 40, 4, 128)
    out, lse = fa.flash_attention(q, k, v, mask, return_lse=True)
    dq, dk, dv = fab.flash_attention_bwd(q, k, v, mask, out, lse, dout)
    assert torch.all(dq[0, 7] == 0)
    dout2 = dout.clone()
    dout2[0, 7] = 0
    _, dk2, dv2 = fab.flash_attention_bwd(q, k, v, mask, out, lse, dout2)
    torch.testing.assert_close(dk, dk2, rtol=0, atol=0)
    torch.testing.assert_close(dv, dv2, rtol=0, atol=0)


def _grads_check(fn, leaves_bf, cot):
    """Gradients of sum(fn(*leaves) * cot): bf16 leaves through `fn` (the
    kernels) against fp32 leaves through `fn_plain`, bounded as _check by
    the bf16 plain gradients' error."""
    def grads(f, dtype):
        ls = [t.detach().to(dtype).requires_grad_(True) for t in leaves_bf]
        return [t.float() for t in torch.autograd.grad(
            (f(*ls).float() * cot).sum(), ls)]
    return grads(fn[0], torch.bfloat16), grads(fn[1], torch.float32), \
        grads(fn[1], torch.bfloat16)


@pytest.mark.parametrize("mask_kind,causal", [("train", False),
                                              (None, True)])
def test_flash_function_grads(mask_kind, causal):
    """flash_attention with q, k, v requiring grad goes through its
    Function (forward kernel with lse, both backward kernels); its
    gradients against autograd through the plain forward."""
    g = _gen()
    q, k, v, _ = _flash_inputs(g, 2, 90, 90, 8, 2, 128, None)
    mask = _train_mask(g, 2, 90) if mask_kind else None
    cot = torch.randn((2, 90, 8, 128), generator=g, device="cuda")
    fa.reset_launches()
    fab.reset_launches()
    got, ref, plain_bf = _grads_check(
        (lambda q, k, v: fa.flash_attention(q, k, v, mask, causal=causal),
         lambda q, k, v: fa.flash_attention_plain(q, k, v, mask,
                                                  causal=causal)),
        (q, k, v), cot)
    assert fa.launches["flash_attention"] == 1
    assert fab.launches == {"flash_attention_bwd_dq": 1,
                            "flash_attention_bwd_dkv": 1}
    for a, r, p in zip(got, ref, plain_bf):
        bound = 2 * (p - r).abs().max().item() + ATOL * max(
            1.0, r.abs().max().item())
        assert (a - r).abs().max().item() <= bound


@pytest.mark.parametrize("m", [1, 70, 300])
@pytest.mark.parametrize("k,n", [(256, 128), (768, 130), (4096, 1000)])
def test_int4_matmul_v1(m, k, n):
    """Ragged M and N, K one or several 256-row blocks; fp32 x stays fp32
    and differs by summation order. N = 130 / 1000 are not 16-byte row
    strides: the dequantize route, with no launch."""
    g = _gen()
    q, s = quant4.quantize_grouped(torch.randn((k, n), generator=g,
                                               device="cuda"))
    packed = quant4.pack_int4(q)
    x = _rnd(g, m, k)
    w = _int4_bf16_weights(q, s)
    tma = n % 16 == 0
    assert quant4.kernel_shape(x, packed) == tma
    quant4.reset_launches()
    if tma:
        _check(lambda x: quant4.int4_matmul(x, packed, s),
               lambda x: quant4.int4_matmul_plain(x, packed, s), (x,))
    else:
        _check_dequant_route(quant4.int4_matmul(x, packed, s), x, w)
    assert quant4.launches == {"int4_matmul": 0, "int4_matmul_v1": int(tma)}
    out = quant4.int4_matmul(x.float(), packed, s)
    if tma:
        ref = quant4.int4_matmul_plain(x.float(), packed, s)
        assert out.dtype == torch.float32
        assert ((out - ref).abs().max().item()
                <= 1e-5 * ref.abs().max().item())
    else:
        _check_dequant_route(out, x.float(), w)


@pytest.mark.parametrize("m,k,n", [
    *((m, k, 1040) for m in (256, 257, 300, 8304) for k in (256, 768, 4096)),
    (300, 4096, 128256)])
def test_int4_matmul_v1_tma(m, k, n):
    """The TMA + wgmma kernel: ragged M, N a multiple of 16 but not of the
    128-column tile, one to sixteen 256-row blocks, and the full vocab
    head; fp32 x stays fp32 within 1e-5 of the plain version (so the fp32
    group scales were not rounded); four launches, and two calls agree bit
    for bit."""
    g = _gen()
    q, s = quant4.quantize_grouped(torch.randn((k, n), generator=g,
                                               device="cuda"))
    packed = quant4.pack_int4(q)
    del q
    x = _rnd(g, m, k)
    quant4.reset_launches()
    _check(lambda x: quant4.int4_matmul(x, packed, s),
           lambda x: quant4.int4_matmul_plain(x, packed, s), (x,))
    assert torch.equal(quant4.int4_matmul(x, packed, s),
                       quant4.int4_matmul(x, packed, s))
    out = quant4.int4_matmul(x.float(), packed, s)
    ref = quant4.int4_matmul_plain(x.float(), packed, s)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
    assert quant4.launches == {"int4_matmul": 0, "int4_matmul_v1": 4}


@pytest.mark.parametrize("kind", ["int8", "int4-v1"])
def test_quantized_function_dx(kind):
    """The int8 and int4 Functions on the card: the forward through the
    kernel, dx as the JAX custom VJPs compute it (int8: (g * scale) @ wq^T
    in fp32; int4: g @ W^T with W dequantized to bf16)."""
    g = _gen()
    m, k, n = 300, 512, 256
    w = torch.randn((k, n), generator=g, device="cuda")
    x = _rnd(g, m, k).requires_grad_(True)
    cot = _rnd(g, m, n)
    quant.reset_launches()
    quant4.reset_launches()
    if kind == "int8":
        wq, s = quant.quantize_per_channel(w)
        y = quant.int8_matmul(x, wq, s)
        ref = ((cot.float() * s) @ wq.float().t()).bfloat16()
        launched = quant.launches
    else:
        q, s = quant4.quantize_grouped(w)
        packed = quant4.pack_int4(q)
        y = quant4.int4_matmul(x, packed, s)
        ref = (cot.float() @ quant4.dequantize_bf16(packed, s).float().t()
               ).bfloat16()
        launched = quant4.launches
    assert y.grad_fn is not None and sum(launched.values()) == 1
    dx, = torch.autograd.grad(y, x, cot)
    assert dx.dtype == torch.bfloat16
    # fp32 summation order, then one bf16 rounding
    torch.testing.assert_close(dx.float(), ref.float(), rtol=2 ** -7,
                               atol=1e-3 * ref.float().abs().max().item())


def test_head_logits_backward():
    """head_logits' fp32 logits from bf16 hidden states carry a gradient:
    dx = (g rounded to bf16) @ W^T with fp32 accumulation, rounded once."""
    g = _gen()
    cfg = DecoderConfig(vocab_size=1000, hidden_size=256, num_layers=1,
                        num_heads=2, num_kv_heads=1, head_dim=128,
                        intermediate_size=512, dtype="bfloat16")
    params = {"lm_head": {"kernel": _rnd(g, 256, 1000, scale=0.05)}}
    x = _rnd(g, 3, 7, 256).requires_grad_(True)
    y = decoder.head_logits(params, cfg, x)
    assert y.dtype == torch.float32 and y.grad_fn is not None
    torch.testing.assert_close(y, x.float() @ params["lm_head"][
        "kernel"].float(), rtol=1e-5, atol=1e-5)
    cot = torch.randn(y.shape, generator=g, device="cuda")
    dx, = torch.autograd.grad(y, x, cot)
    ref = cot.bfloat16().float() @ params["lm_head"]["kernel"].float().t()
    torch.testing.assert_close(dx.float(), ref.bfloat16().float(),
                               rtol=2 ** -7, atol=1e-3)


def test_fused_encoder_wrappers_raise_under_grad():
    """ESM2 is frozen: a kernel given an input that requires grad raises
    rather than return an output cut from the graph; under no_grad (as
    training runs the encoder) it launches."""
    g = _gen()
    e = 256
    cos, sin = rope_cos_sin(torch.arange(8, device="cuda"), 64)
    ln = torch.stack([torch.ones(e, device="cuda"),
                      torch.zeros(e, device="cuda")]).to(torch.bfloat16)
    x = _rnd(g, 1, 8, e)
    args = (_rnd(g, 3, e, e, scale=e ** -0.5), _rnd(g, 3, e, scale=0.1), ln)
    with pytest.raises(RuntimeError, match="no_grad"):
        fe.ln_qkv_rope(x.clone().requires_grad_(True), *args, cos, sin)
    with pytest.raises(RuntimeError, match="no_grad"):
        fe.encoder_attention(_rnd(g, 3, 1, 4, 8, 64).requires_grad_(True))
    with torch.no_grad():
        fe.ln_qkv_rope(x.clone().requires_grad_(True), *args, cos, sin)


def _tiny_train_cfg():
    """ESM2 with d=64 heads (the encoder kernels), an LLM with D=128
    (flash) whose projections all have K % 256 == 0 (int4 v1)."""
    esm = ESM2Config(num_layers=2, embed_dim=256, num_heads=4,
                     dtype="bfloat16")
    llm = DecoderConfig(vocab_size=260, hidden_size=256,
                        intermediate_size=512, num_layers=2, num_heads=2,
                        num_kv_heads=1, head_dim=128,
                        max_position_embeddings=512, dtype="bfloat16")
    return OpusConfig(esm=esm, cstp=CSTPConfig(protein_dim=256, text_dim=256,
                                               proj_dim=256),
                      switch=SwitchProjectorConfig(input_dim=256,
                                                   llm_hidden_size=256),
                      llm=llm, max_prompt_len=64)


@pytest.mark.parametrize("base", ["bf16", "int4-v1"])
def test_train_step_launch_counts(base):
    """One `fit` step of LoRA training: per layer the flash forward twice
    (the remat recompute), each backward kernel once, every encoder kernel
    once per ESM2 layer, and with the v1 base 2 x 7 v1 products per layer
    (the head's N = 260 is not a 16-byte row stride: it takes the
    dequantize route, with no launch); the loss is finite and LoRA B
    moved."""
    cfg = _tiny_train_cfg()
    params = opus.init(cfg, generator=_gen(), device="cuda")
    if base == "int4-v1":
        params["llm"] = quant4.quantize_decoder4(params["llm"], layout="v1")
    rng = torch.Generator().manual_seed(1)
    b, l = 4, 64
    ids = torch.randint(4, 260, (b, l), generator=rng, dtype=torch.int32)
    ids[:, 1] = -200                                  # the <seq> sentinel
    attn = torch.ones((b, l), dtype=torch.bool)
    attn[1:, 50:] = False
    labels = torch.where(attn, ids, torch.full_like(ids, -100))
    labels[:, :8] = -100
    esm_toks = torch.randint(4, 24, (b, 1, 30), generator=rng,
                             dtype=torch.int32)
    esm_toks[..., 0], esm_toks[..., -1] = 0, 2
    batch = {"input_ids": ids.numpy(), "attn_mask": attn.numpy(),
             "labels": labels.numpy(), "esm_tokens": esm_toks.numpy()}
    tcfg = TrainConfig(learning_rate=1e-3, weight_decay=0.0, log_every=1)
    lcfg = LoRAConfig(rank=4, alpha=8.0)
    state, tx = mmt.create_state(cfg, tcfg, params, generator=_gen(),
                                 train_switch=False, lora_cfg=lcfg,
                                 device="cuda")
    b0 = [ab["B"].detach().clone() for lp in state.trainable["lora"]
          ["layers"] for ab in lp.values()]
    for mod in (fe, fa, fab, quant4, quant, da):
        mod.reset_launches()
    logs = []
    mmt.fit(state, tx, cfg, tcfg, params, [batch], lora_cfg=lcfg,
            log_fn=logs.append, device="cuda")
    torch.cuda.synchronize()
    nl = cfg.llm.num_layers
    assert fa.launches["flash_attention"] == 2 * nl
    assert fab.launches == {"flash_attention_bwd_dq": nl,
                            "flash_attention_bwd_dkv": nl}
    assert fe.launches == {k: cfg.esm.num_layers for k in fe.launches}
    v1 = base == "int4-v1"
    assert quant4.launches == {"int4_matmul": 0,
                               "int4_matmul_v1": 2 * 7 * nl if v1 else 0}
    assert set(quant.launches.values()) == {0}
    assert sum(da.launches.values()) == 0
    loss = float(logs[0].split("loss=")[1])
    assert torch.isfinite(torch.tensor(loss))
    b1 = [ab["B"] for lp in state.trainable["lora"]["layers"]
          for ab in lp.values()]
    assert all(not torch.equal(x, y) for x, y in zip(b0, b1))


@pytest.mark.parametrize("family", ["llama", "qwen2", "opt"])
def test_stage_a_precompute_and_cstp(family, tmp_path):
    """precompute_cstp_pairs at tiny widths (ESM2 with d = 64 heads, a text
    LM with D = 128 heads of the family): the launch counts exactly (each
    encoder kernel once per ESM2 layer and batch, flash once per decoder
    layer and text batch), one text batch's embeddings through the kernels
    within the bound of the plain path in fp32, then two CSTP steps with
    finite losses."""
    import pickle
    from opus_pllm_tpu_torch.data import precompute
    from opus_pllm_tpu_torch.data.datasets import UniProtQAVecDataset
    from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
    from opus_pllm_tpu_torch.models import text_encoder
    from opus_pllm_tpu_torch.train import cstp_trainer as ct

    ecfg = ESM2Config(num_layers=2, embed_dim=256, num_heads=4,
                      dtype="bfloat16")
    lcfg = dataclasses.replace(
        DecoderConfig.tiny(family), vocab_size=260,   # the byte tokenizer's
        hidden_size=256, intermediate_size=512,
        num_heads=4, num_kv_heads=4 if family == "opt" else 2, head_dim=128,
        dtype="bfloat16")
    g = _gen()
    esm = esm2.init(ecfg, generator=g, device="cuda")
    llm = decoder.init(lcfg, generator=g, device="cuda")
    rng = torch.Generator().manual_seed(2)
    aa = "ACDEFGHIKLMNPQRSTVWY"
    recs = {f"P{i}": {"Sequence": "".join(aa[j] for j in torch.randint(
        0, 20, (int(torch.randint(20, 90, (1,), generator=rng)),),
        generator=rng).tolist()), "Name": [f"p{i}"],
        "Similarity": "x" * (30 * i)} for i in range(6)}
    up, out = tmp_path / "u.pkl", tmp_path / "p.pkl"
    up.write_bytes(pickle.dumps(recs))
    for mod in (fe, fa, fab, quant4, quant, da):
        mod.reset_launches()
    stats = {}
    n = precompute.precompute_cstp_pairs(esm, ecfg, llm, lcfg,
                                         ByteTokenizer(), str(up), str(out),
                                         batch_size=4, stats=stats)
    torch.cuda.synchronize()
    # batches of 4: the unique sequences for ESM2, the records for text
    esm_batches = -(-len({r["Sequence"] for r in recs.values()}) // 4)
    text_batches = -(-len(recs) // 4)
    assert n == 6 and set(stats) == {"esm_seconds", "text_seconds"}
    assert fe.launches == {k: ecfg.num_layers * esm_batches
                           for k in fe.launches}
    assert fa.launches["flash_attention"] == lcfg.num_layers * text_batches
    assert sum(fab.launches.values()) + sum(da.launches.values()) == 0
    assert sum(quant4.launches.values()) + sum(quant.launches.values()) == 0
    se, te = UniProtQAVecDataset(str(out)).arrays()
    assert se.shape == (6, 256) and te.shape == (6, 256)
    assert np.isfinite(se).all() and np.isfinite(te).all()

    ids = torch.randint(4, 260, (3, 128), generator=rng, dtype=torch.int32)
    mask = torch.arange(128)[None] < torch.tensor([[128], [70], [5]])
    ids, mask = ids.cuda(), mask.cuda()
    embed = lambda impl, p, c: text_encoder.text_embeddings(
        p, c, ids, mask, impl=impl)
    got, plain = embed("auto", llm, lcfg), embed("torch", llm, lcfg)
    f32 = {k: (v if k in ("layers", "lm_head") else
               {kk: vv.float() for kk, vv in v.items()})
           for k, v in llm.items()}
    ref = embed("torch", f32, dataclasses.replace(lcfg, dtype="float32"))
    err = (got - ref).abs().max().item()
    assert err <= 2 * (plain - ref).abs().max().item() + ATOL, err

    ccfg = CSTPConfig(protein_dim=256, text_dim=256, proj_dim=128,
                      warmup_info_nce_steps=-1)
    tcfg = TrainConfig(batch_size=6, log_every=0)
    state, tx = ct.create_state(ccfg, tcfg, generator=_gen(), device="cuda")
    seen = []
    ct.fit(state, tx, ccfg, tcfg, [(se, te)] * 2, device="cuda",
           metrics_fn=lambda i, m: seen.append(float(m["loss"])))
    assert len(seen) == 2 and all(np.isfinite(seen))


# --- beam search, the static draft and fused projections -------------------

@pytest.mark.parametrize("n", [1024, 6144, 28672])
def test_int4_matmul_at_beam_rows_and_fused_widths(n):
    """int4 v2 at M = B * K = 32 (batch 8, 4 beams: the two-row-tile plan)
    and at the fused widths N = 6144 ([q|k|v] of Llama-3-8B) and 28672
    ([gate|up]); one launch a call."""
    g = _gen()
    q, s = quant4.quantize_grouped(
        torch.randn((4096, n), generator=g, device="cuda"))
    packed = quant4.pack_int4_v2(q)
    del q
    for m in (8, 32):
        quant4.reset_launches()
        _check(lambda x: quant4.int4_matmul(x, packed, s),
               lambda x: quant4.int4_matmul_plain(x, packed, s),
               (_rnd(g, m, 4096),))
        assert quant4.launches["int4_matmul"] == 1


@pytest.mark.parametrize("n", [6144, 28672])
def test_int8_matmul_at_the_fused_widths(n):
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((4096, n), generator=g,
                                                   device="cuda"))
    quant.reset_launches()
    _check(lambda x: quant.int8_matmul(x, wq, s),
           lambda x: quant.int8_matmul_plain(x, wq, s), (_rnd(g, 320, 4096),))
    assert quant.launches == {"int8_matmul": 1}


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decode_attention_after_reorder_cache(kind):
    """Beam search's cache: 8 rows tiled to 32 and permuted by
    `reorder_cache`; each scale row moves with its K/V row, so the kernel
    over the reordered cache equals the plain version over it and, row by
    row, the kernel over the parent rows."""
    g = _gen()
    cfg = DecoderConfig(num_layers=1)
    cache = decoder.init_cache(cfg, 8, 391, device="cuda", quantize=kind)
    kv = [torch.randn((8, 391, 8, 128), generator=g, device="cuda")
          for _ in range(2)]
    decoder._write_cache(cache["layers"][0], *kv, 0)
    cache["mask"][:] = _decode_mask(g, 8, 391, "left")
    tiled = decoder.tile_cache(cache, 4)
    rows = torch.randint(0, 32, (32,), generator=g, device="cuda")
    moved = decoder.reorder_cache(tiled, rows)
    lk, lv = moved["layers"][0]["k"], moved["layers"][0]["v"]
    mask4 = moved["mask"][:, None, None, :]
    q = _rnd(g, 32, 1, 32, 128, scale=0.5)
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    _check(lambda q: fn(q, lk, lv, mask4),
           lambda q: da.decode_attention_plain(q, lk, lv, mask4), (q,))
    parent = (rows // 4).long()
    base = {n: {k: v[parent] for k, v in cache["layers"][0][n].items()}
            for n in ("k", "v")}
    assert torch.equal(fn(q, lk, lv, mask4),
                       fn(q, base["k"], base["v"],
                          cache["mask"][parent][:, None, None, :]))


def test_flash_attention_at_the_static_verify_mask():
    """The static speculative verify pass: Sq = n_draft = 4 queries over
    cap = l + max_new + K slots under `_decode_mask`'s batch-uniform
    index with the causal term of speculative.py:253-254, GQA 4."""
    from opus_pllm_tpu_torch.infer.speculative import _decode_mask as dm
    g = _gen()
    b, l, k = 8, 327, 4
    cap = l + 16 + k
    prompt = _decode_mask(g, b, l, "left")
    prompt[:, -1] = True
    idx = l + 5
    cols = torch.arange(cap, device="cuda")[None, None, None, :]
    mask = dm(prompt, cap, idx + k) & (
        cols <= idx + torch.arange(k, device="cuda")[None, None, :, None])
    q, kk, v = (_rnd(g, b, k, 32, 128), _rnd(g, b, cap, 8, 128),
                _rnd(g, b, cap, 8, 128))
    fa.reset_launches()
    _check(lambda q, kk, v: fa.flash_attention(q, kk, v, mask),
           lambda q, kk, v: fa.flash_attention_plain(q, kk, v, mask),
           (q, kk, v))
    assert fa.launches["flash_attention"] == 1


def test_beam_and_speculative_decode_on_the_card():
    """A 2-layer, 4096-wide llama, int4 and fused: beam search (K = 4,
    int4 cache) and the static draft (int8 cache) run through the kernels;
    K = 1 is greedy's tokens, and each speculative token is within 2% of
    the largest logit of a teacher-forced pass over the emitted sequence
    (the verify pass and the one-token steps take different kernels, so
    a near-tie may break either way in bf16)."""
    from opus_pllm_tpu_torch.infer import engine, speculative
    from opus_pllm_tpu_torch.kernels import quant4 as q4
    cfg = dataclasses.replace(DecoderConfig(num_layers=2), vocab_size=4096)
    llm = decoder.init(cfg, generator=_gen(), device="cuda")
    llm = decoder.fuse_projections(q4.quantize_decoder4(llm), cfg)
    g = _gen()
    x = _rnd(g, 8, 64, 4096, scale=0.5)
    am = torch.ones((8, 64), dtype=torch.bool, device="cuda")
    am[:3, :10] = False
    pos = decoder.positions_from_mask(am)
    kw = dict(max_new_tokens=8, eos_token_id=-1)
    greedy = engine.generate(llm, cfg, x, am, pos, g, temperature=0.0, **kw)
    q4.reset_launches()
    da.reset_launches()
    one = engine.beam_generate(llm, cfg, x, am, pos, num_beams=1, **kw)
    assert torch.equal(one.tokens, greedy.tokens)
    four = engine.beam_generate(llm, cfg, x, am, pos, num_beams=4,
                                quantize_cache="int4", **kw)
    assert four.tokens.shape == (8, 8) and q4.launches["int4_matmul"] > 0
    assert da.launches["decode_attention_int4"] > 0
    dp, dc = speculative.draft_from_target(llm, cfg, 1)
    spec = speculative.speculative_generate(dp, llm, dc, cfg, x, x, am, pos,
                                            quantize_cache="int8", **kw)
    assert spec.tokens.shape == (8, 8)
    full = torch.cat([x, decoder.embed_tokens(llm, spec.tokens.long())],
                     dim=1)
    fam = torch.cat([am, torch.ones((8, 8), dtype=torch.bool,
                                    device="cuda")], dim=1)
    lg, _ = decoder.forward(llm, cfg, full, decoder.positions_from_mask(fam),
                            layers.causal_mask(fam))
    lg = lg[:, 63:71].float()
    picked = torch.gather(lg, 2, spec.tokens.long()[..., None])[..., 0]
    gap = (lg.amax(-1) - picked).max().item()
    assert gap <= 0.02 * lg.abs().max().item(), gap


# the tensor-parallel shard shapes of Llama-3-8B (parallel/partition.py):
# M ranks hold N / M of [q|k|v], [gate|up] and the head, K / M of o_proj
# and down_proj (every one a whole int4 v2 superblock count)
def _tp_shapes(m):
    return [(4096, 48 * 128 // m), (4096 // m, 4096),
            (4096, 2 * 14336 // m), (14336 // m, 4096),
            (4096, 128256 // m)]


@pytest.mark.parametrize("rows,m,k,n", [(8, 4, k, n) for k, n in
                                        _tp_shapes(4)]
                         + [(4, 2, k, n) for k, n in _tp_shapes(2)])
def test_int4_matmul_at_the_shard_shapes(rows, m, k, n):
    """The aligned tensor-core kernel (N % 4 == 0, K a whole number of
    superblocks) at each shard, one launch a call."""
    g = _gen()
    q, s = quant4.quantize_grouped(
        torch.randn((k, n), generator=g, device="cuda"))
    packed = quant4.pack_int4_v2(q)
    assert quant4.kernel_shape(torch.empty((rows, k), device="meta"), packed)
    quant4.reset_launches()
    _check(lambda x: quant4.int4_matmul(x, packed, s),
           lambda x: quant4.int4_matmul_plain(x, packed, s),
           (_rnd(g, rows, k),))
    assert quant4.launches["int4_matmul"] == 1


@pytest.mark.parametrize("k,n", _tp_shapes(4)[:4])
def test_int8_matmul_at_the_shard_shapes(k, n):
    """The engine prefill's int8 products over 4 ranks (M = 8 x 384)."""
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((k, n), generator=g,
                                                   device="cuda"))
    quant.reset_launches()
    _check(lambda x: quant.int8_matmul(x, wq, s),
           lambda x: quant.int8_matmul_plain(x, wq, s), (_rnd(g, 3072, k),))
    assert quant.launches["int8_matmul"] == 1


@pytest.mark.parametrize("hq,hkv", [(8, 2), (16, 4)])
def test_attention_kernels_at_the_shard_heads(hq, hkv):
    """flash_attention over a rank's 8 / 2 (4 ranks) or 16 / 4 (2 ranks)
    heads at the static prefill's mask, and both decode attentions over
    its KV heads."""
    g = _gen()
    q, k, v, mask = _flash_inputs(g, 8, 327, 391, hq, hkv, 128, "static")
    fa.reset_launches()
    _check(lambda q, k, v: fa.flash_attention(q, k, v, mask),
           lambda q, k, v: fa.flash_attention_plain(q, k, v, mask),
           (q, k, v))
    assert fa.launches["flash_attention"] == 1
    for kind in ("int8", "int4"):
        kl, vl, m4 = _cache(g, 17, hkv, 448, 128, kind)
        qd = _rnd(g, 17, 1, hq, 128, scale=0.5)
        fn = da.decode_attention_int4 if kind == "int4" else \
            da.decode_attention_int8
        da.reset_launches()
        _check(lambda q: fn(q, kl, vl, m4),
               lambda q: da.decode_attention_plain(q, kl, vl, m4), (qd,))
        assert da.launches[f"decode_attention_{kind}"] == 1


def _generate_seen(monkeypatch, args, **kw):
    """engine.generate on `args`, with the fp32 logits it hands its
    sampler at each step, the decode-attention launches it made and the
    growth of the decode counters."""
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.utils.observability import SPANS
    seen, sample = {}, engine.advance_sampling

    def spy(step, done, cur_logits, *a, **k):
        seen[step] = cur_logits.clone()
        return sample(step, done, cur_logits, *a, **k)

    monkeypatch.setattr(engine, "advance_sampling", spy)
    da.reset_launches()
    before = SPANS.counters()
    out = engine.generate(*args, **kw)
    after = SPANS.counters()
    monkeypatch.setattr(engine, "advance_sampling", sample)
    grew = {k: after.get(k, 0) - before.get(k, 0)
            for k in ("decode.steps", "decode.graph_steps")}
    return out, seen, dict(da.launches), grew


@pytest.mark.parametrize("during", [None, "copies", "profiler"])
@pytest.mark.parametrize("temperature", [0.0, 0.1])
@pytest.mark.parametrize("quantize", [False, "int8"])
def test_decode_graph_matches_the_eager_step(monkeypatch, quantize,
                                             temperature, during):
    """`generate` with its decode step captured and replayed against the
    same loop with the step run eagerly (`_graphable` patched false),
    each on its own cache: the same tokens and the same logits at every
    step, greedy and sampled from one generator seed, over a bf16 and an
    int8 cache (a decode-attention kernel inside the graph, its launch
    count the eager one); also while another thread copies to the card,
    as the runner's prefetch does, and while a profiler records."""
    import threading
    import time

    from opus_pllm_tpu_torch.infer import engine
    cfg = DecoderConfig(family="qwen2", vocab_size=1024, hidden_size=512,
                        intermediate_size=1024, num_layers=3, num_heads=4,
                        num_kv_heads=2, head_dim=128, attention_bias=True,
                        dtype="bfloat16")
    g = _gen()
    llm = decoder.fuse_projections(
        decoder.init(cfg, generator=g, device="cuda"), cfg)
    x = _rnd(g, 8, 24, 512, scale=0.5)
    am = torch.ones((8, 24), dtype=torch.bool, device="cuda")
    am[:3, :5] = False
    new = 12
    kw = dict(max_new_tokens=new, temperature=temperature, top_p=0.7,
              eos_token_id=-1, quantize_cache=quantize)
    args = lambda: (llm, cfg, x, am, decoder.positions_from_mask(am),
                    torch.Generator(device="cuda").manual_seed(3))
    stop, copies, overlapped = threading.Event(), [], []

    def copy():
        host = torch.randn(1 << 20)
        pinned = host.pin_memory()
        while not stop.is_set():
            copies.append(host.to("cuda").sum()
                          + pinned.to("cuda", non_blocking=True).sum())

    step_fn = engine.DecodeStep.forward

    def forward_beside_copies(self):
        # the capture stays open until the thread has copied once more
        if torch.cuda.is_current_stream_capturing():
            n, deadline = len(copies), time.monotonic() + 60
            while len(copies) == n and time.monotonic() < deadline:
                time.sleep(0.001)
            overlapped.append(len(copies) > n)
        return step_fn(self)

    t = threading.Thread(target=copy) if during == "copies" else None
    if t is not None:
        monkeypatch.setattr(engine.DecodeStep, "forward",
                            forward_beside_copies)
        t.start()
    try:
        if during == "profiler":
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]):
                graphed = _generate_seen(monkeypatch, args(), **kw)
        else:
            graphed = _generate_seen(monkeypatch, args(), **kw)
    finally:
        stop.set()
        if t is not None:
            t.join(timeout=60)
    assert t is None or not t.is_alive()
    assert overlapped == ([True] if during == "copies" else [])
    monkeypatch.setattr(engine.DecodeStep, "forward", step_fn)
    monkeypatch.setattr(engine, "_graphable", lambda *a: False)
    eager = _generate_seen(monkeypatch, args(), **kw)
    (g_out, g_seen, g_launches, g_grew), (e_out, e_seen, e_launches,
                                          e_grew) = graphed, eager
    assert g_out.steps == e_out.steps == new
    assert torch.equal(g_out.tokens, e_out.tokens)
    assert torch.equal(g_out.lengths, e_out.lengths)
    assert sorted(g_seen) == sorted(e_seen) == list(range(new))
    for step in range(new):
        assert torch.equal(g_seen[step], e_seen[step]), step
    assert g_grew == {"decode.steps": new, "decode.graph_steps": new - 1}
    assert e_grew == {"decode.steps": new, "decode.graph_steps": 0}
    assert g_launches == e_launches
    want = cfg.num_layers * new
    assert g_launches["decode_attention_int8"] == (want if quantize ==
                                                   "int8" else 0)
    assert g_launches["decode_attention_bf16"] == (0 if quantize else want)


# ---- the grouped expert GEMM and the deepseek_v2 decode graph ----

def _routed(g, counts, k):
    """Rows sorted by expert for `counts` (E,) and their int32 offsets."""
    counts = torch.as_tensor(counts, dtype=torch.int64)
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64),
                         counts.cumsum(0)]).to(torch.int32).cuda()
    return _rnd(g, int(counts.sum()), k), offsets


@pytest.mark.parametrize("regime", ["decode", "prefill"])
@pytest.mark.parametrize("swiglu", [True, False])
def test_moe_grouped_gemm(regime, swiglu):
    """The grouped GEMM against its plain version at DeepSeek-V2-Lite's
    widths (gate|up 2048 -> 2 x 1408 with the SiLU-mul epilogue, down 1408
    -> 2048): the decode step's 768 pairs and the cell's prefill of 41,856
    rows x 6 = 251,136 pairs over 64 experts, three of them given no rows
    (at decode also 1- and 200-row experts)."""
    from opus_pllm_tpu_torch.kernels import moe
    g = _gen()
    e = 64
    k, n = (2048, 2 * 1408) if swiglu else (1408, 2048)
    total = 768 if regime == "decode" else 41856 * 6
    rng = np.random.default_rng(5)
    share = rng.dirichlet(np.ones(e) * 4)
    share[[3, 5, 6, 17, 40]] = 0.0
    fixed = {5: 1, 6: 200} if regime == "decode" else {}
    rest = total - sum(fixed.values())
    counts = np.floor(share / share.sum() * rest).astype(np.int64)
    counts[int(np.argmax(counts))] += rest - counts.sum()
    for i, c in fixed.items():
        counts[i] = c
    assert counts.sum() == total and counts.min() >= 0
    x, offsets = _routed(g, counts, k)
    w = _rnd(g, e, k, n, scale=k ** -0.5)
    moe.reset_launches()
    _check(lambda x_, w_: moe.grouped_gemm(x_, w_, offsets, swiglu=swiglu),
           lambda x_, w_: moe.grouped_gemm_plain(x_, w_, offsets,
                                                 swiglu=swiglu), (x, w))
    assert moe.launches["moe_grouped_gemm"] == 1
    again = moe.grouped_gemm(x, w, offsets, swiglu=swiglu)
    assert torch.equal(again, moe.grouped_gemm(x, w, offsets,
                                               swiglu=swiglu))


def _tiny_deepseek_card():
    return dataclasses.replace(
        DecoderConfig.tiny_deepseek_v2(), vocab_size=1024, hidden_size=512,
        intermediate_size=1024, num_heads=4, num_kv_heads=4, head_dim=192,
        kv_lora_rank=128, qk_nope_head_dim=128, qk_rope_head_dim=64,
        v_head_dim=128, moe_intermediate_size=128, dtype="bfloat16")


@pytest.mark.parametrize("temperature", [0.0, 0.1])
def test_deepseek_decode_graph_matches_the_eager_step(monkeypatch,
                                                      temperature):
    """deepseek_v2 (MLA over the latent cache, 8 routed experts through
    the grouped GEMM) with its decode step captured and replayed against
    the same loop run eagerly: the same tokens, bit-equal logits at every
    step, the grouped GEMM's launches the eager ones, and the routing
    tally's counters equal."""
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.kernels import moe
    from opus_pllm_tpu_torch.utils.observability import SPANS
    cfg = _tiny_deepseek_card()
    g = _gen()
    llm = decoder.fuse_projections(
        decoder.init(cfg, generator=g, device="cuda"), cfg)
    assert "gateup_proj" in llm["layers"][1]["experts"]
    x = _rnd(g, 8, 24, 512, scale=0.5)
    am = torch.ones((8, 24), dtype=torch.bool, device="cuda")
    am[:3, :5] = False
    new = 12
    kw = dict(max_new_tokens=new, temperature=temperature, top_p=0.7,
              eos_token_id=-1)
    args = lambda: (llm, cfg, x, am, decoder.positions_from_mask(am),
                    torch.Generator(device="cuda").manual_seed(3))
    names = ("moe.pairs", "moe.experts_hit", "moe.busiest", "moe.slots")

    def run():
        moe.reset_launches()
        before = SPANS.counters()
        out = _generate_seen(monkeypatch, args(), **kw)
        after = SPANS.counters()
        return out, dict(moe.launches), {
            n: after.get(n, 0) - before.get(n, 0) for n in names}

    (g_out, g_seen, _, g_grew), g_moe, g_tally = run()
    monkeypatch.setattr(engine, "_graphable", lambda *a: False)
    (e_out, e_seen, _, e_grew), e_moe, e_tally = run()
    assert g_out.steps == e_out.steps == new
    assert torch.equal(g_out.tokens, e_out.tokens)
    for step in range(new):
        assert torch.equal(g_seen[step], e_seen[step]), step
    assert g_grew == {"decode.steps": new, "decode.graph_steps": new - 1}
    assert g_moe == e_moe
    assert g_tally == e_tally
    assert g_tally["moe.pairs"] == 2 * 8 * 2 * new      # layers x rows x k
    assert g_tally["moe.slots"] == 2 * 8 * new
