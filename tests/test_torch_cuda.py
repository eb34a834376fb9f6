"""The CUDA kernels against their plain versions on the card, at small and
ragged shapes the main path can also produce: the four fused-encoder
kernels (ln_qkv_rope, out_proj and ffn at every tile width of their TMA +
wgmma core, bit-identical across calls), the int4 v2 matmul, both quantized decode attentions, flash
attention, the int8 matmul, the two flash-attention backward kernels and
the int4 v1 matmul (the int8 and the v1 matmul each in its TMA + wgmma
kernel and in the kernel kept for N that is not a multiple of 16); then
the gradients through the autograd Functions and the launch counts of one
tiny train step (a CUDA kernel has no CPU mode:
these skip where torch sees no GPU). Run on a GPU machine with:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: tests/conftest.py configures JAX, which a GPU machine
need not have; nothing here imports it).

Tolerance as in chip_smoke.py: max|kernel - plain_fp32| <= 2 *
max|plain_bf16 - plain_fp32| + 4e-3, i.e. the kernel may not lose more than
the bf16 output format forces plus half a bf16 ulp at magnitude 1-2.
plain_fp32 runs the plain version on the same values in fp32 (the int4
matmul rounds x to bf16 in both), plain_bf16 in bf16.
"""

import pytest
import torch

import dataclasses

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
    M), bf16 and fp32 x. N = 130 takes the kernel kept for N % 4 != 0;
    the others the tensor-core kernel, whose K splits over clusters of 1
    to 8 CTAs (quant4.v2_plan). One launch a call, of the variant's
    counter."""
    g = _gen()
    q, s = quant4.quantize_grouped(
        torch.randn((k, n), generator=g, device="cuda"))
    packed = quant4.pack_int4_v2(q)
    del q
    name = quant4.v2_kernel_variant(n)
    assert name == ("int4_matmul_unaligned" if n == 130 else "int4_matmul")
    for m in (1, 3, 8, 17, 33, 64):
        x = _rnd(g, m, k)
        quant4.reset_launches()
        _check(lambda x: quant4.int4_matmul(x, packed, s),
               lambda x: quant4.int4_matmul_plain(x, packed, s), (x,))
        assert quant4.launches == dict(
            {key: 0 for key in quant4.launches}, **{name: 1})
        # fp32 x: the output stays fp32 and differs from the plain version
        # by summation order only
        out = quant4.int4_matmul(x.float(), packed, s)
        ref = quant4.int4_matmul_plain(x.float(), packed, s)
        assert out.dtype == torch.float32
        assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


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
    q, s = quant4.quantize_grouped(torch.randn((512, 6), device="cuda"))
    x = torch.zeros((2, 512), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):            # odd N
        quant4.int4_matmul(x, quant4.pack_int4_v2(q[:, :5]), s[:, :5])
    kl, vl, mask4 = _cache(_gen(), 1, 1, 8, 128, "int8")
    q1 = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError):            # int mask
        da.decode_attention_int8(q1, kl, vl, mask4.int())
    with pytest.raises(ValueError):            # int8 leaves to the int4 one
        da.decode_attention_int4(q1, kl, vl, mask4)


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
    """Ragged M and N (a scalar and a vector epilogue), K a multiple of 16
    but not of 32, and the static prefill's M."""
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((k, n), generator=g,
                                                   device="cuda"))
    quant.reset_launches()
    _check(lambda x: quant.int8_matmul(x, wq, s),
           lambda x: quant.int8_matmul_plain(x, wq, s), (_rnd(g, m, k),))
    # N = 130 / 1000 are not 16-byte row strides: the kernel kept for them
    tma = n % 16 == 0
    assert quant.launches == {"int8_matmul": int(tma),
                              "int8_matmul_unaligned": int(not tma)}


@pytest.mark.parametrize("m,k,n", [(256, 4112, 1040), (257, 4112, 1040),
                                   (300, 4112, 1040), (8304, 4112, 1040),
                                   (256, 4096, 128256)])
def test_int8_matmul_tma(m, k, n):
    """The TMA + wgmma kernel: ragged M (one row past a tile, 8304 = 64.875
    tiles), N a multiple of 16 but not of the 128-column tile, K a multiple
    of 16 but not of the 64-row step, and the full vocab head; the kept
    kernel is not launched, and two calls agree bit for bit."""
    g = _gen()
    wq, s = quant.quantize_per_channel(torch.randn((k, n), generator=g,
                                                   device="cuda"))
    x = _rnd(g, m, k)
    quant.reset_launches()
    _check(lambda x: quant.int8_matmul(x, wq, s),
           lambda x: quant.int8_matmul_plain(x, wq, s), (x,))
    assert torch.equal(quant.int8_matmul(x, wq, s),
                       quant.int8_matmul(x, wq, s))
    assert quant.launches == {"int8_matmul": 3, "int8_matmul_unaligned": 0}


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
    """Ragged M and N (N = 130: scalar loads and stores), K one or several
    256-row blocks; fp32 x stays fp32 and differs by summation order."""
    g = _gen()
    q, s = quant4.quantize_grouped(torch.randn((k, n), generator=g,
                                               device="cuda"))
    packed = quant4.pack_int4(q)
    x = _rnd(g, m, k)
    quant4.reset_launches()
    _check(lambda x: quant4.int4_matmul(x, packed, s),
           lambda x: quant4.int4_matmul_plain(x, packed, s), (x,))
    # N = 130 / 1000 are not 16-byte row strides: the kernel kept for them
    tma = n % 16 == 0
    assert quant4.launches == {"int4_matmul": 0, "int4_matmul_unaligned": 0,
                               "int4_matmul_v1": int(tma),
                               "int4_matmul_v1_unaligned": int(not tma)}
    out = quant4.int4_matmul(x.float(), packed, s)
    ref = quant4.int4_matmul_plain(x.float(), packed, s)
    assert out.dtype == torch.float32
    assert (out - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


@pytest.mark.parametrize("m,k,n", [
    *((m, k, 1040) for m in (256, 257, 300, 8304) for k in (256, 768, 4096)),
    (300, 4096, 128256)])
def test_int4_matmul_v1_tma(m, k, n):
    """The TMA + wgmma kernel: ragged M, N a multiple of 16 but not of the
    128-column tile, one to sixteen 256-row blocks, and the full vocab
    head; fp32 x stays fp32 within 1e-5 of the plain version (so the fp32
    group scales were not rounded); the kept kernel is not launched, and
    two calls agree bit for bit."""
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
    assert quant4.launches == {"int4_matmul": 0, "int4_matmul_unaligned": 0,
                               "int4_matmul_v1": 4,
                               "int4_matmul_v1_unaligned": 0}


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
    plus the head; the loss is finite and LoRA B moved."""
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
    # the head's N = 260 is not a 16-byte row stride: the kept kernel
    v1 = base == "int4-v1"
    assert quant4.launches == {"int4_matmul": 0, "int4_matmul_unaligned": 0,
                               "int4_matmul_v1": 2 * 7 * nl if v1 else 0,
                               "int4_matmul_v1_unaligned": int(v1)}
    assert set(quant.launches.values()) == {0}
    assert sum(da.launches.values()) == 0
    loss = float(logs[0].split("loss=")[1])
    assert torch.isfinite(torch.tensor(loss))
    b1 = [ab["B"] for lp in state.trainable["lora"]["layers"]
          for ab in lp.values()]
    assert all(not torch.equal(x, y) for x, y in zip(b0, b1))
