"""Port parity: the quantized KV cache (opus_pllm_tpu_torch.models.decoder)
and opus_pllm_tpu_torch.kernels.decode_attention vs the JAX package.

Quantized bytes must be identical: jnp.round and torch.round both round
half to even, and the test feeds exact half-way values to show it. The
plain version (dequantize, then attend) is held to the JAX Pallas kernels
in interpret mode and to `decode_attention_int8_reference`; the decoder's
prefill and decode steps over int8 / int4 caches to the JAX decoder."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.kernels import decode_attention as jda
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import DecoderConfig
from opus_pllm_tpu_torch.kernels import decode_attention as da
from opus_pllm_tpu_torch.models import decoder

QUANT = {"int8": (jdec._quantize_kv, decoder._quantize_kv, 127.0),
         "int4": (jdec._quantize_kv4, decoder._quantize_kv4, 7.0)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _leaf_np(leaf):
    return {k: np.asarray(v) for k, v in leaf.items()}


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_quantize_kv_bytes_match_jax_with_ties(kind):
    jfn, tfn, top = QUANT[kind]
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 9, 2, 128)).astype(np.float32)
    # rows whose absmax is `top` have scale exactly 1: put half-way values
    # there (2.5 -> 2, 3.5 -> 4 under round-half-to-even)
    x[0, :4, 0] = rng.integers(-6, 6, size=(4, 128)) + 0.5
    x[0, :4, 0, 0] = top
    ref, got = _leaf_np(jfn(jnp.asarray(x))), tfn(_t(x))
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == _t(ref[k]).dtype
        np.testing.assert_array_equal(got[k].numpy(), ref[k])
    assert (ref["s"][0, 0, :4] == 1.0).all()
    deq = decoder._dequantize_kv(got, torch.float32).numpy()
    np.testing.assert_array_equal(
        deq, np.asarray(jdec._dequantize_kv(jfn(jnp.asarray(x)),
                                            jnp.float32)))
    np.testing.assert_array_equal(deq[0, :4, 0, 1:],
                                  np.round(x[0, :4, 0, 1:]))


def _mk(kind, b=2, cap=512, hq=8, hkv=2, d=128, seed=0):
    jfn = QUANT[kind][0]
    rng = np.random.default_rng(seed)
    q = (rng.standard_normal((b, 1, hq, d)) * 0.3).astype(np.float32)
    k = rng.standard_normal((b, cap, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, cap, hkv, d)).astype(np.float32)
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        mask[i, :int(rng.integers(10, cap))] = True
    return (q, _leaf_np(jfn(jnp.asarray(k))), _leaf_np(jfn(jnp.asarray(v))),
            mask[:, None, None, :])


def _port(q, kl, vl, mask4, fn):
    return fn(_t(q), {k: _t(v) for k, v in kl.items()},
              {k: _t(v) for k, v in vl.items()}, _t(mask4)).numpy()


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("hq,hkv", [(8, 2), (4, 4), (8, 1)])
def test_plain_matches_pallas_interpret(kind, hq, hkv):
    """The plain version (fp32 dequantize, fp32 attention) vs the TPU
    kernel in interpret mode, which rounds q and the softmax weights to
    bf16: tolerance 2e-2, the bound tests/test_decode_attention.py uses
    for the same kernel against the same reference."""
    q, kl, vl, mask4 = _mk(kind, hq=hq, hkv=hkv)
    kern = jda.decode_attention_int4 if kind == "int4" else \
        jda.decode_attention_int8
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(kern(jnp.asarray(q), jax.tree.map(jnp.asarray, kl),
                              jax.tree.map(jnp.asarray, vl),
                              jnp.asarray(mask4)))
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    got = _port(q, kl, vl, mask4, fn)
    assert got.shape == ref.shape == (2, 1, hq, 128)
    np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_plain_matches_reference_at_capacity_391(kind):
    """The annotate decode capacity (327 + 64 = 391, not a multiple of 256:
    the TPU kernel's gate refuses it, the port's takes it). fp32 q: the
    port's plain version and the JAX reference run the same composition,
    equal up to fp32 op order (rtol 1e-5, atol 1e-6)."""
    q, kl, vl, mask4 = _mk(kind, b=3, cap=391, hq=8, hkv=2, seed=1)
    ref = np.asarray(jda.decode_attention_int8_reference(
        jnp.asarray(q), jax.tree.map(jnp.asarray, kl),
        jax.tree.map(jnp.asarray, vl), jnp.asarray(mask4)))
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    np.testing.assert_allclose(_port(q, kl, vl, mask4, fn), ref, rtol=1e-5,
                               atol=1e-6)
    tq = _t(q)
    kt = {k: _t(v) for k, v in kl.items()}
    assert da.supports(tq, kt, _t(mask4))
    assert not jda.supports(jnp.asarray(q), jax.tree.map(jnp.asarray, kl),
                            jnp.asarray(mask4))


def test_supports_gate():
    q, kl, vl, mask4 = _mk("int8", cap=16)
    kt = {k: _t(v) for k, v in kl.items()}
    m = _t(mask4)
    assert da.supports(_t(q), kt, m)
    assert not da.supports(_t(q), _t(np.zeros((2, 5, 2, 128))), m)
    assert not da.supports(_t(np.zeros((2, 2, 8, 128))), kt, m)    # Sq=2
    assert not da.supports(_t(np.zeros((2, 1, 32, 128))), kt, m)   # G=16
    assert not da.supports(_t(np.zeros((2, 1, 8, 96))), kt, m)     # D=96
    assert not da.supports(_t(q), kt, m.expand(2, 1, 3, 16))


def _cfgs():
    kw = dict(vocab_size=256, hidden_size=512, intermediate_size=1024,
              num_layers=2, num_heads=4, num_kv_heads=2, head_dim=128,
              dtype="float32")
    return JDecoderConfig(**kw), DecoderConfig(**kw)


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = _cfgs()
    jp = jdec.init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, convert.decoder_from_jax(jax.tree.map(
        np.asarray, jp), device="cpu")


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_decoder_over_quantized_cache_matches_jax(model, kind):
    """Prefill 9 tokens (left padding in row 1) into a 12-slot quantized
    cache, then 3 decode steps: logits and cache bytes vs the JAX decoder.
    Prefill over a quantized cache attends over the DEQUANTIZED K/V
    (decoder.py:320-323), not the fresh ones: its logits part from the
    fp32-cache prefill's by ten times the tolerance or more. Tolerance
    rtol 1e-4 / atol 1e-4: fp32 op order through 2 layers and a 256-way
    head. K/V agree to fp32 op order, so a cache byte may round the other
    way where a value sits on a rounding boundary: at most 0.1% of them."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.default_rng(2)
    b, l, cap = 2, 9, 12
    x = rng.standard_normal((b, l, 512)).astype(np.float32)
    am = np.ones((b, l), bool)
    am[1, :3] = False
    pos = np.asarray(jdec.positions_from_mask(jnp.asarray(am)))
    pre = (np.pad(am, ((0, 0), (0, cap - l)))[:, None, None, :]
           & (np.arange(cap)[None, None, None, :]
              <= np.arange(l)[None, None, :, None]))

    jc = jdec.init_cache(jcfg, b, cap, quantize=kind)
    jc["mask"] = jc["mask"].at[:, :l].set(jnp.asarray(am))
    tc = decoder.init_cache(tcfg, b, cap, quantize=kind, device="cpu")
    tc["mask"][:, :l] = _t(am)
    ref, jc = jdec.forward(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                           jnp.asarray(pre), jc)
    got, tc = decoder.forward(tp, tcfg, _t(x), _t(pos), _t(pre), tc)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    plain, _ = decoder.forward(tp, tcfg, _t(x), _t(pos), _t(pre),
                               decoder.init_cache(tcfg, b, cap, device="cpu"))
    assert np.abs(plain.numpy() - got.numpy()).max() > 10 * tol["atol"]

    for i in range(3):
        e = rng.standard_normal((b, 1, 512)).astype(np.float32)
        jc["mask"] = jc["mask"].at[:, l + i].set(True)
        tc["mask"][:, l + i] = True
        p = pos[:, -1:] + 1 + i
        ref, jc = jdec.forward(jp, jcfg, jnp.asarray(e), jnp.asarray(p),
                               jc["mask"][:, None, None, :], jc)
        m4 = tc["mask"][:, None, None, :]
        got, tc = decoder.forward(tp, tcfg, _t(e), _t(p), m4, tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    assert tc["index"] == int(jc["index"]) == l + 3
    for jl, tl in zip(jc["layers"], tc["layers"]):
        for kv in ("k", "v"):
            for key, val in jl[kv].items():
                if key == "s":
                    np.testing.assert_allclose(tl[kv][key].numpy(),
                                               np.asarray(val), **tol)
                else:
                    assert (tl[kv][key].numpy() != np.asarray(val)).mean() \
                        <= 1e-3


def _masked_inputs(kind, b, cap, hq, hkv, d, seed, masks):
    """q, the two cache leaves (the port's quantizer on numpy draws) and a
    (B, 1, 1, cap) mask whose row i is masks[i % len(masks)] of
    `_slot_mask`."""
    rng = np.random.default_rng(seed)
    quant = QUANT[kind][1]
    q = (rng.standard_normal((b, 1, hq, d)) * 0.5).astype(np.float32)
    kl, vl = (quant(_t(rng.standard_normal((b, cap, hkv, d)).astype(
        np.float32))) for _ in range(2))
    kl, vl = ({k: v.contiguous() for k, v in leaf.items()}
              for leaf in (kl, vl))
    mask = np.stack([_slot_mask(masks[i % len(masks)], cap, rng)
                     for i in range(b)])
    return q, kl, vl, mask[:, None, None, :]


def _slot_mask(how, cap, rng):
    """One row's slots: "left" the static decode's left padding, prompt
    and unwritten tail; "holes" ragged with every third 16-slot slab and
    every fifth slot cleared (slot 0 kept); "tail" a full prefix; "none"
    no valid slot; "tile0" only slots of the first 64-slot tile."""
    s = np.arange(cap)
    if how == "none":
        return np.zeros(cap, bool)
    if how == "tile0":
        return s < min(cap, 1 + int(rng.integers(0, 63)))
    n = int(rng.integers(1, cap + 1))
    if how == "left":
        pad = int(rng.integers(0, cap))
        return (s >= pad) & (s < pad + n)
    m = s < n
    if how == "holes":
        m &= ((s // 16) % 3 != 1) & (s % 5 != 4)
        m[0] = True
    return m


def _ints(leaf):
    q = decoder._unpack_kv4(leaf["q4"]) if "q4" in leaf else leaf["q"]
    return q.double().numpy(), leaf["s"][..., 0].double().numpy()


def _sweep_like_the_kernel(q, kl, vl, mask):
    """decode_attention as the CUDA kernel runs it, in fp64: for each (row,
    KV head), the 64-slot tiles are dealt in turn to `decode_splits` CTAs;
    warp w of a CTA takes slab w (of 16 slots) of each of its tiles,
    skips the slabs whose mask is false everywhere, and runs an online softmax in base 2 over the
    valid slots (p = 0 exactly elsewhere); the warps' (m, l, o), then the
    CTAs', merge in a fixed order, a state with m = -inf weighing 0; out =
    o / max(l, 1e-30). Returns out and the number of CTAs that had no
    valid slot."""
    b, _, hq, d = q.shape
    kq, ks = _ints(kl)
    vq, vs = _ints(vl)
    hkv, cap = kq.shape[1], kq.shape[2]
    grp = hq // hkv
    qq = q.astype(np.float64).reshape(b, hkv, grp, d)
    mk = mask.reshape(b, cap)
    splits = da.decode_splits(b, hkv, cap)
    n_slabs = -(-cap // 16)
    log2e = 1.0 / np.log(2.0)
    out = np.zeros((b, hkv, grp, d))
    idle = 0

    def merge(states):
        mx = np.max([m for m, _, _ in states], axis=0)
        o, l = np.zeros((grp, d)), np.zeros(grp)
        for m, lw, ow in states:
            f = np.where(m == -np.inf, 0.0, np.exp2(m - np.where(
                mx == -np.inf, 0.0, mx)))
            o += f[:, None] * ow
            l += f * lw
        return mx, l, o

    for bi in range(b):
        for h in range(hkv):
            ctas = []
            for c in range(splits):
                warps = []
                for w in range(4):
                    m = np.full(grp, -np.inf)
                    l, o = np.zeros(grp), np.zeros((grp, d))
                    for slab in range(4 * c + w, n_slabs, 4 * splits):
                        sl = slice(16 * slab, min(16 * slab + 16, cap))
                        ok = mk[bi, sl]
                        if not ok.any():
                            continue
                        x = (qq[bi, h] @ kq[bi, h, sl].T) * ks[bi, h, sl] \
                            / np.sqrt(d) * log2e
                        x = np.where(ok[None], x, -np.inf)
                        m_new = np.maximum(m, x.max(-1))
                        alpha = np.exp2(m - m_new)
                        p = np.exp2(x - m_new[:, None])
                        l = l * alpha + p.sum(-1)
                        o = o * alpha[:, None] + (p * vs[bi, h, sl]) \
                            @ vq[bi, h, sl]
                        m = m_new
                    warps.append((m, l, o))
                state = merge(warps)
                idle += bool((state[0] == -np.inf).all())
                ctas.append(state)
            _, l, o = merge(ctas)
            out[bi, h] = o / np.maximum(l, 1e-30)[:, None]
    return out.reshape(b, 1, hq, d), idle


def test_decode_splits_fill_the_card_without_an_empty_cta():
    """At most 8 CTAs a cluster and no more than the 64-slot tiles there
    are; otherwise enough that the grid reaches 264 CTAs."""
    for b, hkv, cap in [(8, 8, 391), (32, 8, 2048), (17, 8, 576), (1, 1, 1),
                        (2, 2, 65), (3, 2, 4097), (1, 8, 8192)]:
        splits = da.decode_splits(b, hkv, cap)
        tiles = -(-cap // 64)
        assert 1 <= splits <= min(8, tiles)
        assert splits == min(8, tiles) or b * hkv * splits >= 264
    assert da.decode_splits(8, 8, 391) == 5
    assert da.decode_splits(32, 8, 2048) == 2


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(2, 2), (8, 2), (16, 2)])
@pytest.mark.parametrize("cap", [1, 63, 64, 65, 391])
def test_kernel_sweep_matches_the_plain_version(kind, d, hq, hkv, cap):
    """The kernel's split ranges, skipped slabs and fixed-order merge
    compute the plain version's function, rows of left padding, holes and
    tails and a row with no valid slot (out 0) included. fp64 sweep vs the
    fp32 plain version: rtol 1e-4, atol 1e-5 (fp32 op order)."""
    q, kl, vl, mask4 = _masked_inputs(kind, 4, cap, hq, hkv, d, seed=cap,
                                      masks=["left", "holes", "tail",
                                             "none"])
    got, _ = _sweep_like_the_kernel(q, kl, vl, mask4)
    ref = da.decode_attention_plain(_t(q), kl, vl, _t(mask4)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    assert not np.any(got[3]) and not np.any(ref[3])


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_kernel_sweep_with_ctas_that_have_no_valid_tile(kind):
    """One (row, KV head) split over 7 CTAs, the slots valid in the first
    tile only: six CTAs merge an empty state and weigh 0."""
    q, kl, vl, mask4 = _masked_inputs(kind, 1, 391, 4, 1, 128, seed=5,
                                      masks=["tile0"])
    assert da.decode_splits(1, 1, 391) == 7
    got, idle = _sweep_like_the_kernel(q, kl, vl, mask4)
    assert idle == 6
    ref = da.decode_attention_plain(_t(q), kl, vl, _t(mask4)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_plain_gives_zero_without_a_valid_slot(kind):
    """The port's rule: a row with no valid slot gets out 0 (the kernel's
    weights are 0 exactly there); on every other row the plain version
    matches the Pallas kernel in interpret mode (tolerance 2e-2, as
    test_plain_matches_pallas_interpret: the TPU kernel rounds q and the
    weights to bf16), which averages v over all slots of the empty row."""
    q, kl, vl, mask4 = _masked_inputs(kind, 3, 256, 8, 2, 128, seed=3,
                                      masks=["left", "none", "holes"])
    kern = jda.decode_attention_int4 if kind == "int4" else \
        jda.decode_attention_int8
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(kern(
            jnp.asarray(q), {k: jnp.asarray(v.numpy()) for k, v in
                             kl.items()},
            {k: jnp.asarray(v.numpy()) for k, v in vl.items()},
            jnp.asarray(mask4)))
    fn = da.decode_attention_int4 if kind == "int4" else \
        da.decode_attention_int8
    got = fn(_t(q), kl, vl, _t(mask4)).numpy()
    assert not np.any(got[1]) and np.any(ref[1])
    keep = [0, 2]
    np.testing.assert_allclose(got[keep], ref[keep], rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("kind", ["int8", "int4"])
def test_no_path_attends_a_row_without_a_valid_slot(model, kind,
                                                    monkeypatch):
    """Where the kernels' rule (a row with no valid slot gets out 0)
    differs from the TPU kernel's, no path reaches it: every one-token
    attention over a quantized cache that the static decode (left-padded
    prompts, one padded to a single token) and the serving engine (rows
    of several lengths, a slot left idle) run has a valid slot in every
    batch row."""
    from opus_pllm_tpu_torch.infer import engine
    from opus_pllm_tpu_torch.serve.engine import ServeRequest, ServingEngine
    _, tcfg, _, tp = model
    rows_ok = []
    plain = da.decode_attention_plain

    def spy(q, k_leaf, v_leaf, mask4):
        rows_ok.append(bool(mask4.reshape(q.shape[0], -1).any(-1).all()))
        return plain(q, k_leaf, v_leaf, mask4)

    monkeypatch.setattr(da, "decode_attention_plain", spy)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((3, 9, 512)).astype(
        np.float32) * 0.3)
    am = torch.ones((3, 9), dtype=torch.bool)
    am[1, :8] = False
    am[2, :3] = False
    pos = torch.tensor(np.asarray(jdec.positions_from_mask(
        jnp.asarray(am.numpy()))))
    engine.generate(tp, tcfg, x, am, pos, torch.Generator().manual_seed(0),
                    max_new_tokens=4, temperature=0.0, eos_token_id=-1,
                    pad_token_id=0, quantize_cache=kind)
    n_static = len(rows_ok)
    eng = ServingEngine(tp, tcfg, max_slots=3, max_len=32,
                        prefill_buckets=(16,), quantize_cache=kind,
                        steps_per_tick=2)
    eng.run([ServeRequest(str(i), embeds=x[i, 9 - n:].numpy(),
                          max_new_tokens=3 + i)
             for i, n in enumerate((9, 1))])
    assert n_static > 0 and len(rows_ok) > n_static and all(rows_ok)


# ---- the bf16 cache: decode_attention_bf16 and its gate ----

def _bf16_inputs(b, cap, hq, hkv, d, seed, lengths=None):
    """q (B, 1, Hq, D), K / V (B, cap, Hkv, D) in bf16 and a left-padded
    (B, 1, 1, cap) mask: row i valid over [pad_i, pad_i + n_i)."""
    rng = np.random.default_rng(seed)
    q = _t((rng.standard_normal((b, 1, hq, d)) * 0.5).astype(
        np.float32)).bfloat16()
    k, v = (_t(rng.standard_normal((b, cap, hkv, d)).astype(
        np.float32)).bfloat16() for _ in range(2))
    mask = np.zeros((b, cap), bool)
    for i in range(b):
        n = int(rng.integers(1, cap + 1)) if lengths is None else lengths[i]
        pad = int(rng.integers(0, cap - n + 1))
        mask[i, pad:pad + n] = True
    return q, k, v, _t(mask)[:, None, None, :]


def _bf16_case(case):
    """(q, k, mask4) of a named gate case at B = 2, cap 70."""
    b, cap, d, hq, hkv = 2, 70, 128, 8, 2
    k_dtype, sq, mask = torch.bfloat16, 1, "broadcast"
    if case.startswith("d"):
        d = int(case[1:])
    elif case.startswith("g"):
        hq, hkv = int(case[1:]) * 2, 2
    elif case.startswith("cap"):
        cap = int(case[3:])
    elif case == "sq2":
        sq = 2
    elif case == "fp32 leaf":
        k_dtype = torch.float32
    elif case == "per-head mask":
        mask = "per-head"
    elif case == "int mask":
        mask = "int"
    q = torch.zeros((b, sq, hq, d), dtype=torch.bfloat16)
    k = torch.zeros((b, cap, hkv, d), dtype=k_dtype)
    m = torch.ones((b, 1, 1, cap), dtype=torch.bool)
    if mask == "per-head":
        m = m.expand(b, hq, 1, cap)
    elif mask == "int":
        m = m.int()
    if case == "quantized leaf":
        return q, decoder._quantize_kv(k.float()), m
    if case == "fp32 q":
        q = q.float()
    return q, k, m


@pytest.mark.parametrize("case,taken", [
    ("d64", True), ("d128", True), ("g1", True), ("g4", True),
    ("g7", True), ("g8", True), ("cap1", True), ("cap63", True),
    ("cap455", True), ("cap4097", True),
    ("sq2", False), ("g9", False), ("d80", False), ("fp32 leaf", False),
    ("quantized leaf", False), ("per-head mask", False),
    ("int mask", False), ("fp32 q", False)])
def test_supports_bf16_gate(case, taken):
    """The bf16 kernel's shapes: one bf16 query token over a bf16 leaf,
    D 64 / 128, up to 8 query heads a KV head, any capacity, a broadcast
    bool mask; the quantized gate refuses every bf16 leaf."""
    q, k, m = _bf16_case(case)
    assert da.supports_bf16(q, k, m) is taken
    if not isinstance(k, dict):
        assert not da.supports(q, k, m)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2), (28, 4), (8, 1)])
@pytest.mark.parametrize("cap", [1, 65, 455])
def test_bf16_plain_is_attention_xla(d, hq, hkv, cap):
    """On CPU tensors decode_attention_bf16 is attention_xla, bit for bit,
    and launches nothing."""
    from opus_pllm_tpu_torch.models.layers import attention_xla
    q, k, v, mask4 = _bf16_inputs(3, cap, hq, hkv, d, seed=cap + hq)
    da.reset_launches()
    got = da.decode_attention_bf16(q, k, v, mask4)
    assert da.supports_bf16(q, k, mask4)
    assert got.dtype == torch.bfloat16 and got.shape == (3, 1, hq, d)
    assert torch.equal(got, attention_xla(q, k, v, mask4))
    assert set(da.launches.values()) == {0}


def _bf16_llm(family):
    """A tiny bf16 decoder of `family` whose one-token attention the bf16
    gate takes: qwen2 7 query heads on 1 KV head (G = 7, D = 64), llama
    8 on 2 (G = 4, D = 128), opt 4 on 4 (G = 1, D = 64)."""
    import dataclasses
    heads = {"qwen2": (7, 1, 64), "llama": (8, 2, 128), "opt": (4, 4, 64)}
    hq, hkv, d = heads[family]
    cfg = dataclasses.replace(DecoderConfig.tiny(family), num_heads=hq,
                              num_kv_heads=hkv, head_dim=d,
                              dtype="bfloat16")
    params = decoder.init(cfg, generator=torch.Generator().manual_seed(0),
                          device="cpu")
    return cfg, params


@pytest.mark.parametrize("temperature", [0.0, 0.7])
@pytest.mark.parametrize("family", ["qwen2", "llama", "opt"])
def test_bf16_cache_generate_tokens_unchanged(family, temperature,
                                              monkeypatch):
    """engine.generate over a bf16 cache on CPU: every decode step's
    attention goes through decode_attention_bf16 (layers x steps calls),
    and the tokens equal those of the path before it, where the gate
    refused every bf16 leaf and `attention` took attention_xla."""
    from opus_pllm_tpu_torch.infer import engine
    cfg, params = _bf16_llm(family)
    rng = np.random.default_rng(7)
    x = _t((rng.standard_normal((3, 9, cfg.hidden_size)) * 0.5).astype(
        np.float32)).bfloat16()
    am = torch.ones((3, 9), dtype=torch.bool)
    am[1, :5] = False
    am[2, :8] = False
    pos = decoder.positions_from_mask(am)
    calls, kernel = [], da.decode_attention_bf16

    def spy(*a):
        calls.append(a[0].shape)
        return kernel(*a)

    def run():
        return engine.generate(
            params, cfg, x, am, pos, torch.Generator().manual_seed(1),
            max_new_tokens=6, temperature=temperature, eos_token_id=-1,
            pad_token_id=0)

    monkeypatch.setattr(da, "decode_attention_bf16", spy)
    new = run()
    assert len(calls) == cfg.num_layers * new.steps
    assert all(s == (3, 1, cfg.num_heads, cfg.head_dim) for s in calls)
    monkeypatch.setattr(da, "supports_bf16", lambda *a: False)
    old = run()
    assert len(calls) == cfg.num_layers * new.steps
    assert torch.equal(new.tokens, old.tokens)
    assert torch.equal(new.lengths, old.lengths)
