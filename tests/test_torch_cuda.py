"""The four fused-encoder CUDA kernels against their plain versions on the
card, at small and ragged shapes the main path can also produce (a CUDA
kernel has no CPU mode: these skip where torch sees no GPU). Run on a GPU
machine with:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(`--noconftest`: tests/conftest.py configures JAX, which a GPU machine
need not have; nothing here imports it).

Tolerance as in chip_smoke.py: max|kernel - plain_fp32| <= 2 *
max|plain_bf16 - plain_fp32| + 4e-3, i.e. the kernel may not lose more than
the bf16 output format forces plus half a bf16 ulp at magnitude 1-2.
"""

import pytest
import torch

from opus_pllm_tpu_torch.core.config import ESM2Config
from opus_pllm_tpu_torch.kernels import fused_encoder as fe
from opus_pllm_tpu_torch.models import esm2
from opus_pllm_tpu_torch.models.layers import rope_cos_sin

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


def _check(kern, plain, bf_in, extra=()):
    ref32 = plain(*(t.float() for t in bf_in), *extra).float()
    ref_bf = plain(*bf_in, *extra).float()
    out = kern(*bf_in, *extra)
    torch.cuda.synchronize()
    err = (out.float() - ref32).abs().max().item()
    bound = 2 * (ref_bf - ref32).abs().max().item() + ATOL
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


@pytest.mark.parametrize("b,h,s,masked", [(2, 4, 1, False), (2, 4, 70, True),
                                          (1, 20, 129, True),
                                          (2, 2, 64, False)])
def test_encoder_attention(b, h, s, masked):
    g = _gen()
    mask = None
    if masked:
        lengths = torch.randint(1, s + 1, (b,), generator=g, device="cuda")
        mask = torch.arange(s, device="cuda")[None] < lengths[:, None]
    _check(fe.encoder_attention, fe.encoder_attention_plain,
           (_rnd(g, 3, b, h, s, 64),), (mask,))


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
