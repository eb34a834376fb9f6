"""Port parity: CSTP, switch projector and splice (opus_pllm_tpu_torch.bridge)
vs opus_pllm_tpu.bridge.

cstp/projector run in fp32 on both sides: rtol 1e-5 / atol 1e-6 (op order).
splice must be exact: masks, positions and labels equal, embeddings equal
bit for bit (a gather moves values without arithmetic)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.bridge import cstp as jcstp
from opus_pllm_tpu.bridge import projector as jproj
from opus_pllm_tpu.bridge import splice as jsplice
from opus_pllm_tpu.core.config import CSTPConfig as JCSTPConfig
from opus_pllm_tpu.core.config import (SEQ_TOKEN_INDEX,
                                       SwitchProjectorConfig as JSwitch)
from opus_pllm_tpu_torch.bridge import cstp, projector, splice
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import (CSTPConfig,
                                             SwitchProjectorConfig)


def _np_tree(tree):
    return convert._tree(jax.tree.map(np.asarray, tree), None)


def test_cstp_protein_forward():
    jp = jcstp.init(jax.random.PRNGKey(0), JCSTPConfig.tiny())
    emb = np.random.default_rng(0).standard_normal((5, 64)).astype(np.float32)
    emb[2] = 0.0                               # the eps clamp of the norm
    ref = jcstp.protein_forward(jp, jnp.asarray(emb))
    got = cstp.protein_forward(_np_tree(jp), torch.from_numpy(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("ptype", ["linear", "mlp2x_gelu", "mlp3x_gelu"])
def test_projector_apply(ptype):
    jcfg = JSwitch(input_dim=24, llm_hidden_size=16, n_tokens=3,
                   projector_type=ptype)
    tcfg = SwitchProjectorConfig(input_dim=24, llm_hidden_size=16, n_tokens=3,
                                 projector_type=ptype)
    jp = jproj.init(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(1).standard_normal((4, 24)).astype(np.float32)
    ref = jproj.apply(jp, jcfg, jnp.asarray(x))
    got = projector.apply(_np_tree(jp), tcfg, torch.from_numpy(x))
    assert tuple(got.shape) == (4, 3, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    g = torch.Generator().manual_seed(0)
    tp = projector.init(tcfg, generator=g, device="cpu")
    assert [l["kernel"].shape for l in tp["layers"]] == \
        [tuple(l["kernel"].shape) for l in jp["layers"]]


def _splice_inputs(rng, left: bool):
    b, l, h, t = 3, 10, 6, 4
    ids = rng.integers(3, 50, (b, l)).astype(np.int32)
    mask = np.zeros((b, l), bool)
    lens = [10, 7, 4]
    for i, n in enumerate(lens):
        sl = slice(l - n, l) if left else slice(0, n)
        mask[i, sl] = True
    ids[~mask] = 0
    # sentinels: row 0 two proteins, row 1 one, row 2 none
    for i, cols in enumerate([[2, 6], [5], []]):
        for c in cols:
            ids[i, (l - lens[i] + c) if left else c] = SEQ_TOKEN_INDEX
    text = rng.standard_normal((b, l, h)).astype(np.float32)
    prot = rng.standard_normal((b, 2, t, h)).astype(np.float32)
    labels = np.where(mask, ids, -100).astype(np.int32)
    return ids, mask, text, prot, labels, t


@pytest.mark.parametrize("left_pad", [True, False])
@pytest.mark.parametrize("with_labels", [True, False])
def test_splice_exact(left_pad, with_labels):
    rng = np.random.default_rng(7)
    ids, mask, text, prot, labels, t = _splice_inputs(rng, left_pad)
    lab = labels if with_labels else None
    ref = jsplice.splice(jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(text), jnp.asarray(prot),
                         None if lab is None else jnp.asarray(lab),
                         n_tokens=t, left_pad=left_pad)
    got = splice.splice(torch.from_numpy(ids), torch.from_numpy(mask),
                        torch.from_numpy(text), torch.from_numpy(prot),
                        None if lab is None else torch.from_numpy(lab),
                        n_tokens=t, left_pad=left_pad)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.positions.numpy(),
                                  np.asarray(ref.positions))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(ref.labels))
    np.testing.assert_array_equal(got.embeds.numpy(), np.asarray(ref.embeds))
    assert got.labels.dtype == torch.int32
    assert got.positions.dtype == torch.int32
    assert splice.output_len(10, 2, t) == jsplice.output_len(10, 2, t)
