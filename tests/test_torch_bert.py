"""Port parity for the BERTScore encoder and the scored runners:
opus_pllm_tpu_torch.models.bert vs the JAX `models/bert.py` on the same
weights (`BertConfig.tiny()` drawn by the JAX `init`, carried over by
`convert.bert_from_jax`), then the port's two annotate runners, whose
`EvalReport.metrics` must be what the JAX `compute_metrics` gives on their
results.

Tolerance: 1e-5 absolute in fp32 for the encoder's hidden states and for
BERTScore (summation order only: both sides multiply in full fp32);
everything else in the metrics dict is equal.
"""

import dataclasses
import string

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core.config import BertConfig as JBertConfig
from opus_pllm_tpu.evals import metrics as jm
from opus_pllm_tpu.evals import textproc as jtp
from opus_pllm_tpu.models import bert as jbert
from opus_pllm_tpu_torch.core import config, convert
from opus_pllm_tpu_torch.evals import metrics as tm
from opus_pllm_tpu_torch.evals import runner
from opus_pllm_tpu_torch.evals import textproc as ttp
from opus_pllm_tpu_torch.evals.datasets import AnnotationExample
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.models import bert, opus

ATOL = 1e-5


@pytest.fixture(scope="module")
def berts():
    cfg = JBertConfig.tiny()
    jp = jbert.init(jax.random.PRNGKey(0), cfg)
    tp = convert.bert_from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    return jp, tp


def test_bert_config_matches_jax():
    for a, b in ((config.BertConfig(), JBertConfig()),
                 (config.BertConfig.tiny(), JBertConfig.tiny())):
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert config.BertConfig().torch_dtype == torch.float32


def test_init_matches_the_jax_tree_layout():
    cfg = config.BertConfig.tiny()
    tp = bert.init(cfg, generator=torch.Generator().manual_seed(0),
                   device="cpu")
    jp = jbert.init(jax.random.PRNGKey(0), JBertConfig.tiny())
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(jax.tree.map(np.asarray, jp)) == shapes(
        jax.tree.map(lambda t: t.numpy(), tp))


def test_encode_matches_jax(berts):
    """Padding rows included: a ragged row, a row of one token, and the
    token-type ids given on one call."""
    jp, tp = berts
    cfg = config.BertConfig.tiny()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, cfg.vocab_size, (3, 21))
    mask = np.ones((3, 21), bool)
    mask[1, 13:] = False
    mask[2, 1:] = False
    types = (rng.random((3, 21)) < 0.5).astype(np.int64)
    for tt in (None, types):
        want = jbert.encode(jp, JBertConfig.tiny(), jnp.asarray(ids),
                            jnp.asarray(mask),
                            None if tt is None else jnp.asarray(tt))
        got = bert.encode(tp, cfg, torch.from_numpy(ids),
                          torch.from_numpy(mask),
                          None if tt is None else torch.from_numpy(tt))
        assert got.shape == (3, 21, cfg.hidden_size)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


def _vocab():
    """[PAD]/[UNK]/[CLS]/[SEP], lowercase letters, digits and a few
    punctuation marks with their ## forms: under the tiny vocab's 128."""
    chars = string.ascii_lowercase + string.digits + ".,;-"
    toks = ["[PAD]", "[UNK]", "[CLS]", "[SEP]"] + list(chars) + [
        "##" + c for c in chars]
    return {t: i for i, t in enumerate(toks)}


TEXTS = ["Catalyzes the hydrolysis of ATP.", "",
         "Forms a channel; conducts K+ ions\nacross the membrane.",
         "x" * 90, "Acts as a chaperone, 3.4.21.4"]


def _embed_fns(berts, batch_size=2, max_tokens=500):
    jp, tp = berts
    tfn = bert.make_embed_fn(tp, config.BertConfig.tiny(),
                             ttp.WordPieceTokenizer(_vocab(), lowercase=True),
                             batch_size=batch_size, max_tokens=max_tokens,
                             len_bucket=16)
    jfn = jbert.make_embed_fn(jp, JBertConfig.tiny(),
                              jtp.WordPieceTokenizer(_vocab(),
                                                     lowercase=True),
                              batch_size=batch_size, max_tokens=max_tokens,
                              len_bucket=16)
    return tfn, jfn


@pytest.mark.parametrize("batch_size,max_tokens", [(2, 500), (8, 40)])
def test_make_embed_fn_matches_jax(berts, batch_size, max_tokens):
    """Batches of unequal bucketed lengths, an empty text, a text cut at
    `max_tokens` WordPieces; CLS/SEP masked out."""
    tfn, jfn = _embed_fns(berts, batch_size, max_tokens)
    te, tmask = tfn(TEXTS)
    je, jmask = jfn(TEXTS)
    assert isinstance(te, np.ndarray) and te.dtype == np.float32
    np.testing.assert_array_equal(tmask, jmask)
    assert te.shape == je.shape
    np.testing.assert_allclose(te, je, rtol=0, atol=ATOL)
    assert not tmask[1].any() and tmask[0].sum() > 0


def _close_metrics(got, want):
    """Equal, BERTScore within ATOL."""
    got, want = dict(got), dict(want)
    gb, wb = got.pop("BERTScore", None), want.pop("BERTScore", None)
    assert got == want
    assert (gb is None) == (wb is None)
    if gb is not None:
        assert set(gb) == set(wb)
        for k in gb:
            assert abs(gb[k] - wb[k]) <= ATOL


def test_function_metrics_with_bertscore_match_jax(berts):
    tfn, jfn = _embed_fns(berts)
    results = [{"generated": g, "ground_truth": r} for g, r in
               zip(TEXTS, TEXTS[1:] + TEXTS[:1])]
    results.append({"generated": TEXTS[0], "ground_truth": TEXTS[0]})
    name = "OPI_UniProtSeq_function_test_unique.json"
    got = tm.compute_metrics(results, name, bert_embed_fn=tfn)
    want = jm.compute_metrics(results, name, bert_embed_fn=jfn)
    _close_metrics(got, want)
    assert got["BERTScore"] is not None
    # unrounded, and a text against itself scores 1
    pe, pm = tfn([r["generated"] for r in results])
    re_, rm = tfn([r["ground_truth"] for r in results])
    jpe, jpm = jfn([r["generated"] for r in results])
    jre, jrm = jfn([r["ground_truth"] for r in results])
    raw = tm.bertscore_from_embeddings(pe, pm, re_, rm)
    jraw = jm.bertscore_from_embeddings(jpe, jpm, jre, jrm)
    for k in raw:
        assert abs(raw[k] - jraw[k]) <= ATOL
    same = tm.bertscore_from_embeddings(pe[-1:], pm[-1:], re_[-1:], rm[-1:])
    assert abs(same["f1"] - 1.0) <= ATOL


# ---------------------------------------------------------------------------
# The runners return the metrics
# ---------------------------------------------------------------------------

def _opus_cfg():
    c = config.OpusConfig.tiny("llama")
    return dataclasses.replace(
        c, esm=config.ESM2Config(num_layers=1, embed_dim=128, num_heads=2),
        cstp=dataclasses.replace(c.cstp, protein_dim=128))


@pytest.fixture(scope="module")
def opus_params():
    return opus.init(_opus_cfg(), generator=torch.Generator().manual_seed(0),
                     device="cpu")


GROUND_TRUTH = {
    "OPI_UniProtSeq_keywords_test_unique.json": "hydrolase; zinc",
    "OPI_localization_test.json": "Nucleus",
    "OPI_UniProtSeq_function_test_unique.json":
        "Catalyzes the hydrolysis of ATP.",
    "evol_mcq_test.json": "B",
}


def _annotation_examples(name):
    rng = np.random.default_rng(0)
    aa = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    return [AnnotationExample("What does this protein do?",
                              "".join(rng.choice(aa, int(k))),
                              GROUND_TRUTH[name])
            for k in rng.integers(5, 30, 5)]


@pytest.mark.parametrize("path", ["static", "engine"])
@pytest.mark.parametrize("name", list(GROUND_TRUTH))
def test_runners_return_the_jax_metrics(opus_params, berts, path, name):
    """Both runners score their results after the timed window, as the JAX
    runners do (runner.py:236-245, :430-440); BERTScore through
    `bert_embed_fn` on the function set, {} on an MCQ name."""
    tfn, jfn = _embed_fns(berts)
    gen = config.GenerationConfig(max_new_tokens=6, eos_token_id=2,
                                  pad_token_id=0)
    logged = []
    kw = dict(gen=gen, examples=_annotation_examples(name),
              bert_embed_fn=tfn, log_fn=logged.append)
    if path == "static":
        rep = runner.run_annotation_eval(
            opus_params, _opus_cfg(), ByteTokenizer(), name, batch_size=2,
            prompt_bucket=32, esm_bucket=32, **kw)
    else:
        rep = runner.run_annotation_eval_engine(
            opus_params, _opus_cfg(), ByteTokenizer(), name, max_slots=2,
            steps_per_tick=2, splice_batch=2, prompt_bucket=32,
            esm_bucket=32, **kw)
    assert len(rep.results) == 5
    want = jm.compute_metrics(rep.results, name, bert_embed_fn=jfn)
    _close_metrics(rep.metrics, want)
    assert str(rep.metrics) in logged
    if "mcq" in name:
        assert rep.metrics == {}
    else:
        assert rep.metrics
