"""Port parity for stage (a)'s data: the stage-(a) half of
opus_pllm_tpu_torch.data.datasets, data.precompute, models.esm2's
residue_embeddings and models.opus' CSTP embeddings against the JAX
package, tiny configs in fp32, on temporary files.

Tolerances: embeddings rtol / atol 1e-5 (fp32 op order through two ESM2
or decoder layers); everything host-side (datasets, captions, the
histogram, the pickles' keys, order and dtypes) exactly.
"""

import csv
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opus_pllm_tpu.core.config import DecoderConfig as JDecoderConfig
from opus_pllm_tpu.core.config import ESM2Config as JESM2Config
from opus_pllm_tpu.core.config import OpusConfig as JOpusConfig
from opus_pllm_tpu.data import datasets as jds
from opus_pllm_tpu.data import precompute as jpre
from opus_pllm_tpu.infer.tokenization import ByteTokenizer as JByteTokenizer
from opus_pllm_tpu.models import decoder as jdec
from opus_pllm_tpu.models import esm2 as jesm2
from opus_pllm_tpu.models import opus as jopus
from opus_pllm_tpu_torch.core import convert
from opus_pllm_tpu_torch.core.config import (DecoderConfig, ESM2Config,
                                             OpusConfig)
from opus_pllm_tpu_torch.data import datasets, precompute
from opus_pllm_tpu_torch.infer.tokenization import ByteTokenizer
from opus_pllm_tpu_torch.models import esm2, opus

TOL = dict(rtol=1e-5, atol=1e-5)
AA = "ACDEFGHIKLMNPQRSTVWY"


def _records(n=5, seed=0):
    """UniProt records of 10-40 residues with list and scalar fields; one
    duplicated sequence and one over the 2500-residue cut."""
    rng = np.random.default_rng(seed)
    recs = {}
    for i in range(n):
        seq = "".join(rng.choice(list(AA), int(rng.integers(10, 41))))
        recs[f"P{i}"] = {"Sequence": seq, "Name": [f"Prot. {i}", "alt"],
                         "Accession": [f"P{i}.1"],
                         "Similarity": f"Belongs to family {i}.",
                         "Subcellular_Location": "Nucleus."}
    recs["DUP"] = dict(recs["P0"], Name="Dup. name")
    recs["LONG"] = dict(recs["P1"], Sequence="M" * 2501)
    return recs


@pytest.fixture(scope="module")
def towers():
    """A tiny ESM2 and a tiny llama from JAX keys, in both packages."""
    jecfg, jlcfg = JESM2Config.tiny(), JDecoderConfig.tiny()
    je = jesm2.init(jax.random.PRNGKey(0), jecfg)
    jl = jdec.init(jax.random.PRNGKey(1), jlcfg)
    te = convert.esm2_from_jax(jax.tree.map(np.asarray, je), device="cpu")
    tl = convert.decoder_from_jax(jax.tree.map(np.asarray, jl), device="cpu")
    return (jecfg, je, ESM2Config.tiny(), te,
            jlcfg, jl, DecoderConfig.tiny(), tl)


def test_uniprot_datasets_match_jax(tmp_path):
    path = tmp_path / "uniprot.pkl"
    path.write_bytes(pickle.dumps(_records()))
    got, ref = datasets.UniProtQADataset(str(path)), \
        jds.UniProtQADataset(str(path))
    assert len(got) == len(ref) == 6 and got.pairs == ref.pairs
    assert got[0]["text"] == (
        "The name of protein is Prot 0, alt . Accession: P01 . Similarity: "
        "Belongs to family 0 . Subcellular_Location: Nucleus. ")
    rec = {"Sequence": "MK", "Name": "x"}
    assert datasets.uniprot_text(rec) == jds.uniprot_text(rec)
    pairs = [{"seq_embedding": np.arange(3, dtype=np.float64) + i,
              "text_embedding": [float(i)] * 4} for i in range(3)]
    vec = tmp_path / "pairs.pkl"
    vec.write_bytes(pickle.dumps(pairs))
    for a, b in zip(datasets.UniProtQAVecDataset(str(vec)).arrays(),
                    jds.UniProtQAVecDataset(str(vec)).arrays()):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    item = datasets.UniProtQAVecDataset(str(vec))[1]
    np.testing.assert_array_equal(item["seq_embedding"],
                                  pairs[1]["seq_embedding"])
    plain = datasets.PickleDataset(str(vec))
    assert len(plain) == len(jds.PickleDataset(str(vec))) == 3
    splits = {"train": [{"seq": "MK", "seq_embedding": [1.0, 2.0],
                         "label": 3}]}
    lab = tmp_path / "ec.pkl"
    lab.write_bytes(pickle.dumps(splits))
    a = datasets.LabeledEmbeddingDataset(str(lab), "train")[0]
    b = jds.LabeledEmbeddingDataset(str(lab), "train")[0]
    assert a[0] == b[0] and a[2] == b[2]
    np.testing.assert_array_equal(a[1], b[1])


def test_fitness_dataset_and_histogram_match_jax(tmp_path):
    path = tmp_path / "fit.csv"
    rows = [("MKV", "train", "False", "1.5"), ("MKVL", "train", "True", "2.0"),
            ("M" * 12, "test", "False", "-1.0"), ("MK", "train", "", "0.5")]
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sequence", "set", "validation", "target",
                    "seq_embedding"])
        for seq, split, val, y in rows:
            w.writerow([seq, split, val, y, json.dumps([len(seq), 1.0])])
    assert datasets.FITNESS_LABELS == jds.FITNESS_LABELS
    for kw in ({"split": "train"}, {"split": "validation"},
               {"split": "test", "max_seq_len": 10},
               {"split": "train", "normalize": (0.0, 4.0)},
               {"split": "train", "has_embedding": False}):
        got = datasets.FitnessDataset(str(path), **kw)
        ref = jds.FitnessDataset(str(path), **kw)
        assert len(got) == len(ref)
        for i in range(len(got)):
            for a, b in zip(got[i], ref[i]):
                np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        datasets.FitnessDataset(str(path), split="dev")
    seqs = ["M" * n for n in (0, 249, 250, 2600, 5000)]
    assert datasets.length_histogram(seqs) == jds.length_histogram(seqs)


def test_embed_sequences_matches_jax(towers):
    """Dedup, the length sort, the max_len skip and 16-bucket batches of
    2: the same {sequence: embedding} table."""
    jecfg, je, tecfg, te = towers[:4]
    recs = _records()
    seqs = [r["Sequence"] for r in recs.values() if len(r["Sequence"]) < 2500]
    seqs.append("A" * 30)                                # over max_len 28
    ref = jpre.embed_sequences(je, jecfg, seqs, batch_size=2, len_bucket=16,
                               max_len=28)
    got = precompute.embed_sequences(te, tecfg, seqs, batch_size=2,
                                     len_bucket=16, max_len=28, device="cpu")
    assert list(got) == list(ref)
    for k in ref:
        assert got[k].dtype == np.float32 and got[k].shape == (64,)
        np.testing.assert_allclose(got[k], ref[k], **TOL)


def test_instruction_embeddings_and_sequence_map(towers, tmp_path):
    jecfg, je, tecfg, te = towers[:4]
    items = [{"instruction": "What?", "input": "MKTAYIAKQR", "output": "x"},
             {"instruction": "What?", "input": "", "output": "skip"},
             {"instruction": "Why?", "input": "ACDEFGHIK" * 3, "output": "y"}]
    src = tmp_path / "items.json"
    src.write_text(json.dumps(items))
    for pkg, params, cfg, kw in ((jpre, je, jecfg, {}),
                                 (precompute, te, tecfg, {"device": "cpu"})):
        tag = pkg.__name__.split(".")[0]
        n = pkg.precompute_instruction_embeddings(
            params, cfg, str(src), str(tmp_path / f"{tag}.jsonl"),
            batch_size=2, len_bucket=16, **kw)
        m = pkg.precompute_sequence_map(
            params, cfg, str(src), str(tmp_path / f"{tag}.json"),
            batch_size=2, len_bucket=16, **kw)
        assert (n, m) == (2, 2)
    lines = [[json.loads(x) for x in open(tmp_path / f"{t}.jsonl")]
             for t in ("opus_pllm_tpu_torch", "opus_pllm_tpu")]
    for a, b in zip(*lines):
        assert {k: v for k, v in a.items() if k != "input_embed"} == \
            {k: v for k, v in b.items() if k != "input_embed"}
        np.testing.assert_allclose(a["input_embed"], b["input_embed"], **TOL)
    maps = [json.load(open(tmp_path / f"{t}.json"))
            for t in ("opus_pllm_tpu_torch", "opus_pllm_tpu")]
    assert list(maps[0]) == list(maps[1])
    for k in maps[1]:
        np.testing.assert_allclose(maps[0][k], maps[1][k], **TOL)


@pytest.mark.parametrize("mask_pad", [False, True])
def test_precompute_cstp_pairs_matches_jax(towers, tmp_path, mask_pad):
    """The same records through both packages' precompute_cstp_pairs: the
    pickles hold the same fp32 pairs in the same order, and each package's
    UniProtQAVecDataset reads the other's pickle."""
    jecfg, je, tecfg, te, jlcfg, jl, tlcfg, tl = towers
    up = tmp_path / "uniprot.pkl"
    up.write_bytes(pickle.dumps(_records()))
    paths = {t: tmp_path / f"{t}.pkl" for t in ("jax", "torch")}
    kw = dict(batch_size=4, len_bucket=64, max_text_len=100,
              mask_pad=mask_pad)
    n_ref = jpre.precompute_cstp_pairs(je, jecfg, jl, jlcfg,
                                       JByteTokenizer(), str(up),
                                       str(paths["jax"]), **kw)
    stats = {}
    n = precompute.precompute_cstp_pairs(te, tecfg, tl, tlcfg,
                                         ByteTokenizer(), str(up),
                                         str(paths["torch"]), device="cpu",
                                         stats=stats, **kw)
    assert n == n_ref == 6
    assert set(stats) == {"esm_seconds", "text_seconds"}
    assert all(v >= 0.0 for v in stats.values())
    ref, got = (pickle.loads(paths[t].read_bytes()) for t in ("jax", "torch"))
    for a, b in zip(got, ref):
        assert set(a) == set(b) == {"seq_embedding", "text_embedding"}
        for k in a:
            assert isinstance(a[k], np.ndarray) and a[k].dtype == np.float32
            assert a[k].shape == b[k].shape
            np.testing.assert_allclose(a[k], b[k], **TOL)
    for mine, theirs in ((datasets, paths["jax"]), (jds, paths["torch"])):
        se, txt = mine.UniProtQAVecDataset(str(theirs)).arrays()
        assert se.shape == (6, 64) and txt.shape == (6, 64)
        assert np.isfinite(se).all() and np.isfinite(txt).all()


def test_residue_and_cstp_embeddings_match_jax():
    """esm2.residue_embeddings, opus.protein_cstp_embeddings and
    opus.text_cstp_embeddings (text dim = the LLM's hidden size) on the
    JAX model's weights."""
    import dataclasses
    jcfg = JOpusConfig.tiny("llama")
    jcfg = dataclasses.replace(jcfg, cstp=dataclasses.replace(
        jcfg.cstp, text_dim=jcfg.llm.hidden_size))
    tcfg = OpusConfig.tiny("llama")
    tcfg = dataclasses.replace(tcfg, cstp=dataclasses.replace(
        tcfg.cstp, text_dim=tcfg.llm.hidden_size))
    jp = jopus.init(jax.random.PRNGKey(2), jcfg)
    tp = convert.from_jax(jax.tree.map(np.asarray, jp), device="cpu")
    toks, _ = esm2.tokenize(["MKTAYIAKQR", "ACDEF"], max_len=16)
    reps, res = esm2.residue_embeddings(tp["esm"], tcfg.esm,
                                        torch.from_numpy(toks))
    jreps, jres = jesm2.residue_embeddings(jp["esm"], jcfg.esm,
                                           jnp.asarray(toks))
    np.testing.assert_array_equal(res.numpy(), np.asarray(jres))
    np.testing.assert_allclose(reps.numpy(), np.asarray(jreps), **TOL)
    np.testing.assert_allclose(
        opus.protein_cstp_embeddings(tp, tcfg, torch.from_numpy(toks)).numpy(),
        np.asarray(jopus.protein_cstp_embeddings(jp, jcfg,
                                                 jnp.asarray(toks))), **TOL)
    ids = np.random.default_rng(3).integers(3, 256, (2, 10)).astype(np.int32)
    am = np.ones((2, 10), bool)
    am[1, 6:] = False
    for mask_pad in (True, False):
        np.testing.assert_allclose(
            opus.text_cstp_embeddings(tp, tcfg, torch.from_numpy(ids),
                                      torch.from_numpy(am),
                                      mask_pad=mask_pad).numpy(),
            np.asarray(jopus.text_cstp_embeddings(
                jp, jcfg, jnp.asarray(ids), jnp.asarray(am),
                mask_pad=mask_pad)), **TOL)
