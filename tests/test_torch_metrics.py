"""Port parity for the annotate scorers: opus_pllm_tpu_torch.evals.metrics,
.textproc and .wordnet vs the JAX package's modules of the same names, on
the same inputs made from a seed with numpy.

`compute_metrics` must return equal dicts (the same rounded floats, the
same keys) under each of the 17 benchmark JSON file names (BASELINE.md:
20-24) and {} under an MCQ name; METEOR and the stemmer agree with nltk's
stemmer and with `porter_stem` forced on both sides, with no synonyms and
with the WNdb mini-fixture; BERTScore from the same numpy embeddings is
equal to the bit. No tolerance: both sides run the same numpy code.
"""

import os

import numpy as np
import pytest

from opus_pllm_tpu.evals import metrics as jm
from opus_pllm_tpu.evals import textproc as jtp
from opus_pllm_tpu.evals import wordnet as jwn
from opus_pllm_tpu_torch.evals import metrics as tm
from opus_pllm_tpu_torch.evals import textproc as ttp
from opus_pllm_tpu_torch.evals import wordnet as twn

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "mini_wordnet")

BENCHMARK_FILES = (
    "OPI_localization_test.json", "test_localization.json",
    "uniprot2024_localization_test_less2500.json",
    "OPI_CASPSimilarGO_Test_unique.json", "OPI_IDFilterGO_Test_unique.json",
    "OPI_UniProtGO_Test_unique.json", "uniprot2024_go_test_less2500.json",
    "OPI_CASPSimilarSeq_keywords_test_unique.json",
    "OPI_IDFilterSeq_keywords_test_unique.json",
    "OPI_UniProtSeq_keywords_test_unique.json",
    "uniprot2024_keywords_test_less2500.json",
    "EC_number_New392_with_Name.json", "EC_number_Price149_with_Name.json",
    "OPI_CASPSimilarSeq_function_test_unique.json",
    "OPI_IDFilterSeq_function_test_unique.json",
    "OPI_UniProtSeq_function_test_unique.json",
    "uniprot2024_function_test_less2500.json",
)

LABELS = ("hydrolase", "zinc", "metal-binding", "transferase",
          "GO:0005524", "ATP-binding", "3.4.21.4", "membrane", "kinase")
WORDS = ("catalyzes", "the", "hydrolysis", "of", "ATP", "to", "drive",
         "transport", "across", "membranes", "forms", "a", "channel",
         "conducts", "potassium", "ions", "acts", "as", "chaperone",
         "folding", "nascent", "polypeptides", "binding", "kinases",
         "phosphorylation", "regulates", "cleavage", "conduit")


def _labels(rng, period):
    k = int(rng.integers(1, 5))
    text = "; ".join(rng.choice(LABELS, k, replace=False))
    return text + "." if period else text


def _sentence(rng, n_min=3):
    words = rng.choice(WORDS, int(rng.integers(n_min, 14)))
    return " ".join(words).capitalize() + "."


def _results(task, seed):
    """Seeded results for one task, with the awkward cases: an empty
    generation, multi-line ones, trailing periods, the `predict` key."""
    rng = np.random.default_rng(seed)
    out = []
    if task == "labels":
        for i in range(12):
            gt = _labels(rng, period=False)
            gen = gt if i % 4 == 0 else _labels(rng, period=bool(i % 2))
            out.append({"generated": gen, "ground_truth": gt})
        out[1]["generated"] = ""
        out[2]["generated"] = out[2]["ground_truth"] + "\nzinc; kinase"
        out[3] = {"predict": "Zinc; Hydrolase..", "ground_truth": "zinc"}
    elif task == "localization":
        locs = list(tm.DEEPLOC_TO_OPI)
        for i in range(14):
            gt = locs[i % len(locs)]
            gen = tm.DEEPLOC_TO_OPI[gt] if i % 3 else str(rng.choice(locs))
            out.append({"generated": gen + ("." if i % 2 else ""),
                        "ground_truth": gt})
        out[4]["generated"] = ""
        out[5]["generated"] = "Nucleus\nIt is found in the nucleus."
    else:
        for i in range(8):
            gt = " ".join(_sentence(rng) for _ in range(2))
            gen = (gt if i == 0 else
                   "\n".join(_sentence(rng) for _ in range(1 + i % 3)))
            out.append({"generated": gen, "ground_truth": gt})
        out[1]["generated"] = ""
        out[2]["generated"] = out[2]["generated"].rstrip(".") + "..."
    return out


@pytest.mark.parametrize("name", BENCHMARK_FILES)
def test_compute_metrics_matches_jax_on_every_benchmark_file(name):
    task = jm.task_of(name)
    results = _results(task, seed=BENCHMARK_FILES.index(name))
    got = tm.compute_metrics(results, name)
    want = jm.compute_metrics(results, name)
    assert got == want
    assert set(got) == {"labels": {"Precision", "Recall", "F1 Score"},
                        "localization": {"Accuracy"},
                        "function": {"ROUGEScore", "BLEU", "METEOR",
                                     "BERTScore"}}[task]


def test_compute_metrics_mcq_name_gives_an_empty_dict():
    results = _results("labels", seed=0)
    assert tm.compute_metrics(results, "evol_mcq_test.json") == {} \
        == jm.compute_metrics(results, "evol_mcq_test.json")
    with pytest.raises(ValueError):
        tm.compute_metrics(results, "unknown.json")


def test_label_vocab_maps_match_jax():
    """DeepLoc ground truths (the full set) and InstructProtein
    generations are renamed to the OPI vocabulary the same way."""
    results = _results("localization", seed=1)
    assert tm.normalize_label_vocab(results) == \
        jm.normalize_label_vocab(results)
    inst = [{"generated": k, "ground_truth": v} for k, v in
            tm.INSTRUCTPROTEIN_TO_OPI.items()]
    for name in ("test_localization.json", "uniprot2024_go_test.json"):
        got = tm.compute_metrics(inst, name, input_model="InstructProtein")
        assert got == jm.compute_metrics(inst, name,
                                         input_model="InstructProtein")
    assert got["F1 Score"] == 1.0


def _function_pairs(seed=3):
    res = _results("function", seed)
    return [r["generated"] for r in res], [r["ground_truth"] for r in res]


@pytest.mark.parametrize("synonyms", ["none", "wordnet"])
def test_meteor_matches_jax(synonyms):
    preds, refs = _function_pairs()
    preds += ["the cleavage of the substrate", "forms a conduit"]
    refs += ["the hydrolysis of the substrate", "forms a channel"]
    ts = twn.WordNetSynonyms(FIXTURE) if synonyms == "wordnet" else None
    js = jwn.WordNetSynonyms(FIXTURE) if synonyms == "wordnet" else None
    got = tm.meteor_corpus(preds, refs, synonyms=ts)
    assert got == jm.meteor_corpus(preds, refs, synonyms=js)
    for p, r in zip(preds, refs):
        assert tm.meteor_pair(p, r, synonyms=ts) == \
            jm.meteor_pair(p, r, synonyms=js)
    if synonyms == "wordnet":
        assert got > tm.meteor_corpus(preds, refs, synonyms=None)
        assert ts.synonyms("hydrolysis") == js.synonyms("hydrolysis")


@pytest.mark.parametrize("stemmer", ["default", "porter_stem"])
def test_stemmer_and_meteor_match_jax(monkeypatch, stemmer):
    """The default stemmer (nltk's where it imports) and `porter_stem`
    forced on both sides."""
    if stemmer == "porter_stem":
        monkeypatch.setattr(tm, "stem", ttp.porter_stem)
        monkeypatch.setattr(jm, "stem", jtp.porter_stem)
    words = sorted(set(" ".join(_function_pairs()[1]).lower().split())) + [
        "relational", "conditional", "hopping", "caresses", "ponies",
        "agreed", "generalization", "happy", "sky", "electricity"]
    for w in words:
        assert tm.stem(w) == jm.stem(w)
    assert (ttp.stem is ttp.porter_stem) == (jtp.stem is jtp.porter_stem)
    preds, refs = _function_pairs(seed=4)
    assert tm.meteor_corpus(preds, refs) == jm.meteor_corpus(preds, refs)


def test_rouge_bleu_and_tokenizers_match_jax():
    preds, refs = _function_pairs(seed=5)
    text = "A-b, 3.5 &amp; x-\ny (z) e.g. 1,000\nsecond line. Third!"
    assert ttp.tokenize_13a(text) == jtp.tokenize_13a(text)
    assert ttp.tokenize_rouge(text) == jtp.tokenize_rouge(text)
    assert ttp.split_sentences(text) == jtp.split_sentences(text)
    for agg in ("mean", "bootstrap_mid"):
        assert tm.rouge_corpus(preds, refs, agg) == \
            jm.rouge_corpus(preds, refs, agg)
    assert tm.bleu_corpus(preds, refs) == jm.bleu_corpus(preds, refs)
    assert tm.bleu_corpus(preds, refs, smooth=True) == \
        jm.bleu_corpus(preds, refs, smooth=True)


def test_wordpiece_tokenizer_matches_jax():
    vocab = {t: i for i, t in enumerate(
        ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "cat", "##aly", "##zes", "the",
         "hydro", "##lysis", "of", "AT", "##P", ".", ",", "-"])}
    text = "Catalyzes the hydrolysis of ATP, the-cat. Unknownword"
    for lower in (False, True):
        t = ttp.WordPieceTokenizer(vocab, lowercase=lower)
        j = jtp.WordPieceTokenizer(vocab, lowercase=lower)
        assert t.tokenize(text) == j.tokenize(text)
        assert t.encode(text, max_tokens=5) == j.encode(text, max_tokens=5)
        assert t.encode(text) == j.encode(text)


def test_bertscore_from_embeddings_matches_jax():
    """Seeded (B, L, D) embeddings and masks, one pair with an empty
    side."""
    rng = np.random.default_rng(6)
    pe = rng.standard_normal((5, 11, 16)).astype(np.float32)
    re_ = rng.standard_normal((5, 9, 16)).astype(np.float32)
    pm = rng.random((5, 11)) < 0.7
    rm = rng.random((5, 9)) < 0.7
    pm[2] = False
    got = tm.bertscore_from_embeddings(pe, pm, re_, rm)
    assert got == jm.bertscore_from_embeddings(pe, pm, re_, rm)
    same = tm.bertscore_from_embeddings(pe, pm | True, pe, pm | True)
    assert abs(same["f1"] - 1.0) < 1e-6
