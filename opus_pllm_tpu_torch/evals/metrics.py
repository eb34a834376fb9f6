"""Task metrics for the 18 benchmark test sets (port of
`opus_pllm_tpu/evals/metrics.py`, copied: numpy only, no torch).

Native re-implementations of everything the reference computes through
sklearn + vendored HuggingFace `evaluate` modules
(eval/metrics_computing_opi.py, eval/metrics/{bleu,rouge,bertscore,meteor}):

  * label-set tasks (EC number / GO / keywords): per-sample micro
    precision/recall/F1 over `;`-split lowercase label sets, averaged over
    samples (metrics_computing_opi.py:24-35,96-122)
  * localization: per-sample exact-set-match accuracy (sklearn's
    accuracy_score on a single-row MultiLabelBinarizer matrix reduces to
    set equality, metrics_computing_opi.py:29-31,109-114)
  * function description: corpus ROUGE-1/2/L/Lsum, BLEU (mteval-13a,
    4-gram, corpus-level), METEOR (exact+stem matching; WordNet synonyms
    used when the corpus is available), BERTScore from any
    `bert_embed_fn`, such as `models.bert.make_embed_fn` over BioBERT
    (truncated to 500 WordPiece tokens)
  * label-vocabulary normalization DeepLoc->OPI and InstructProtein->OPI
    (metrics_computing_opi.py:162-203)

Metric dispatch is by dataset-filename keyword, as in the reference
(README.md:82); an MCQ file name gives {}.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .textproc import (split_sentences, stem, tokenize_13a, tokenize_rouge)

# ---------------------------------------------------------------------------
# Label-set tasks
# ---------------------------------------------------------------------------


def parse_label_list(text, *, strip_trailing_period: bool) -> List[str]:
    """';'-split, lowercase, whitespace-strip (process_data semantics:
    generated text gets `.strip('.')` first, ground truth does not)."""
    if isinstance(text, list):
        return [str(t).lower().strip() for t in text]
    if strip_trailing_period:
        text = text.strip(".")
    return [t.lower().strip() for t in text.split(";")]


def parse_first_line(text) -> List[str]:
    """function/localization: first line, lowercase, strip periods."""
    if isinstance(text, list):
        return [str(t).lower().strip(".") for t in text]
    return [text.split("\n")[0].lower().strip(".")]


def label_set_metrics(pred: Sequence[str], target: Sequence[str]
                      ) -> Tuple[float, float, float, float]:
    """(exact-set accuracy, micro precision, recall, F1) for ONE sample.

    Micro counts over the union label space: TP = |pred ∩ target| (as sets,
    duplicates collapse — MultiLabelBinarizer semantics)."""
    ps, ts = set(pred), set(target)
    tp = len(ps & ts)
    prec = tp / len(ps) if ps else 0.0
    rec = tp / len(ts) if ts else 0.0
    f1 = 2 * prec * rec / (prec + rec) if prec + rec > 0 else 0.0
    return float(ps == ts), prec, rec, f1


# ---------------------------------------------------------------------------
# ROUGE
# ---------------------------------------------------------------------------


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def _f1(p: float, r: float) -> float:
    return 2 * p * r / (p + r) if p + r > 0 else 0.0


def rouge_n_pair(pred: str, ref: str, n: int) -> float:
    pt, rt = tokenize_rouge(pred), tokenize_rouge(ref)
    pg, rg = _ngrams(pt, n), _ngrams(rt, n)
    overlap = sum((pg & rg).values())
    p = overlap / max(sum(pg.values()), 1)
    r = overlap / max(sum(rg.values()), 1)
    return _f1(p, r)


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(prev[j + 1], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l_pair(pred: str, ref: str) -> float:
    pt, rt = tokenize_rouge(pred), tokenize_rouge(ref)
    lcs = _lcs_len(pt, rt)
    p = lcs / max(len(pt), 1)
    r = lcs / max(len(rt), 1)
    return _f1(p, r)


def _union_lcs(ref_sent: Sequence[str], pred_sents: List[List[str]]) -> set:
    """Positions of ref tokens hit by the LCS with any predicted sentence
    (rouge_score union-LCS for ROUGE-Lsum)."""
    hits = set()
    for ps in pred_sents:
        # recover one LCS alignment via DP backtrack
        la, lb = len(ref_sent), len(ps)
        dp = np.zeros((la + 1, lb + 1), dtype=np.int32)
        for i in range(la):
            for j in range(lb):
                dp[i + 1][j + 1] = (dp[i][j] + 1 if ref_sent[i] == ps[j]
                                    else max(dp[i][j + 1], dp[i + 1][j]))
        i, j = la, lb
        while i > 0 and j > 0:
            if ref_sent[i - 1] == ps[j - 1] and dp[i][j] == dp[i - 1][j - 1] + 1:
                hits.add(i - 1)
                i, j = i - 1, j - 1
            elif dp[i - 1][j] >= dp[i][j - 1]:
                i -= 1
            else:
                j -= 1
    return hits


def rouge_lsum_pair(pred: str, ref: str) -> float:
    ps = [tokenize_rouge(s) for s in split_sentences(pred)]
    rs = [tokenize_rouge(s) for s in split_sentences(ref)]
    m = sum(len(s) for s in rs)
    n = sum(len(s) for s in ps)
    if m == 0 or n == 0:
        return 0.0
    union = sum(len(_union_lcs(r, ps)) for r in rs)
    return _f1(union / n, union / m)


def rouge_corpus(preds: Sequence[str], refs: Sequence[str],
                 aggregator: str = "mean",
                 seed: int = 0) -> Dict[str, float]:
    """Per-pair ROUGE aggregated over the corpus.

    aggregator="mean" (default): exact means. "bootstrap_mid": the
    reference's BootstrapAggregator `mid` (rouge_scorer scoring.py via
    its vendored rouge metric) — 1000 seeded resamples of the per-pair
    scores, median of the resample means. The two agree to O(sigma/sqrt
    (n)); the divergence is quantified on the function-set fixture in
    tests/test_metrics_wordnet.py and recorded in BENCH_NOTES.md."""
    r1 = [rouge_n_pair(p, r, 1) for p, r in zip(preds, refs)]
    r2 = [rouge_n_pair(p, r, 2) for p, r in zip(preds, refs)]
    rl = [rouge_l_pair(p, r) for p, r in zip(preds, refs)]
    rs = [rouge_lsum_pair(p, r) for p, r in zip(preds, refs)]
    if aggregator == "bootstrap_mid":
        rng = np.random.default_rng(seed)

        def agg(xs):
            if not xs:
                return 0.0
            a = np.asarray(xs)
            idx = rng.integers(0, len(a), size=(1000, len(a)))
            return float(np.median(a[idx].mean(axis=1)))
    elif aggregator == "mean":
        agg = lambda xs: float(np.mean(xs)) if xs else 0.0
    else:
        raise ValueError(f"aggregator must be mean/bootstrap_mid, "
                         f"got {aggregator!r}")
    return {"rouge1": agg(r1), "rouge2": agg(r2), "rougeL": agg(rl),
            "rougeLsum": agg(rs)}


# ---------------------------------------------------------------------------
# BLEU (corpus-level, mteval-13a tokenizer, 4-gram, brevity penalty)
# ---------------------------------------------------------------------------


def bleu_corpus(preds: Sequence[str], refs: Sequence[str],
                max_order: int = 4, smooth: bool = False) -> float:
    matches = [0] * max_order
    possible = [0] * max_order
    pred_len = ref_len = 0
    for p, r in zip(preds, refs):
        pt, rt = tokenize_13a(p), tokenize_13a(r)
        pred_len += len(pt)
        ref_len += len(rt)
        for n in range(1, max_order + 1):
            pg, rg = _ngrams(pt, n), _ngrams(rt, n)
            matches[n - 1] += sum((pg & rg).values())
            possible[n - 1] += max(len(pt) - n + 1, 0)
    precisions = []
    for n in range(max_order):
        if smooth:
            precisions.append((matches[n] + 1.0) / (possible[n] + 1.0))
        else:
            precisions.append(matches[n] / possible[n] if possible[n] > 0 else 0.0)
    if min(precisions) <= 0:
        return 0.0
    geo = math.exp(sum(math.log(p) for p in precisions) / max_order)
    ratio = pred_len / max(ref_len, 1)
    bp = 1.0 if ratio > 1.0 else math.exp(1 - 1 / ratio) if ratio > 0 else 0.0
    return geo * bp


# ---------------------------------------------------------------------------
# METEOR (exact + stem (+ WordNet synonyms when available); nltk parameters
# alpha=0.9, beta=3, gamma=0.5)
# ---------------------------------------------------------------------------

class _NltkWordNet:
    """nltk-backed synonym source (the reference's own stage-3 matcher,
    meteor.py -> nltk meteor_score); same `synonyms()` contract as
    evals.wordnet.WordNetSynonyms (the no-nltk WNdb-file loader)."""

    def __init__(self, wn):
        self._wn = wn

    def synonyms(self, word: str) -> set:
        syns = {word}
        for ss in self._wn.synsets(word):
            for l in ss.lemmas():
                syns.add(l.name().replace("_", " "))
        return syns


try:  # wordnet needs its corpus on disk; degrade to exact+stem without it
    from nltk.corpus import wordnet as _wn
    _wn.synsets("protein")
    _DEFAULT_SYNONYMS = _NltkWordNet(_wn)
except Exception:  # pragma: no cover
    _DEFAULT_SYNONYMS = None
_HAVE_WORDNET = _DEFAULT_SYNONYMS is not None


def _meteor_align(pred: List[str], ref: List[str],
                  syn=None) -> List[Tuple[int, int]]:
    """Greedy stage-wise alignment: exact, then stem, then synonym
    (`syn`: an object with synonyms(word)->set, or None to skip)."""
    taken_p, taken_r, pairs = set(), set(), []

    def run(match):
        for i, pw in enumerate(pred):
            if i in taken_p:
                continue
            for j, rw in enumerate(ref):
                if j in taken_r:
                    continue
                if match(pw, rw):
                    pairs.append((i, j))
                    taken_p.add(i)
                    taken_r.add(j)
                    break

    run(lambda a, b: a == b)
    run(lambda a, b: stem(a) == stem(b))
    if syn is not None:
        run(lambda a, b: b in syn.synonyms(a) or a in syn.synonyms(b))
    return sorted(pairs)


def meteor_pair(pred: str, ref: str, alpha: float = 0.9, beta: float = 3.0,
                gamma: float = 0.5, synonyms="auto") -> float:
    """synonyms: "auto" = nltk WordNet when its corpus is on disk (the
    reference's matcher), an evals.wordnet.WordNetSynonyms (WNdb files,
    no nltk) or any synonyms(word)->set object, or None for exact+stem
    only. The exact+stem-vs-synonym delta is bounded on the function-set
    fixture in tests/test_metrics_wordnet.py (recorded in
    BENCH_NOTES.md)."""
    syn = _DEFAULT_SYNONYMS if synonyms == "auto" else synonyms
    pt = [w.lower() for w in tokenize_13a(pred)]
    rt = [w.lower() for w in tokenize_13a(ref)]
    pairs = _meteor_align(pt, rt, syn)
    m = len(pairs)
    if m == 0:
        return 0.0
    p = m / len(pt)
    r = m / len(rt)
    fmean = p * r / (alpha * p + (1 - alpha) * r)
    # chunks: contiguous runs in both sequences
    chunks = 1
    for (pi, ri), (pj, rj) in zip(pairs, pairs[1:]):
        if pj != pi + 1 or rj != ri + 1:
            chunks += 1
    frag = chunks / m
    penalty = gamma * frag ** beta
    return fmean * (1 - penalty)


def meteor_corpus(preds: Sequence[str], refs: Sequence[str],
                  synonyms="auto") -> float:
    return float(np.mean([meteor_pair(p, r, synonyms=synonyms)
                          for p, r in zip(preds, refs)])) if preds else 0.0


# ---------------------------------------------------------------------------
# BERTScore (greedy cosine matching over contextual embeddings)
# ---------------------------------------------------------------------------


def bertscore_from_embeddings(pred_emb: np.ndarray, pred_mask: np.ndarray,
                              ref_emb: np.ndarray, ref_mask: np.ndarray
                              ) -> Dict[str, float]:
    """Per-pair BERTScore from (B, L, D) embeddings + bool masks; CLS/SEP
    should already be excluded by the mask. Returns means over the batch."""
    def norm(x):
        return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)

    ps, rs, f1s = [], [], []
    for pe, pm, re_, rm in zip(pred_emb, pred_mask, ref_emb, ref_mask):
        a, b = norm(pe[pm]), norm(re_[rm])
        if len(a) == 0 or len(b) == 0:
            ps.append(0.0); rs.append(0.0); f1s.append(0.0)
            continue
        sim = a @ b.T
        p = float(sim.max(axis=1).mean())
        r = float(sim.max(axis=0).mean())
        ps.append(p); rs.append(r); f1s.append(_f1(p, r))
    return {"precision": float(np.mean(ps)), "recall": float(np.mean(rs)),
            "f1": float(np.mean(f1s))}


# ---------------------------------------------------------------------------
# Label-vocabulary normalization (metrics_computing_opi.py:162-203)
# ---------------------------------------------------------------------------

DEEPLOC_TO_OPI = {
    "Cell.membrane": "membrane", "Cytoplasm": "Cytoplasm",
    "Endoplasmic.reticulum": "reticulum", "Golgi.apparatus": "apparatus",
    "Lysosome/Vacuole": "Lysosome/Vacuole", "Mitochondrion": "Mitochondrion",
    "Nucleus": "Nucleus", "Peroxisome": "Peroxisome", "Plastid": "Plastid",
    "Extracellular": "Extracellular",
}

INSTRUCTPROTEIN_TO_OPI = {
    "plasma membrane": "membrane", "cytoplasm": "Cytoplasm",
    "endoplasmic reticulum": "reticulum", "golgi": "apparatus",
    "vacuole": "Lysosome/Vacuole", "mitochondrion": "Mitochondrion",
    "nucleus": "Nucleus", "peroxisome": "Peroxisome",
    "chloroplast": "Plastid", "extracellular": "Extracellular",
}


def normalize_label_vocab(results: List[dict],
                          input_model: Optional[str] = None) -> List[dict]:
    if input_model == "InstructProtein":
        results = [{**r, "generated": INSTRUCTPROTEIN_TO_OPI.get(
            r["generated"], r["generated"])} for r in results]
    gts = {r["ground_truth"] for r in results
           if isinstance(r.get("ground_truth"), str)}
    if gts == set(DEEPLOC_TO_OPI.keys()):
        results = [{**r, "ground_truth": DEEPLOC_TO_OPI[r["ground_truth"]]}
                   for r in results]
    return results


# ---------------------------------------------------------------------------
# Dispatch (return_opi_metrics equivalent)
# ---------------------------------------------------------------------------

LABEL_TASKS = ("ec_number", "go", "keywords")


def task_of(file_path: str) -> str:
    f = file_path.lower()
    if "function" in f:
        return "function"
    if "localization" in f:
        return "localization"
    if any(k in f for k in LABEL_TASKS):
        return "labels"
    if "choice" in f or "mcq" in f:
        return "mcq"
    raise ValueError(f"cannot infer task from filename: {file_path}")


def compute_metrics(results: List[dict], file_path: str, *,
                    input_model: Optional[str] = None,
                    bert_embed_fn: Optional[Callable] = None) -> Dict:
    """results: [{"generated": str, "ground_truth": str}]; dispatch by
    filename keyword like return_opi_metrics."""
    results = normalize_label_vocab(results, input_model)
    task = task_of(file_path)
    out: Dict = {}
    if task == "labels":
        trip = []
        for r in results:
            pred = parse_label_list(r.get("generated", r.get("predict", "")),
                                    strip_trailing_period=True)
            tgt = parse_label_list(r["ground_truth"], strip_trailing_period=False)
            _, p, rc, f1 = label_set_metrics(pred, tgt)
            trip.append((p, rc, f1))
        arr = np.asarray(trip) if trip else np.zeros((0, 3))
        out.update({"Precision": round(float(arr[:, 0].mean()), 4),
                    "Recall": round(float(arr[:, 1].mean()), 4),
                    "F1 Score": round(float(arr[:, 2].mean()), 4)})
    elif task == "localization":
        accs = []
        for r in results:
            pred = parse_first_line(r.get("generated", r.get("predict", "")))
            tgt = parse_first_line(r["ground_truth"])
            acc, *_ = label_set_metrics(pred, tgt)
            accs.append(acc)
        out["Accuracy"] = round(float(np.mean(accs)) if accs else 0.0, 4)
    elif task == "function":
        preds = [r.get("generated", r.get("predict", "")) for r in results]
        refs = [r["ground_truth"] for r in results]
        rg = rouge_corpus(preds, refs)
        out["ROUGEScore"] = {"rouge1": round(rg["rouge1"], 4),
                             "rouge2": round(rg["rouge2"], 4),
                             "rougel": round(rg["rougeL"], 4),
                             "rougeLsum": round(rg["rougeLsum"], 4)}
        out["BLEU"] = round(bleu_corpus(preds, refs), 4)
        out["METEOR"] = round(meteor_corpus(preds, refs), 4)
        if bert_embed_fn is not None:
            pe, pm = bert_embed_fn(preds)
            re_, rm = bert_embed_fn(refs)
            bs = bertscore_from_embeddings(np.asarray(pe), np.asarray(pm),
                                           np.asarray(re_), np.asarray(rm))
            out["BERTScore"] = {k: round(v, 4) for k, v in bs.items()}
        else:
            out["BERTScore"] = None
    return out
