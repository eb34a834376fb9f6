"""Training datasets (port of `opus_pllm_tpu/data/datasets.py`): stage
(a)'s contrastive pairs and downstream probes (`uniprot_text` :37,
`UniProtQADataset` :49, `UniProtQAVecDataset` :68, `PickleDataset` :90,
`LabeledEmbeddingDataset` :104, `FITNESS_LABELS` :121, `FitnessDataset`
:127, `length_histogram` :196) and stages (c)/(d)'s instruction data
(`InstructionDataset` :170, `batch_iterator` :211). Host-side, numpy only;
the code is the JAX module's.

Behaviour kept from the reference:
  * UniProtQA drops sequences over 2500 aa and renders the caption
    "The name of protein is ... Accession: ... Similarity: ...
    Subcellular_Location: ..." with the periods inside each field removed;
  * FitnessDataset's 'train'/'test' splits exclude validation == True rows,
    and 'validation' is the train rows with validation == True.
"""

from __future__ import annotations

import ast
import json
import pickle
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

REQUIRED_UNIPROT_KEYS = ("Description", "Accession", "Name", "Similarity",
                         "Sequence", "Subcellular_Location")
MAX_SEQ_LEN_CSTP = 2500


def _strip_periods(x) -> str:
    return str(x).replace(".", "")


def uniprot_text(record: Dict) -> str:
    """Render one UniProt record to the CSTP text template."""
    r = {k: record.get(k, "None") for k in REQUIRED_UNIPROT_KEYS}
    name = ", ".join(r["Name"]) if isinstance(r["Name"], (list, tuple)) \
        else r["Name"]
    acc = ", ".join(r["Accession"]) \
        if isinstance(r["Accession"], (list, tuple)) else r["Accession"]
    return (f"The name of protein is {_strip_periods(name)} . "
            f"Accession: {_strip_periods(acc)} . "
            f"Similarity: {_strip_periods(r['Similarity'])} . "
            f"Subcellular_Location: "
            f"{_strip_periods(r['Subcellular_Location'])}. ")


class UniProtQADataset:
    """Pickle of UniProt records -> (sequence, text) pairs."""

    def __init__(self, path: str, max_len: int = MAX_SEQ_LEN_CSTP):
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.pairs: List[Dict[str, str]] = []
        for rec in data.values():
            if len(rec.get("Sequence", "")) > max_len:
                continue
            self.pairs.append({"sequence": rec["Sequence"],
                               "text": uniprot_text(rec)})

    def __len__(self):
        return len(self.pairs)

    def __getitem__(self, i):
        return self.pairs[i]


class UniProtQAVecDataset:
    """Precomputed (seq_embedding, text_embedding) pairs (pickle list)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.items = pickle.load(f)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]

    def arrays(self) -> Tuple[np.ndarray, np.ndarray]:
        se = np.stack([np.asarray(x["seq_embedding"], np.float32)
                       for x in self.items])
        te = np.stack([np.asarray(x["text_embedding"], np.float32)
                       for x in self.items])
        return se, te


class PickleDataset:
    """Plain pickle-list dataset (BinaryLocalization / Subcellularlization)."""

    def __init__(self, path: str):
        with open(path, "rb") as f:
            self.items = pickle.load(f)

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


class LabeledEmbeddingDataset:
    """EC / GO pickle splits -> (seq, seq_embedding, label) triples."""

    def __init__(self, path: str, split_key: str):
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.items = data[split_key]

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        d = self.items[i]
        return d["seq"], np.asarray(d["seq_embedding"], np.float32), \
            d["label"]


# default label column per fitness landscape (reference class defaults)
FITNESS_LABELS = {"aav": "target", "beta_lac": "scaled_effect1",
                  "fluorescence": "log_fluorescence",
                  "stability": "stability_score", "thermo": "z_score_target"}


class FitnessDataset:
    """Fitness-landscape CSV: sequence + precomputed embedding + scalar
    label, one class for AAV / beta-lactamase / fluorescence / stability /
    thermostability; `max_seq_len=3000` for thermostability,
    `normalize=(lo, hi)` for the AAV MaxMin variant."""

    def __init__(self, csv_path: str, split: str = "train",
                 label: str = "target", max_seq_len: Optional[int] = None,
                 normalize: Optional[Tuple[float, float]] = None,
                 has_embedding: bool = True):
        import csv

        with open(csv_path, newline="") as f:
            rows = list(csv.DictReader(f))
        if max_seq_len is not None:
            rows = [r for r in rows if len(r["sequence"]) < max_seq_len]
        is_val = lambda r: str(r.get("validation", "")).lower() == "true"
        if split in ("train", "test"):
            rows = [r for r in rows if r.get("set") == split
                    and not is_val(r)]
        elif split == "validation":
            rows = [r for r in rows if r.get("set") == "train" and is_val(r)]
        else:
            raise ValueError("split must be train/test/validation")
        self.rows = rows
        self.label = label
        self.normalize = normalize
        self.has_embedding = has_embedding

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, i):
        r = self.rows[i]
        target = float(r[self.label])
        if self.normalize is not None:
            lo, hi = self.normalize
            target = (target - lo) / (hi - lo)
        if self.has_embedding and "seq_embedding" in r:
            emb = np.asarray(ast.literal_eval(r["seq_embedding"]),
                             np.float32)
            return r["sequence"], emb, target
        return r["sequence"], target


class InstructionDataset:
    """Instruction-tuning JSON [{instruction, input (an amino-acid
    sequence), output}] for stages (c)/(d); entries without an input are
    dropped. Optionally joined with a precomputed {sequence: embedding}
    map (the pooled-embedding training path)."""

    def __init__(self, path: str, embedding_map_path: Optional[str] = None):
        with open(path) as f:
            self.items = [d for d in json.load(f) if d.get("input")]
        self.embeddings = None
        if embedding_map_path:
            with open(embedding_map_path) as f:
                self.embeddings = {k: np.asarray(v, np.float32)
                                   for k, v in json.load(f).items()}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        d = self.items[i]
        out = {"instruction": d["instruction"], "sequence": d["input"],
               "output": d.get("output", "")}
        if self.embeddings is not None:
            out["seq_embedding"] = self.embeddings.get(d["input"])
        return out


def length_histogram(sequences, bins=(0, 250, 500, 1000, 1500, 2000, 2500,
                                       3000, 4000, 10**9)) -> Dict[str, int]:
    """Sequence-length histogram: counts per [lo, hi) bin."""
    counts = {f"[{bins[i]}, {bins[i+1]})": 0 for i in range(len(bins) - 1)}
    keys = list(counts)
    for s in sequences:
        n = len(s)
        for i in range(len(bins) - 1):
            if bins[i] <= n < bins[i + 1]:
                counts[keys[i]] += 1
                break
    return counts


def batch_iterator(n: int, batch_size: int, *, shuffle: bool = True,
                   drop_remainder: bool = True, seed: int = 0,
                   epochs: int = 1) -> Iterator[np.ndarray]:
    """Index batches; each epoch shuffles with
    np.random.default_rng(seed + epoch), as the JAX function does."""
    for ep in range(epochs):
        idx = np.arange(n)
        if shuffle:
            np.random.default_rng(seed + ep).shuffle(idx)
        end = n - (n % batch_size) if drop_remainder else n
        for s in range(0, end, batch_size):
            yield idx[s:s + batch_size]
