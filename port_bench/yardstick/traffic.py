"""The one generator of every traffic mix under `port_bench/traffic/`.

A mix is a JSON file of parameters. The sizes of a run are fixed by the
mix and its seed only reorders them: protein lengths are the quantiles of
a log-normal (the same multiset in every batch or every seed), residues
and the order are drawn from the seed. So two seeds do the same work in
another order.
"""

from __future__ import annotations

import json
import statistics
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]

# Approximate UniProtKB/Swiss-Prot composition of the 20 standard
# residues, in %
RESIDUES = "ARNDCQEGHILKMFPSTWYV"
FREQ = np.array([8.25, 5.53, 4.06, 5.46, 1.38, 3.93, 6.72, 7.07, 2.27,
                 5.91, 9.64, 5.80, 2.41, 3.86, 4.74, 6.65, 5.36, 1.10,
                 2.92, 6.86])


def load_mix(name: str) -> dict:
    with open(ROOT / "traffic" / f"{name}.json") as f:
        return json.load(f)


def rng(seed: int, *stream: int) -> np.random.Generator:
    """A numpy generator for (seed, stream...); any whole seed."""
    return np.random.default_rng([int(seed) % (2 ** 64), *stream])


def quantile_lengths(n: int, dist: dict) -> np.ndarray:
    """n lengths at the mid-quantiles (i + 1/2) / n of a log-normal with
    the given median and sigma, rounded and clipped to [min, max]."""
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = np.exp(np.log(dist["median"]) + dist["sigma"] * z)
    return np.clip(np.rint(x), dist["min"], dist["max"]).astype(int)


def proteins(r: np.random.Generator, lengths) -> list:
    p = FREQ / FREQ.sum()
    letters = np.frombuffer(RESIDUES.encode(), dtype=np.uint8)
    return [letters[r.choice(20, size=int(n), p=p)].tobytes().decode()
            for n in lengths]


def annotate_batch(mix: dict, seed: int, index: int) -> list:
    """Batch `index` of an annotation mix: [(instruction, protein)] of
    `batch` rows; every batch has the same lengths and the same count of
    each instruction, in an order drawn from (seed, index)."""
    b = mix["batch"]
    r = rng(seed, 1, index)
    lengths = r.permutation(quantile_lengths(b, mix["protein_length"]))
    instr = mix["instructions"]
    picks = r.permutation(np.arange(b) % len(instr))
    return list(zip([instr[i] for i in picks], proteins(r, lengths)))


def words(r: np.random.Generator, nbytes: int) -> str:
    """Lower-case pseudo-words of 2-9 letters, `nbytes` bytes long."""
    out, n = [], 0
    while n < nbytes:
        w = "".join(chr(97 + c) for c in r.integers(0, 26, r.integers(2, 10)))
        out.append(w)
        n += len(w) + 1
    return " ".join(out)[:nbytes]


def train_batch(mix: dict, seed: int, index: int) -> list:
    """Batch `index` of an instruction-tuning mix: [{"instruction",
    "sequence", "output"}] of `batch` rows; every batch has the same
    protein and answer lengths and instruction counts, in an order drawn
    from (seed, index)."""
    b = mix["batch"]
    r = rng(seed, 2, index)
    plen = r.permutation(quantile_lengths(b, mix["protein_length"]))
    alen = r.permutation(quantile_lengths(b, mix["answer_length"]))
    instr = mix["instructions"]
    picks = r.permutation(np.arange(b) % len(instr))
    seqs = proteins(r, plen)
    return [{"instruction": instr[i], "sequence": s, "output": words(r, n)}
            for i, s, n in zip(picks, seqs, alen)]
