"""WordNet database-file loader: a synonym source for METEOR's stage-3
matcher (port of `opus_pllm_tpu/evals/wordnet.py`, copied).

The reference's METEOR (multi_modality_model/multi_modality_v1/eval/
metrics/meteor/meteor.py) runs nltk's meteor_score, whose third
alignment stage matches WordNet synonyms. Without a WordNet corpus on
disk METEOR here degrades to exact+stem (metrics.py). This module makes
full parity a pure data drop-in: point `WordNetSynonyms` at a directory
holding the standard WNdb files (index.noun/data.noun etc., the exact
files nltk's `wordnet` corpus extracts) and pass it to
meteor_corpus/meteor_pair as `synonyms=`; no nltk needed. The
mini-fixture tests/fixtures/mini_wordnet exercises the loader and the
synonym-match path.

WNdb format (docs: wndb(5WN)):
  index.<pos>:  lemma pos synset_cnt p_cnt [ptr_symbol...] sense_cnt
                tagsense_cnt synset_offset [synset_offset...]
  data.<pos>:   synset_offset lex_filenum ss_type w_cnt(2-digit hex)
                word lex_id [word lex_id...] p_cnt [ptr...] | gloss
License-header lines begin with whitespace; adjective lemmas may carry
syntactic markers like "(p)" which are stripped, matching nltk.
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Set, Tuple

_MARKER = re.compile(r"\(\w+\)$")

POS_FILES = ("noun", "verb", "adj", "adv")


class WordNetSynonyms:
    """Lemma -> same-synset lemmas across all parts of speech, loaded
    from WNdb index.*/data.* files. API: `synonyms(word) -> set[str]`
    (always includes the word itself), the contract metrics._meteor_align
    consumes."""

    def __init__(self, root: str):
        self._index: Dict[str, List[Tuple[str, str]]] = {}
        self._words: Dict[Tuple[str, str], List[str]] = {}
        found = False
        for pos in POS_FILES:
            ipath = os.path.join(root, f"index.{pos}")
            dpath = os.path.join(root, f"data.{pos}")
            if not (os.path.exists(ipath) and os.path.exists(dpath)):
                continue
            found = True
            with open(ipath, encoding="utf-8") as f:
                for line in f:
                    if line[:1].isspace():       # license header
                        continue
                    fields = line.split()
                    if len(fields) < 5:
                        continue
                    lemma = fields[0]
                    n_syn = int(fields[2])
                    offsets = fields[-n_syn:] if n_syn else []
                    self._index.setdefault(lemma, []).extend(
                        (pos, off) for off in offsets)
            with open(dpath, encoding="utf-8") as f:
                for line in f:
                    if line[:1].isspace():
                        continue
                    fields = line.split()
                    if len(fields) < 5:
                        continue
                    off = fields[0]
                    try:
                        w_cnt = int(fields[3], 16)
                    except ValueError:
                        continue
                    words = [_MARKER.sub("", fields[4 + 2 * i])
                             for i in range(w_cnt)
                             if 4 + 2 * i < len(fields)]
                    self._words[(pos, off)] = words
        if not found:
            raise FileNotFoundError(
                f"no WNdb index.*/data.* files under {root!r} "
                f"(expected e.g. index.noun + data.noun)")

    def synonyms(self, word: str) -> Set[str]:
        w = word.lower().replace(" ", "_")
        out = {word}
        for pos, off in self._index.get(w, ()):
            for lemma in self._words.get((pos, off), ()):
                out.add(lemma.replace("_", " ").lower())
        return out
