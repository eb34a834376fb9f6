"""Text processing for the eval metrics: tokenizers, stemmer, WordPiece
(port of `opus_pllm_tpu/evals/textproc.py`, copied: the JAX package's
`evals/__init__` imports its runner, which imports JAX).

Self-contained implementations of the text plumbing the reference pulls from
vendored HuggingFace `evaluate` modules (eval/metrics/*): the BLEU
tokenizer_13a regexes, rouge-style alphanumeric tokenization, a Porter
stemmer (METEOR stem matching: nltk's `PorterStemmer` when nltk imports,
else `porter_stem`, the JAX module's rule), and a WordPiece tokenizer for
BERTScore's BioBERT (metrics_computing_opi.py:12-21 truncates to 500
WordPiece tokens).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence

# ---------------------------------------------------------------------------
# tokenizer_13a (mteval-v13a): the tokenizer behind HF evaluate's BLEU
# ---------------------------------------------------------------------------

_13A_RULES = [
    (re.compile(r"<skipped>"), ""),            # strip skipped-text markers
    (re.compile(r"-\n"), ""),                  # de-hyphenate line breaks
    (re.compile(r"\n"), " "),
    (re.compile(r"&quot;"), '"'),
    (re.compile(r"&amp;"), "&"),
    (re.compile(r"&lt;"), "<"),
    (re.compile(r"&gt;"), ">"),
    (re.compile(r"([{-~\[-\` -&\(-\+\:-@\/])"), r" \1 "),   # punct w/ space
    (re.compile(r"([^0-9])([\.,])"), r"\1 \2 "),            # period/comma
    (re.compile(r"([\.,])([^0-9])"), r" \1 \2"),
    (re.compile(r"([0-9])(-)"), r"\1 \2 "),                 # dash after digit
]


def tokenize_13a(text: str) -> List[str]:
    t = f" {text} "
    for pat, rep in _13A_RULES:
        t = pat.sub(rep, t)
    return t.split()


# ---------------------------------------------------------------------------
# rouge tokenization: lowercase, keep [a-z0-9] runs (rouge_score semantics)
# ---------------------------------------------------------------------------

_ROUGE_NONALNUM = re.compile(r"[^a-z0-9]+")


def tokenize_rouge(text: str) -> List[str]:
    return [t for t in _ROUGE_NONALNUM.split(text.lower()) if t]


_SENT_SPLIT = re.compile(r"\n")


def split_sentences(text: str) -> List[str]:
    """ROUGE-Lsum sentence split: newline-delimited (rouge_score's
    summary-level convention after `add_newline_to_sents`); falls back to
    period-split when the text has no newlines."""
    sents = [s for s in _SENT_SPLIT.split(text) if s.strip()]
    if len(sents) <= 1:
        sents = [s.strip() for s in re.split(r"(?<=[.!?])\s+", text) if s.strip()]
    return sents


# ---------------------------------------------------------------------------
# Porter stemmer (METEOR's stem-match stage; matches nltk PorterStemmer for
# the common vocabulary, original 1980 algorithm)
# ---------------------------------------------------------------------------

_VOWELS = "aeiou"


def _is_cons(word: str, i: int) -> bool:
    c = word[i]
    if c in _VOWELS:
        return False
    if c == "y":
        return i == 0 or not _is_cons(word, i - 1)
    return True


def _measure(stem: str) -> int:
    """Number of VC sequences."""
    forms = "".join("c" if _is_cons(stem, i) else "v" for i in range(len(stem)))
    return len(re.findall(r"vc", forms))


def _has_vowel(stem: str) -> bool:
    return any(not _is_cons(stem, i) for i in range(len(stem)))


def _ends_double_cons(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2] and _is_cons(word, len(word) - 1))


def _cvc(word: str) -> bool:
    if len(word) < 3:
        return False
    return (_is_cons(word, len(word) - 3) and not _is_cons(word, len(word) - 2)
            and _is_cons(word, len(word) - 1) and word[-1] not in "wxy")


def porter_stem(word: str) -> str:
    w = word.lower()
    if len(w) <= 2:
        return w
    # step 1a
    if w.endswith("sses"):
        w = w[:-2]
    elif w.endswith("ies"):
        w = w[:-2]
    elif w.endswith("ss"):
        pass
    elif w.endswith("s"):
        w = w[:-1]
    # step 1b
    if w.endswith("eed"):
        if _measure(w[:-3]) > 0:
            w = w[:-1]
    elif (w.endswith("ed") and _has_vowel(w[:-2])) or \
         (w.endswith("ing") and _has_vowel(w[:-3])):
        w = w[:-2] if w.endswith("ed") else w[:-3]
        if w.endswith(("at", "bl", "iz")):
            w += "e"
        elif _ends_double_cons(w) and not w.endswith(("l", "s", "z")):
            w = w[:-1]
        elif _measure(w) == 1 and _cvc(w):
            w += "e"
    # step 1c
    if w.endswith("y") and _has_vowel(w[:-1]):
        w = w[:-1] + "i"
    # step 2
    step2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
             ("anci", "ance"), ("izer", "ize"), ("abli", "able"),
             ("alli", "al"), ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
             ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
             ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
             ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
             ("biliti", "ble")]
    for suf, rep in step2:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 3
    step3 = [("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
             ("ical", "ic"), ("ful", ""), ("ness", "")]
    for suf, rep in step3:
        if w.endswith(suf):
            if _measure(w[:-len(suf)]) > 0:
                w = w[:-len(suf)] + rep
            break
    # step 4
    step4 = ["al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
             "ment", "ent", "ou", "ism", "ate", "iti", "ous", "ive", "ize"]
    for suf in sorted(step4, key=len, reverse=True):
        if w.endswith(suf):
            stem = w[:-len(suf)]
            if _measure(stem) > 1:
                w = stem
            break
        if w.endswith("ion") and len(w) > 3 and w[-4] in "st" and \
                _measure(w[:-3]) > 1:
            w = w[:-3]
            break
    # step 5a
    if w.endswith("e"):
        stem = w[:-1]
        m = _measure(stem)
        if m > 1 or (m == 1 and not _cvc(stem)):
            w = stem
    # step 5b
    if _measure(w) > 1 and _ends_double_cons(w) and w.endswith("l"):
        w = w[:-1]
    return w


try:  # prefer nltk's reference implementation when importable (pure code)
    from nltk.stem.porter import PorterStemmer as _NltkPorter

    _nltk_stemmer = _NltkPorter()

    def stem(word: str) -> str:
        return _nltk_stemmer.stem(word)
except Exception:  # pragma: no cover
    stem = porter_stem


# ---------------------------------------------------------------------------
# WordPiece (BERT) tokenizer for BERTScore
# ---------------------------------------------------------------------------

_BERT_PUNCT = re.compile(
    r"([!-/:-@\[-`{-~])")  # ascii punctuation blocks


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a vocab dict.

    Mirrors BERT basic+wordpiece tokenization (whitespace split, punctuation
    split, greedy ## continuation pieces) so BERTScore can run BioBERT
    without transformers at eval time.
    """

    def __init__(self, vocab: Dict[str, int], *, lowercase: bool = False,
                 unk_token: str = "[UNK]", max_chars_per_word: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.unk_token = unk_token
        self.max_chars = max_chars_per_word
        self.cls_id = vocab.get("[CLS]", 0)
        self.sep_id = vocab.get("[SEP]", 0)
        self.pad_id = vocab.get("[PAD]", 0)
        self.unk_id = vocab.get(unk_token, 0)

    @staticmethod
    def load_vocab(path: str) -> Dict[str, int]:
        with open(path, encoding="utf-8") as f:
            return {line.rstrip("\n"): i for i, line in enumerate(f)}

    def basic_tokenize(self, text: str) -> List[str]:
        if self.lowercase:
            text = text.lower()
        text = _BERT_PUNCT.sub(r" \1 ", text)
        return text.split()

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > self.max_chars:
            return [self.unk_token]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for w in self.basic_tokenize(text):
            out.extend(self.wordpiece(w))
        return out

    def encode(self, text: str, max_tokens: int | None = None) -> List[int]:
        toks = self.tokenize(text)
        if max_tokens is not None:
            toks = toks[:max_tokens]
        return ([self.cls_id] + [self.vocab.get(t, self.unk_id) for t in toks]
                + [self.sep_id])
