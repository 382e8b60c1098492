"""WordPiece tokenizer, BERT-uncased semantics (counterpart of
`ealdm_tpu/data/tokenizer.py`).

BasicTokenizer (clean, lowercase, accent-strip, punctuation and CJK split)
then greedy longest-match-first WordPiece with `##` continuations, over a
vocab file with one token a line. The default vocab is the committed
`vocab_en.txt` beside this module (12,000 entries); `EALDM_VOCAB_PATH`
points every tokenizer at another one, such as a real 30,522-line
`bert-base-uncased` vocab.txt. The vocab trainers stay in the JAX package.
"""
from __future__ import annotations

import os
import unicodedata
from typing import Dict, List, Sequence

import numpy as np
import torch

DEFAULT_VOCAB_PATH = os.path.join(os.path.dirname(__file__), "vocab_en.txt")

VOCAB_ENV_VAR = "EALDM_VOCAB_PATH"


def default_vocab_path() -> str:
    """$EALDM_VOCAB_PATH when set, else the committed compact vocab."""
    return os.environ.get(VOCAB_ENV_VAR) or DEFAULT_VOCAB_PATH


PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIALS = (PAD, UNK, CLS, SEP, MASK)


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even where unicode does not
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean -> CJK-space -> lower + strip accents ->
    punctuation split -> whitespace split."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_cjk(cp):
            out_chars.append(f" {ch} ")
        elif _is_whitespace(ch):
            out_chars.append(" ")
        else:
            out_chars.append(ch)
    split: List[str] = []
    for tok in "".join(out_chars).split():
        if lowercase:
            tok = unicodedata.normalize("NFD", tok.lower())
            tok = "".join(c for c in tok if unicodedata.category(c) != "Mn")
        buf: List[str] = []
        for ch in tok:  # each punctuation character is a token of its own
            if _is_punctuation(ch):
                if buf:
                    split.append("".join(buf))
                    buf = []
                split.append(ch)
            else:
                buf.append(ch)
        if buf:
            split.append("".join(buf))
    return split


def wordpiece_split(word: str, vocab: Dict[str, int], max_chars: int = 100) -> List[str]:
    """Greedy longest-match-first; the whole word becomes [UNK] on any failure."""
    if len(word) > max_chars:
        return [UNK]
    pieces: List[str] = []
    start = 0
    while start < len(word):
        end = len(word)
        cur = None
        while start < end:
            sub = word[start:end] if start == 0 else "##" + word[start:end]
            if sub in vocab:
                cur = sub
                break
            end -= 1
        if cur is None:
            return [UNK]
        pieces.append(cur)
        start = end
    return pieces


class WordPieceTokenizer:
    """BERT-uncased-compatible tokenizer over a vocab.txt (one token a line)."""

    def __init__(self, vocab_path: str = None, max_len: int = 77, lowercase: bool = True):
        vocab_path = vocab_path or default_vocab_path()
        with open(vocab_path) as f:
            tokens = [line.rstrip("\n") for line in f if line.rstrip("\n")]
        self.vocab: Dict[str, int] = {t: i for i, t in enumerate(tokens)}
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.max_len = max_len
        self.lowercase = lowercase
        missing = [s for s in SPECIALS if s not in self.vocab]
        if missing:
            raise ValueError(f"vocab {vocab_path!r} lacks the special tokens {missing}")
        self.pad_id = self.vocab[PAD]
        self.unk_id = self.vocab[UNK]
        self.cls_id = self.vocab[CLS]
        self.sep_id = self.vocab[SEP]

    def __len__(self):
        return len(self.vocab)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(wordpiece_split(word, self.vocab))
        return out

    def encode(self, text: str) -> List[int]:
        """[CLS] pieces... [SEP], truncated to max_len (HF convention)."""
        ids = [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        return [self.cls_id] + ids[: self.max_len - 2] + [self.sep_id]

    def decode(self, ids: Sequence[int]) -> str:
        toks = [self.inv_vocab.get(int(i), UNK) for i in ids]
        return " ".join(t for t in toks if t not in (PAD, CLS, SEP)).replace(" ##", "")

    def __call__(self, texts: Sequence[str]) -> torch.Tensor:
        """[len(texts), max_len] int64 ids on the CPU, PAD-filled."""
        out = np.full((len(texts), self.max_len), self.pad_id, np.int64)
        for i, t in enumerate(texts):
            ids = self.encode(t)
            out[i, : len(ids)] = ids
        return torch.from_numpy(out)
