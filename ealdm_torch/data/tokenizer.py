"""WordPiece tokenizer, BERT-uncased semantics (counterpart of
`ealdm_tpu/data/tokenizer.py`).

BasicTokenizer (clean, lowercase, accent-strip, punctuation and CJK split)
then greedy longest-match-first WordPiece with `##` continuations, over a
vocab file with one token a line. The default vocab is the committed
`vocab_en.txt` beside this module (12,000 entries); `EALDM_VOCAB_PATH`
points every tokenizer at another one, such as a real 30,522-line
`bert-base-uncased` vocab.txt. `train_wordpiece` (likelihood-scored pair
merges) and `train_wordpiece_fast` (batched non-interacting merges) give
the JAX package's vocabulary lists; `save_vocab` writes one a line.
"""
from __future__ import annotations

import os
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Sequence

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


# ------------------------------------------------------------------ trainer
def train_wordpiece(
    corpus: Iterable[str],
    vocab_size: int = 8000,
    min_pair_freq: int = 2,
    lowercase: bool = True,
) -> List[str]:
    """Train a WordPiece vocab (likelihood-scored pair merges, as in the
    original WordPiece/BERT recipe: score = freq(ab) / (freq(a)*freq(b))).

    Returns the vocab as an ordered token list (specials first, then single
    characters, then learned merges)."""
    word_freq: Counter = Counter()
    for line in corpus:
        for w in basic_tokenize(line, lowercase):
            word_freq[w] += 1

    # each word as a tuple of pieces: first char, then ##-continuations
    def to_pieces(w: str):
        return tuple([w[0]] + ["##" + c for c in w[1:]])

    words = {w: to_pieces(w) for w in word_freq}
    alphabet = sorted({p for pieces in words.values() for p in pieces})
    vocab: List[str] = list(SPECIALS) + alphabet

    while len(vocab) < vocab_size:
        piece_freq: Counter = Counter()
        pair_freq: Counter = Counter()
        for w, pieces in words.items():
            f = word_freq[w]
            for p in pieces:
                piece_freq[p] += f
            for a, b in zip(pieces, pieces[1:]):
                pair_freq[(a, b)] += f
        best, best_score = None, 0.0
        for (a, b), f in pair_freq.items():
            if f < min_pair_freq:
                continue
            score = f / (piece_freq[a] * piece_freq[b])
            if score > best_score:
                best, best_score = (a, b), score
        if best is None:
            break
        a, b = best
        merged = a + b[2:] if b.startswith("##") else a + b
        vocab.append(merged)
        new_words = {}
        for w, pieces in words.items():
            out: List[str] = []
            i = 0
            while i < len(pieces):
                if i + 1 < len(pieces) and pieces[i] == a and pieces[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(pieces[i])
                    i += 1
            new_words[w] = tuple(out)
        words = new_words
    return vocab


def save_vocab(vocab: Sequence[str], path: str) -> None:
    with open(path, "w") as f:
        f.write("\n".join(vocab) + "\n")


def train_wordpiece_fast(
    corpus: Iterable[str],
    vocab_size: int = 12000,
    min_pair_freq: int = 3,
    lowercase: bool = True,
    batch_size: int = 200,
    max_word_len: int = 24,
    seed_top_words: int = 6000,
    seed_min_freq: int = 8,
) -> List[str]:
    """Scalable WordPiece trainer for real-size (>=8k) vocabularies.

    Same likelihood scoring as `train_wordpiece`
    (score = freq(ab) / (freq(a) * freq(b))), but selects the top
    `batch_size` NON-INTERACTING pairs per round (no selected pair shares a
    piece with an earlier selection in the same round) and re-scores
    between rounds, and only re-segments words that contain a selected
    pair (inverted pair->word index). Exact greedy order is traded for
    tractability — coverage-equivalent at these sizes. Deterministic.
    """
    word_freq: Counter = Counter()
    for line in corpus:
        for w in basic_tokenize(line, lowercase):
            if len(w) <= max_word_len:
                word_freq[w] += 1

    words = {
        w: tuple([w[0]] + ["##" + c for c in w[1:]]) for w in word_freq
    }
    alphabet = sorted({p for pieces in words.values() for p in pieces})
    vocab: List[str] = list(SPECIALS) + alphabet
    vocab_set = set(vocab)

    # Seed the most frequent whole words as single tokens (what greedy merge
    # training converges to on a large corpus; the likelihood score's
    # exclusivity bias starves common-word merges on small corpora, so "the"
    # would otherwise shatter). Seeded words contribute no pair stats.
    if seed_top_words:
        for w, f in word_freq.most_common():
            if len(vocab) >= len(SPECIALS) + len(alphabet) + seed_top_words:
                break
            if f < seed_min_freq or len(w) < 2 or w in vocab_set:
                continue
            vocab.append(w)
            vocab_set.add(w)
            words[w] = (w,)

    while len(vocab) < vocab_size:
        piece_freq: Counter = Counter()
        pair_freq: Counter = Counter()
        index: Dict[tuple, List[str]] = {}
        for w, pieces in words.items():
            f = word_freq[w]
            for p in pieces:
                piece_freq[p] += f
            for pr in zip(pieces, pieces[1:]):
                pair_freq[pr] += f
                index.setdefault(pr, []).append(w)

        scored = sorted(
            (
                (f / (piece_freq[a] * piece_freq[b]), (a, b))
                for (a, b), f in pair_freq.items()
                if f >= min_pair_freq
            ),
            key=lambda t: (-t[0], t[1]),
        )
        used_pieces: set = set()
        merges = []
        for _, (a, b) in scored:
            if len(merges) >= batch_size or (
                len(vocab) + len(merges) >= vocab_size
            ):
                break
            if a in used_pieces or b in used_pieces:
                continue
            merged = a + b[2:] if b.startswith("##") else a + b
            if merged in vocab_set:
                continue
            used_pieces.update((a, b, merged))
            merges.append((a, b, merged))
        if not merges:
            break

        merge_map = {(a, b): m for a, b, m in merges}
        touched = set()
        for a, b, _ in merges:
            touched.update(index.get((a, b), ()))
        for w in touched:
            pieces = words[w]
            out: List[str] = []
            i = 0
            while i < len(pieces):
                if (
                    i + 1 < len(pieces)
                    and (pieces[i], pieces[i + 1]) in merge_map
                ):
                    out.append(merge_map[(pieces[i], pieces[i + 1])])
                    i += 2
                else:
                    out.append(pieces[i])
                    i += 1
            words[w] = tuple(out)
        for _, _, m in merges:
            vocab.append(m)
            vocab_set.add(m)
    return vocab
