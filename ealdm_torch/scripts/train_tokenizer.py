"""Train the port's WordPiece vocab from English prose on disk (counterpart
of `scripts/train_tokenizer.py`):

    python -m ealdm_torch.scripts.train_tokenizer [--vocab-size 12000]
        [--out PATH] [--max-mb 40]

The corpus is the committed `ealdm_torch/data/corpus_extra.txt` (a
byte-for-byte copy of the JAX package's) followed by prose lines harvested
from installed package documentation; `data.tokenizer.train_wordpiece_fast`
trains on it and `save_vocab` writes one token a line, by default to the
port's own `ealdm_torch/data/vocab_en.txt`. Needs no card.
"""
from __future__ import annotations

import argparse
import glob
import os
import re
import sys
import sysconfig

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")

# the running interpreter's installed packages' docs and metadata, and its
# standard library's reStructuredText
_SITE, _STDLIB = sysconfig.get_paths()["purelib"], sysconfig.get_paths()["stdlib"]
_SOURCES = (
    os.path.join(_SITE, "**", "*.md"),
    os.path.join(_SITE, "**", "*.rst"),
    os.path.join(_SITE, "**", "METADATA"),
    os.path.join(_STDLIB, "**", "*.rst"),
)

_CODE_LINE = re.compile(r"^\s*(>>>|\.\.\s|#|import |from |def |class |\$|@|\||`{3})")
_URLISH = re.compile(r"https?://|[/\\]{2}|[{}<>]|={3,}|-{4,}")


def harvest_lines(patterns=None, max_mb: float = 40.0):
    """Yield prose-looking lines from doc files (`_SOURCES` unless given;
    skips code, URLs, tables)."""
    budget = max_mb * 1e6
    seen = set()
    for pat in _SOURCES if patterns is None else patterns:
        for path in sorted(glob.glob(pat, recursive=True)):
            if budget <= 0:
                return
            try:
                with open(path, errors="ignore") as f:
                    text = f.read(1 << 20)
            except OSError:
                continue
            for line in text.splitlines():
                line = line.strip()
                if len(line) < 16 or _CODE_LINE.match(line):
                    continue
                if _URLISH.search(line):
                    continue
                ascii_ratio = sum(c.isascii() for c in line) / len(line)
                alpha_ratio = sum(c.isalpha() or c.isspace() for c in line) / len(line)
                if ascii_ratio < 0.97 or alpha_ratio < 0.6:
                    continue
                h = hash(line)
                if h in seen:
                    continue
                seen.add(h)
                budget -= len(line)
                yield line


def committed_corpus_lines():
    """The committed supplementary corpus (common English, weather, scenes)."""
    path = os.path.join(_DATA, "corpus_extra.txt")
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def get_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab-size", type=int, default=12000)
    ap.add_argument("--out", default=os.path.join(_DATA, "vocab_en.txt"))
    ap.add_argument("--max-mb", type=float, default=40.0)
    return ap


def main(argv=None):
    """Run the tool on `argv` (sys.argv[1:] if None); returns the vocab."""
    from ..data.tokenizer import save_vocab, train_wordpiece_fast

    args = get_parser().parse_args(argv)

    lines = committed_corpus_lines() + list(harvest_lines(max_mb=args.max_mb))
    print(f"harvested {len(lines)} prose lines ({sum(map(len, lines)) / 1e6:.1f} MB)")
    vocab = train_wordpiece_fast(lines, vocab_size=args.vocab_size)
    save_vocab(vocab, args.out)
    print(f"wrote {len(vocab)} tokens -> {args.out}")
    return vocab


if __name__ == "__main__":
    main(sys.argv[1:])
