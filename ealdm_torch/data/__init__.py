"""Host-side data helpers of the port: the WordPiece tokenizer and its
committed vocab (`vocab_en.txt`, a byte-for-byte copy of the JAX package's),
and the layout tokens with their plot (`layout.py`)."""

from .layout import BBoxTokenizer, render_layout
from .tokenizer import WordPieceTokenizer, basic_tokenize, default_vocab_path, wordpiece_split

__all__ = ["BBoxTokenizer", "WordPieceTokenizer", "basic_tokenize", "default_vocab_path",
           "render_layout", "wordpiece_split"]
