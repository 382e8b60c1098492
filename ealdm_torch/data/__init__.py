"""Host-side data helpers of the port: the WordPiece tokenizer and its
committed vocab (`vocab_en.txt`, a byte-for-byte copy of the JAX package's)."""

from .tokenizer import WordPieceTokenizer, basic_tokenize, default_vocab_path, wordpiece_split

__all__ = ["WordPieceTokenizer", "basic_tokenize", "default_vocab_path", "wordpiece_split"]
