"""Host-side data helpers of the port: the WordPiece tokenizer and its
committed vocab (`vocab_en.txt`, a byte-for-byte copy of the JAX package's),
the layout tokens with their plot (`layout.py`) and the feature scalers'
JSON files (`scalers.py`)."""

from .layout import BBoxTokenizer, render_layout
from .scalers import MinMaxScaler, MultiLabelBinarizer, StandardScaler, load_scaler, save_scaler
from .tokenizer import WordPieceTokenizer, basic_tokenize, default_vocab_path, wordpiece_split

__all__ = ["BBoxTokenizer", "MinMaxScaler", "MultiLabelBinarizer", "StandardScaler",
           "WordPieceTokenizer", "basic_tokenize", "default_vocab_path", "load_scaler",
           "render_layout", "save_scaler", "wordpiece_split"]
