"""Host-side data layer of the port: the batching pipeline and the device
prefetcher (`pipeline.py`), the stream-camera dataset (`stdiff.py`) with
its synthetic corpus (`synthetic.py`), the C++ .npy loader's binding
(`native_loader.py`), the image-folder dataset (`images.py`), the GPT
label requests (`gpt_labels.py`), the WordPiece tokenizer and its
committed vocab (`vocab_en.txt`, a byte-for-byte copy of the JAX
package's), the layout tokens with their plot (`layout.py`) and the
feature scalers' JSON files (`scalers.py`)."""

from .images import ImageFolderDataset, center_crop_resize
from .layout import BBoxTokenizer, render_layout
from .pipeline import DataLoader, DataModule, Dataset, DevicePrefetcher, WrappedDataset
from .scalers import MinMaxScaler, MultiLabelBinarizer, StandardScaler, load_scaler, save_scaler
from .stdiff import (WEATHER_CLASSES, ImageNetVidDataset, StreamCameraDataset,
                     parse_response_jsonl)
from .synthetic import generate_synthetic_dataset
from .tokenizer import WordPieceTokenizer, basic_tokenize, default_vocab_path, wordpiece_split

__all__ = ["BBoxTokenizer", "DataLoader", "DataModule", "Dataset", "DevicePrefetcher",
           "ImageFolderDataset", "ImageNetVidDataset", "MinMaxScaler", "MultiLabelBinarizer",
           "StandardScaler", "StreamCameraDataset", "WEATHER_CLASSES", "WordPieceTokenizer",
           "WrappedDataset", "basic_tokenize", "center_crop_resize", "default_vocab_path",
           "generate_synthetic_dataset", "load_scaler", "parse_response_jsonl",
           "render_layout", "save_scaler", "wordpiece_split"]
