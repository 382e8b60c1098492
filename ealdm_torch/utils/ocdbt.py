"""tensorstore's OCDBT key-value store ("optionally-cooperative distributed
B+tree"), read and written with no tensorstore: the layer under the JAX
package's orbax checkpoints (`ealdm_tpu/training/checkpoint.py`).

A database is a folder: `manifest.ocdbt` and the data files under `d/`.
Every manifest and B+tree node is one record:

  magic (uint32 big-endian: 0x0cdb3a2a a manifest, 0x0cdb20de a node),
  length of the record (uint64 little-endian), version (varint, 0),
  compression (varint: 0 none, 1 zstd), the body (zstd-compressed or not),
  CRC-32C of all the bytes before it (uint32 little-endian).

The manifest's body is the config (uuid[16], manifest kind, max inline
value bytes, max decoded node bytes, version tree arity log2 (a byte), the
compression method and, for zstd, its level as int32), then the version
tree: a data file table, the inline versions as columns (generation
number, root height (a byte), the root node's file id, offset, length,
num_keys, num_tree_bytes, num_indirect_value_bytes, commit time as
uint64) and the count of older version-tree nodes. The newest version is
the last inline one.

A node's body is its height (a byte), a data file table and its entries
as columns. A data file table is the count, the prefix each path shares
with the one before (from the second on), each path's suffix length and
base-path length, then the suffixes; a path is base path + relative path,
relative to the folder of the manifest (orbax's root database reaches its
per-process databases as `ocdbt.process_<n>/d/...`). Keys are
prefix-compressed the same way. A leaf's entries: key prefix and suffix
lengths, the suffixes, each value's length, its kind (0 inline, 1 a range
of a data file), the file id and offset of each indirect value, then the
inline values. An interior node's: key prefix and suffix lengths, each
child's subtree common prefix length, the suffixes, the child reference
columns (file id, offset, length, num_keys, num_tree_bytes,
num_indirect_value_bytes). A child's keys are stored without the common
prefix of its entry's key, which its parents' prefixes complete.

`OcdbtReader` reads a database with `mmap`; `list()` and `read(key)`
mirror `tensorstore.KvStore`'s. `write_ocdbt` writes one database,
uncompressed: one data file holding the values over the inline limit and
then the nodes, leaves of at most `max_decoded_node_bytes` and interior
levels above them, and the manifest. Nothing falls back: a record that
does not parse raises `OcdbtError` naming its file and the field.
"""
from __future__ import annotations

import mmap
import os
import struct
import time
import uuid as _uuid
from typing import Callable, Dict, Iterable, List, Mapping, Tuple

from . import zstd

MANIFEST = "manifest.ocdbt"
_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE
_HEADER = 12  # magic + length
# what tensorstore writes by default
MAX_INLINE_VALUE_BYTES = 100
MAX_DECODED_NODE_BYTES = 8 * 1024 * 1024


class OcdbtError(ValueError):
    """A database the reader cannot read."""


class _Body:
    """A cursor over a decoded record body."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        raise OcdbtError(f"{self.where}: {what} (byte {self.pos} of {len(self.data)})")

    def byte(self) -> int:
        if self.pos >= len(self.data):
            self.fail("truncated")
        self.pos += 1
        return self.data[self.pos - 1]

    def varint(self) -> int:
        out = shift = 0
        while True:
            b = self.byte()
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7
            if shift > 63:
                self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            self.fail(f"truncated: {n} bytes wanted")
        self.pos += n
        return bytes(self.data[self.pos - n:self.pos])

    def uint(self, fmt: str) -> int:
        return struct.unpack(fmt, self.raw(struct.calcsize(fmt)))[0]

    def prefixed(self, n: int) -> Tuple[List[int], List[int]]:
        """n prefix-compressed strings (the shared lengths of the 2nd on,
        the suffix lengths; the suffixes come later: `suffixes`)."""
        shared = [0] + self.varints(n - 1) if n else []
        return shared, self.varints(n)

    def suffixes(self, shared: List[int], lengths: List[int]) -> List[bytes]:
        out, prev = [], b""
        for s, n in zip(shared, lengths):
            if s > len(prev):
                self.fail(f"prefix length {s} exceeds the previous key's {len(prev)}")
            prev = prev[:s] + self.raw(n)
            out.append(prev)
        return out


def _record(buf, magic: int, where: str) -> _Body:
    """Check a record's header and CRC and return its decoded body."""
    if len(buf) < _HEADER + 2 + 4:
        raise OcdbtError(f"{where}: {len(buf)} bytes is too short for a record")
    got_magic, length = struct.unpack_from(">I", buf, 0)[0], struct.unpack_from("<Q", buf, 4)[0]
    if got_magic != magic:
        raise OcdbtError(f"{where}: magic {got_magic:#010x}, not {magic:#010x}")
    if length != len(buf):
        raise OcdbtError(f"{where}: the header says {length} bytes, the record holds {len(buf)}")
    want = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    got = zstd.crc32c(memoryview(buf)[:len(buf) - 4])
    if got != want:
        raise OcdbtError(f"{where}: bad CRC-32C {got:#010x}, the record says {want:#010x}")
    head = _Body(bytes(buf[_HEADER:_HEADER + 20]), where)
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise OcdbtError(f"{where}: format version {version}, only 0 is known")
    body = memoryview(buf)[_HEADER + head.pos:len(buf) - 4]
    if compression == 1:
        try:
            body = zstd.decompress(body)
        except zstd.ZstdError as e:
            raise OcdbtError(f"{where}: zstd body: {e}") from e
    elif compression == 0:
        body = bytes(body)
    else:
        raise OcdbtError(f"{where}: compression format {compression} is unknown")
    return _Body(body, where)


def _file_table(b: _Body) -> List[str]:
    n = b.varint()
    shared, lengths = b.prefixed(n)
    base = b.varints(n)
    paths = b.suffixes(shared, lengths)
    out = []
    for p, k in zip(paths, base):
        if k > len(p):
            b.fail(f"base path length {k} exceeds the path {p!r}")
        out.append(p.decode())
    return out


class _Ref:
    """A range of a data file (a node or an indirect value)."""
    __slots__ = ("path", "offset", "length")

    def __init__(self, path: str, offset: int, length: int):
        self.path, self.offset, self.length = path, offset, length


class OcdbtReader:
    """The newest version of the database in folder `root`, its keys and
    values, read with `mmap`."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self._maps: Dict[str, mmap.mmap] = {}
        self._files: Dict[str, object] = {}
        path = os.path.join(self.root, MANIFEST)
        try:
            with open(path, "rb") as f:
                raw = f.read()
        except OSError as e:
            raise OcdbtError(f"{path}: no OCDBT manifest ({e})") from e
        b = _record(raw, _MANIFEST_MAGIC, path)
        b.raw(16)  # uuid
        kind = b.varint()
        if kind != 0:
            b.fail(f"manifest kind {kind} (numbered manifests) is not read")
        self.max_inline_value_bytes, self.max_decoded_node_bytes = b.varint(), b.varint()
        b.byte()  # version tree arity log2
        method = b.varint()
        if method == 1:
            b.uint("<i")  # zstd level
        elif method != 0:
            b.fail(f"compression method {method} is unknown")
        files = _file_table(b)
        n = b.varint()
        if n == 0:
            b.fail("no inline version: the newest version is missing")
        b.varints(n)  # generation numbers
        heights = [b.byte() for _ in range(n)]
        ids, offsets, lengths = b.varints(n), b.varints(n), b.varints(n)
        stats = [b.varints(n) for _ in range(3)]
        self.num_keys, self.height = stats[0][-1], heights[-1]
        self._entries: Dict[bytes, object] = {}
        if self.num_keys:
            root_ref = self._ref(files, ids[-1], offsets[-1], lengths[-1], b)
            self._walk(root_ref, heights[-1], b"")
        if len(self._entries) != self.num_keys:
            raise OcdbtError(f"{path}: the manifest counts {self.num_keys} keys, "
                             f"the tree holds {len(self._entries)}")
        self._keys = sorted(self._entries)

    def _ref(self, files: List[str], fid: int, offset: int, length: int, b: _Body) -> _Ref:
        if fid >= len(files):
            b.fail(f"data file id {fid} of a table of {len(files)}")
        return _Ref(files[fid], offset, length)

    def _map(self, rel: str) -> mmap.mmap:
        m = self._maps.get(rel)
        if m is None:
            path = os.path.normpath(os.path.join(self.root, rel))
            try:
                f = open(path, "rb")
            except OSError as e:
                raise OcdbtError(f"{path}: a data file of {self.root} is missing ({e})") from e
            size = os.fstat(f.fileno()).st_size
            m = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) if size else b""
            self._files[rel], self._maps[rel] = f, m
        return m

    def _bytes(self, ref: _Ref, what: str) -> memoryview:
        m = self._map(ref.path)
        if ref.offset + ref.length > len(m):
            raise OcdbtError(f"{os.path.join(self.root, ref.path)}: {what} at "
                             f"[{ref.offset}, +{ref.length}) past the end ({len(m)} bytes)")
        return memoryview(m)[ref.offset:ref.offset + ref.length]

    def _walk(self, ref: _Ref, height: int, prefix: bytes) -> None:
        where = f"{os.path.join(self.root, ref.path)}@{ref.offset}"
        b = _record(self._bytes(ref, "a B+tree node"), _NODE_MAGIC, where)
        got = b.byte()
        if got != height:
            b.fail(f"node height {got}, its parent says {height}")
        files = _file_table(b)
        n = b.varint()
        shared, lengths = b.prefixed(n)
        if height == 0:
            keys = b.suffixes(shared, lengths)
            sizes = b.varints(n)
            kinds = b.varints(n)
            if any(k > 1 for k in kinds):
                b.fail(f"value kind {max(kinds)} is unknown")
            nind = sum(kinds)
            ids, offsets = b.varints(nind), b.varints(nind)
            j = 0
            for key, size, kind in zip(keys, sizes, kinds):
                if kind:
                    self._entries[prefix + key] = self._ref(files, ids[j], offsets[j], size, b)
                    j += 1
            for key, size, kind in zip(keys, sizes, kinds):
                if not kind:
                    self._entries[prefix + key] = b.raw(size)
            if b.pos != len(b.data):
                b.fail("bytes left over after the leaf's values")
            return
        common = b.varints(n)
        keys = b.suffixes(shared, lengths)
        ids, offsets, sizes = b.varints(n), b.varints(n), b.varints(n)
        for _ in range(3):
            b.varints(n)  # the children's statistics
        for key, c, fid, off, size in zip(keys, common, ids, offsets, sizes):
            if c > len(key):
                b.fail(f"subtree common prefix {c} exceeds the key {key!r}")
            self._walk(self._ref(files, fid, off, size, b), height - 1, prefix + key[:c])

    def list(self) -> List[bytes]:
        """Every key, sorted."""
        return list(self._keys)

    def __contains__(self, key) -> bool:
        return _key(key) in self._entries

    def _entry(self, key):
        try:
            return self._entries[_key(key)]
        except KeyError:
            raise KeyError(f"{self.root}: no key {_key(key)!r}") from None

    def read(self, key) -> memoryview:
        """The value of `key`, a view of the mapped file where it is indirect."""
        v = self._entry(key)
        if isinstance(v, _Ref):
            return self._bytes(v, f"the value of {_key(key)!r}")
        return memoryview(v)

    def close(self) -> None:
        for m in self._maps.values():
            if isinstance(m, mmap.mmap):
                try:
                    m.close()
                except BufferError:  # a view of it is still alive
                    pass
        for f in self._files.values():
            f.close()
        self._maps.clear()
        self._files.clear()


def _key(key) -> bytes:
    return key.encode() if isinstance(key, str) else bytes(key)


# ----------------------------------------------------------------- writer

def _varint(x: int) -> bytes:
    out = bytearray()
    while True:
        b = x & 0x7F
        x >>= 7
        if x:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(xs: Iterable[int]) -> bytes:
    return b"".join(_varint(x) for x in xs)


def _shared(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _prefix_columns(keys: List[bytes]) -> Tuple[bytes, bytes]:
    """(the prefix and suffix length columns, the suffixes)."""
    shared = [_shared(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    suffixes = [k[s:] for k, s in zip(keys, [0] + shared)]
    return _varints(shared) + _varints(len(s) for s in suffixes), b"".join(suffixes)


def _table(path: str) -> bytes:
    cols, chars = _prefix_columns([path.encode()])
    return _varint(1) + cols + _varint(0) + chars


def _pack(magic: int, body: bytes) -> bytes:
    head = struct.pack(">I", magic)
    rest = _varint(0) + _varint(0) + body  # version 0, no compression
    length = len(head) + 8 + len(rest) + 4
    rec = head + struct.pack("<Q", length) + rest
    return rec + struct.pack("<I", zstd.crc32c(rec))


class Deferred:
    """A value of `nbytes` bytes made when it is written: `fn()` gives a
    bytes-like object (a leaf copied off the card one at a time)."""

    def __init__(self, nbytes: int, fn: Callable[[], object]):
        self.nbytes, self.fn = nbytes, fn


def _nbytes(v) -> int:
    return v.nbytes if isinstance(v, Deferred) else memoryview(v).nbytes


def _inline(v) -> bytes:
    return bytes(memoryview(v).cast("B"))


def write_ocdbt(root: str, items: Mapping[bytes, object],
                max_inline_value_bytes: int = MAX_INLINE_VALUE_BYTES,
                max_decoded_node_bytes: int = MAX_DECODED_NODE_BYTES) -> int:
    """Write `items` (key -> bytes-like, written with no copy, or a
    `Deferred` of more than max_inline_value_bytes) as a new database in
    folder `root` (which must not hold one): uncompressed, one data file.
    Returns the bytes written."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if os.path.exists(os.path.join(root, MANIFEST)):
        raise FileExistsError(f"{root} already holds a database")
    values = {_key(k): v for k, v in items.items()}
    keys = sorted(values)
    data_name = "d/" + _uuid.uuid4().hex
    table = _table(data_name)
    refs: Dict[bytes, Tuple[int, int]] = {}  # indirect values: (offset, length)
    offset = 0

    def node_bytes(entries: int) -> int:
        return 1 + len(table) + 10 + entries

    def emit(f, height: int, nodes):
        """Write one level's nodes [(keys, body)]; returns their
        (first key, offset, length, (num_keys, tree bytes, indirect bytes))."""
        nonlocal offset
        out = []
        for (ks, body), st in nodes:
            rec = _pack(_NODE_MAGIC, bytes([height]) + table + body)
            f.write(rec)
            out.append((ks[0], offset, len(rec), (st[0], st[1] + len(rec), st[2])))
            offset += len(rec)
        return out

    def groups(sizes):
        """Runs of consecutive entries whose node fits max_decoded_node_bytes."""
        run, est = [], 0
        for i, n in enumerate(sizes):
            if run and node_bytes(est + n) > max_decoded_node_bytes:
                yield run
                run, est = [], 0
            run.append(i)
            est += n
        if run:
            yield run

    with open(os.path.join(root, data_name), "wb") as f:
        for k in keys:
            v = values[k]
            n = _nbytes(v)
            if n <= max_inline_value_bytes:
                if isinstance(v, Deferred):
                    raise ValueError(f"{k!r}: a deferred value must be stored indirectly")
                continue
            data = v.fn() if isinstance(v, Deferred) else v
            if memoryview(data).nbytes != n:
                raise ValueError(f"{k!r}: {memoryview(data).nbytes} bytes, not {n}")
            f.write(data)
            del data
            refs[k] = (offset, n)
            offset += n
        leaves = []
        for run in groups([len(k) + 30 + (0 if k in refs else _nbytes(values[k]))
                           for k in keys]):
            ks = [keys[i] for i in run]
            cols, chars = _prefix_columns(ks)
            ind = [k for k in ks if k in refs]
            body = (_varint(len(ks)) + cols + chars
                    + _varints(refs[k][1] if k in refs else _nbytes(values[k]) for k in ks)
                    + _varints(int(k in refs) for k in ks)
                    + _varints(0 for _ in ind) + _varints(refs[k][0] for k in ind)
                    + b"".join(_inline(values[k]) for k in ks if k not in refs))
            leaves.append(((ks, body), (len(ks), 0, sum(refs[k][1] for k in ind))))
        nodes = emit(f, 0, leaves)
        height = 0
        while len(nodes) > 1:
            height += 1
            level = []
            for run in groups([len(n[0]) + 40 for n in nodes]):
                kids = [nodes[i] for i in run]
                ks = [n[0] for n in kids]
                cols, chars = _prefix_columns(ks)
                body = (_varint(len(kids)) + cols + _varints(0 for _ in kids) + chars
                        + _varints(0 for _ in kids) + _varints(n[1] for n in kids)
                        + _varints(n[2] for n in kids)
                        + b"".join(_varints(n[3][j] for n in kids) for j in range(3)))
                level.append(((ks, body), tuple(sum(n[3][j] for n in kids) for j in range(3))))
            if len(level) == len(nodes):
                raise ValueError("max_decoded_node_bytes holds fewer than two children")
            nodes = emit(f, height, level)
    root_off, root_len, st = (nodes[0][1], nodes[0][2], nodes[0][3]) if keys else (0, 0, (0, 0, 0))
    config = (_uuid.uuid4().bytes + _varint(0) + _varint(max_inline_value_bytes)
              + _varint(max_decoded_node_bytes) + bytes([4]) + _varint(0))
    body = (config + table + _varint(1) + _varint(1) + bytes([height]) + _varint(0)
            + _varints([root_off, root_len, *st]) + struct.pack("<Q", time.time_ns())
            + _varint(0))
    rec = _pack(_MANIFEST_MAGIC, body)
    with open(os.path.join(root, MANIFEST), "wb") as f:
        f.write(rec)
    return offset + len(rec)
