"""dnnlib-style support utilities (counterpart of `ealdm_tpu/utils/dnn.py`):
`EasyDict`, the stdout/stderr tee `Logger`, `format_time`, the
path-or-cached-URL opener `open_url`, and `print_module_summary`, which
walks an `nn.Module` tree where the JAX package traces a flax init.

`open_url` reads a local path, a file:// URI, or an http(s) URL that a
deployment has already placed in the cache directory; nothing is
downloaded.
"""
from __future__ import annotations

import contextlib
import hashlib
import io
import os
import sys
from typing import IO, Any, List, Optional, Tuple


class EasyDict(dict):
    """dict with attribute access."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]


class _Tee(io.TextIOBase):
    """A writable text stream that fans each write out to several sinks."""

    def __init__(self, *sinks: IO, autoflush: bool = True):
        self._sinks = sinks
        self._autoflush = autoflush

    def writable(self) -> bool:
        return True

    def write(self, text: str) -> int:
        for s in self._sinks:
            s.write(text)
            if self._autoflush:
                s.flush()
        return len(text)

    def flush(self) -> None:
        for s in self._sinks:
            s.flush()


class Logger:
    """Mirror everything printed to stdout/stderr into a log file, through
    redirect_stdout/redirect_stderr around a fan-out stream. Use as a
    context manager, or call close(); `mode="a"` appends."""

    def __init__(self, file_name: Optional[str] = None, mode: str = "w",
                 should_flush: bool = True):
        self._file: Optional[IO] = open(file_name, mode) if file_name is not None else None
        self._stack = contextlib.ExitStack()
        sinks = (self._file,) if self._file is not None else ()
        self._stack.enter_context(contextlib.redirect_stdout(
            _Tee(sys.stdout, *sinks, autoflush=should_flush)))
        self._stack.enter_context(contextlib.redirect_stderr(
            _Tee(sys.stderr, *sinks, autoflush=should_flush)))
        if self._file is not None:
            self._stack.callback(self._file.close)

    def close(self) -> None:
        self._stack.close()
        self._file = None

    def __enter__(self) -> "Logger":
        return self

    def __exit__(self, *_) -> None:
        self.close()


def format_time(seconds: float) -> str:
    """'1d 02h 03m' / '4h 05m 06s' / '1m 05s' / '5s'."""
    s = int(round(seconds))
    if s < 60:
        return f"{s}s"
    if s < 3600:
        return f"{s // 60}m {s % 60:02d}s"
    if s < 86400:
        return f"{s // 3600}h {(s // 60) % 60:02d}m {s % 60:02d}s"
    return f"{s // 86400}d {(s // 3600) % 24:02d}h {(s // 60) % 60:02d}m"


def open_url(url: str, cache_dir: Optional[str] = None, *, return_filename: bool = False):
    """Open a local path, a file:// URI, or a CACHED http(s) URL: a file in
    `cache_dir` (default `$EALDM_CACHE_DIR` or ~/.cache/ealdm) whose name
    starts with the URL's md5. Raises FileNotFoundError naming the expected
    cache entry otherwise."""
    if url.startswith("file://"):
        url = url[len("file://"):]
    if not (url.startswith("http://") or url.startswith("https://")):
        return url if return_filename else open(url, "rb")
    cache_dir = cache_dir or os.environ.get("EALDM_CACHE_DIR",
                                            os.path.expanduser("~/.cache/ealdm"))
    url_md5 = hashlib.md5(url.encode("utf-8")).hexdigest()
    if os.path.isdir(cache_dir):
        for fname in sorted(os.listdir(cache_dir)):
            if fname.startswith(url_md5):
                path = os.path.join(cache_dir, fname)
                return path if return_filename else open(path, "rb")
    raise FileNotFoundError(
        f"zero-egress build: pre-seed '{cache_dir}/{url_md5}_<name>' to use URL {url!r}")


def print_module_summary(module, max_depth: int = 2, file: IO = None) -> str:
    """Parameter table of an `nn.Module` tree: each submodule down to
    `max_depth` with its parameter count, each parameter of a module above
    that depth with its shape, and the total. No forward runs. Returns the
    rendered table (also printed to `file` or stdout)."""
    rows: List[Tuple[str, int, str]] = []

    def visit(mod, prefix, depth):
        for name, p in mod.named_parameters(recurse=False):
            rows.append((f"{prefix}/{name}" if prefix else name, p.numel(), str(tuple(p.shape))))
        for name, child in mod.named_children():
            path = f"{prefix}/{name}" if prefix else name
            n = sum(p.numel() for p in child.parameters())
            if n == 0:
                continue
            rows.append((path, n, ""))
            if depth + 1 < max_depth:
                visit(child, path, depth + 1)

    visit(module, "", 0)
    total = sum(p.numel() for p in module.parameters())
    width = max([len(r[0]) for r in rows] + [6])
    lines = [f"{'module':<{width}}  {'params':>12}  shape"]
    lines += [f"{name:<{width}}  {n:>12,}  {shape}" for name, n, shape in rows]
    lines.append(f"{'TOTAL':<{width}}  {total:>12,}")
    out = "\n".join(lines)
    print(out, file=file or sys.stdout)
    return out
