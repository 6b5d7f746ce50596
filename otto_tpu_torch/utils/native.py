"""Build and load the package's native host libraries.

The C++ sources in ``otto_tpu_torch/native/`` (the segment-stats engine,
the JSONL parser and the submission writer) are compiled by ``g++`` at
their first use into ``otto_tpu_torch/_build/lib<stem>_<hash>.so``, the
hash taken over the source and the flags so that an edited source is
rebuilt, and loaded with ctypes.  A failed build raises with the compiler's
output: nothing falls back quietly.  Each caller offers its own Python
route, which runs only when asked for by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_loaded: dict[Path, ctypes.CDLL] = {}


def library_path(source: str, stem: str, libs: tuple[str, ...] = ()) -> Path:
    """Where the library built from ``native/<source>`` lives: named by a
    hash of the source, the flags and the libraries it links."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + libs).encode())
    h.update((NATIVE_DIR / source).read_bytes())
    return BUILD_DIR / f"lib{stem}_{h.hexdigest()[:16]}.so"


def load_library(source: str, stem: str, libs: tuple[str, ...] = (), *,
                 python_route: str) -> ctypes.CDLL:
    """Build (``g++``, first use) and load ``native/<source>``.  Raises
    ``RuntimeError`` with the compiler's output if the build fails;
    ``python_route`` names the call that skips the library, for the
    message."""
    path = library_path(source, stem, libs)
    with _lock:
        if path in _loaded:
            return _loaded[path]
        if not path.exists():
            path.parent.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(NATIVE_DIR / source), *libs]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"g++ not found: native/{source} cannot be built "
                                   f"({python_route} skips it)") from e
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                                   f"{proc.stdout}\n{proc.stderr}\n({python_route} skips "
                                   "the native library)")
            os.replace(tmp, path)  # atomic: concurrent builds write their own tmp
        lib = ctypes.CDLL(str(path))
        _loaded[path] = lib
    return lib
