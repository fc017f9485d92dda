"""Build and load the port's host-side C++ libraries (``native/*.cpp``).

A source is compiled at first use with the host compiler into ``build_dir``
(``build/native/`` at the repository root for the port's libraries), a
content hash of the source and the flags in the file name, and bound with
``ctypes``. A build or load that fails raises with the compiler's output:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def library_path(source: Path, build_dir: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return build_dir / f"lib{source.stem}-{digest.hexdigest()[:12]}.so"


def build_library(source: Path, build_dir: Path) -> Path:
    """Compile ``source`` where its library is missing; raise with the
    compiler's output if that fails. Returns the library's path."""
    path = library_path(source, build_dir)
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found: {source.name} cannot be built")
    build_dir.mkdir(parents=True, exist_ok=True)
    # build under a name of this process, then rename: workers that build at
    # once never load a half-written file
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {source.name} failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


def load_library(source: Path, build_dir: Path,
                 signatures: Dict[str, Tuple[object, Sequence]]) -> ctypes.CDLL:
    """Build ``source`` where needed, load it and declare each function's
    ``(restype, argtypes)``."""
    path = build_library(source, build_dir)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as err:
        raise RuntimeError(f"loading {path} failed: {err}") from err
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, list(argtypes)
    return lib
