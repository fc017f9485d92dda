"""Build, load and launch the port's hand-written CUDA kernels.

Each kernel is one ``csrc/<name>.cu`` with a plain C entry point. It is
compiled at first use with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at
the repository root (a content hash in the file name keeps a stale library
from being loaded) and bound with ``ctypes``: pointers and the CUDA stream go
as ``c_void_p``, and the C function returns ``cudaGetLastError()``, which
:meth:`CudaKernel.launch` turns into an exception.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Sequence

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


class CudaKernel:
    """One C entry point in one ``.cu`` source, with its launch counts per
    variant (the call site's shape family); their sum is the total."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.variant_launches: Dict[str, int] = {}
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in sorted(CSRC_DIR.glob("*.cuh")) + [self.source]:
            digest.update(path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:12]}.so"

    def build_command(self) -> List[str]:
        out = self.library_path()
        return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(self.source)]

    def load(self):
        with self._lock:
            if self._fn is None:
                path = self.library_path()
                if not path.exists():
                    build([self])
                fn = getattr(ctypes.CDLL(str(path)), self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                self._fn = fn
        return self._fn

    def launch(self, *args, variant: str = "") -> None:
        """Launch on the current stream; raise if CUDA refused the launch.
        ``variant`` names the call site's shape family (e.g. 'window')."""
        fn = self.load()
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: error {err}")
        self.variant_launches[variant] = self.variant_launches.get(variant, 0) + 1

    def reset_counts(self) -> None:
        self.variant_launches = {}


def build(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Compile every missing library at once (one nvcc per source, all
    started together). Returns {kernel name: seconds} for the ones built."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for k in kernels:
        if k.library_path().exists():
            continue
        procs.append((k, time.time(), subprocess.Popen(
            k.build_command(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    times = {}
    errors = []
    for k, t0, proc in procs:
        log, _ = proc.communicate()
        times[k.name] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"{k.source.name}:\n{log}")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return times


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check_cuda_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape=None):
    """Validate what a kernel takes; raise on anything else."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.data_ptr() % 32:
        raise ValueError(f"{name}: expected a 32-byte aligned tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def all_kernels() -> List[CudaKernel]:
    """Every kernel of the port: the encoder layer's forwards in order,
    then their backwards."""
    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    return [
        fm.LN_MLP_RESIDUAL, fm.LN_QKV_HEADMAJOR, fa.RELPOS_ATTENTION,
        fm.LN_MLP_RESIDUAL_BWD, fm.LN_QKV_HEADMAJOR_BWD, fa.RELPOS_ATTENTION_BWD,
    ]
