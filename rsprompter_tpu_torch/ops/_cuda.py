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
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

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
    variant (the call site's shape family); their sum is the total.

    ``f32`` = (source, symbol) names the kernel's fp32 variant (3xTF32 on
    wgmma), an entry point with the same arguments: ``launch(..., f32=True)``
    calls it and counts the launch under the variant's name with ``/f32``
    appended, so one kernel's counts hold both dtypes apart."""

    def __init__(self, name: str, source: str, symbol: str, argtypes: Sequence,
                 f32: Optional[Tuple[str, str]] = None):
        self.name = name
        self.source = CSRC_DIR / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.variant_launches: Dict[str, int] = {}
        self.f32 = CudaKernel(name, *f32, argtypes) if f32 else None
        self._fn = None
        self._lock = threading.Lock()

    def library_path(self) -> Path:
        digest = hashlib.sha256()
        for path in sorted(CSRC_DIR.glob("*.cuh")) + [self.source]:
            digest.update(path.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{digest.hexdigest()[:12]}.so"

    def build_command(self, out: Path) -> List[str]:
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

    def launch(self, *args, variant: str = "", f32: bool = False) -> None:
        """Launch on the current stream; raise if CUDA refused the launch.
        ``variant`` names the call site's shape family (e.g. 'window');
        ``f32`` launches the fp32 variant (counted as ``variant + '/f32'``)."""
        entry = self.f32 if f32 else self
        fn = entry._fn or entry.load()
        err = fn(*args, _current_stream())
        if err != 0:
            raise RuntimeError(f"CUDA kernel {entry.symbol} failed to launch: error {err}")
        key = variant + "/f32" if f32 else variant
        self.variant_launches[key] = self.variant_launches.get(key, 0) + 1

    def reset_counts(self) -> None:
        self.variant_launches = {}


def _current_stream() -> int:
    """The current CUDA stream's handle, without building a Stream object
    where this PyTorch exposes the raw getter (a few microseconds a launch)."""
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    if raw is not None:
        return raw(torch.cuda.current_device())
    return torch.cuda.current_stream().cuda_stream


def build(kernels: Iterable[CudaKernel]) -> Dict[str, float]:
    """Compile every missing library of ``kernels`` and their fp32 variants
    at once (one nvcc per source, all started together). Returns {source
    name: seconds} for the ones built."""
    import time

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    started = set()  # kernels that share a source share its library
    entries = [e for k in kernels for e in (k, k.f32) if e is not None]
    for k in entries:
        if k.library_path().exists() or k.source in started:
            continue
        started.add(k.source)
        # build under a name of this process, then rename: ranks that build
        # at once never load a half-written library
        tmp = k.library_path().with_suffix(f".{os.getpid()}.tmp")
        procs.append((k, tmp, time.time(), subprocess.Popen(
            k.build_command(tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )))
    times = {}
    errors = []
    for k, tmp, t0, proc in procs:
        log, _ = proc.communicate()
        times[k.source.stem] = time.time() - t0
        if proc.returncode != 0:
            errors.append(f"{k.source.name}:\n{log}")
        else:
            os.replace(tmp, k.library_path())
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return times


def ptr(t: torch.Tensor) -> int:
    """A tensor's device address, for a ``c_void_p`` argument."""
    return t.data_ptr()


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the forward kernels' two variants


def operand_dtype(what: str, x: torch.Tensor, *others: torch.Tensor) -> torch.dtype:
    """The one dtype of a kernel's activations ``x`` and its weights and
    biases ``others``: bf16 or fp32 (the fp32 variant). Raises, before any
    device check or launch, on another dtype or on a mix."""
    dt = x.dtype
    if dt not in KERNEL_DTYPES:
        raise ValueError(f"{what}: x is {dt}; the kernels take bf16 or fp32")
    mixed = sorted({str(t.dtype) for t in others if t.dtype != dt})
    if mixed:
        raise ValueError(f"{what}: x is {dt} but weights or biases are {mixed}: one dtype "
                         "for x, its weights and biases")
    return dt


def backward_bf16(what: str, dt: torch.dtype) -> None:
    """The backward kernels take bf16 only (their fp32 variants are to
    come): an fp32 encoder that takes gradients runs the bf16 forwards."""
    if dt != torch.bfloat16:
        raise ValueError(f"{what}: the backward kernel takes bf16, got {dt}")


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
    if shape is not None and t.shape != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def all_kernels() -> List[CudaKernel]:
    """Every kernel of the port: the encoder layer's forwards in order
    (kernel B's row pass, then its GEMM), then their backwards, then the
    'flash' route's K12'. A forward's fp32 variant rides on it (``.f32``):
    ``build`` builds both, and its launches count in the same kernel."""
    from rsprompter_tpu_torch.ops import fused_mlp as fm
    from rsprompter_tpu_torch.ops import fused_vit_attention as fa

    return [
        fm.LN_MLP_RESIDUAL, fm.LN_ROWS, fm.LN_QKV_HEADMAJOR, fa.RELPOS_ATTENTION,
        fm.LN_MLP_RESIDUAL_BWD, fm.LN_QKV_HEADMAJOR_BWD, fa.RELPOS_ATTENTION_BWD,
        fm.QKV_HEADMAJOR,
    ]
