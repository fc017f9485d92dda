"""RLE mask encoding and mask IoU through the port's native C++ library.

Counterpart of ``rsprompter_tpu/evaluation/rle.py`` (``RLE`` :73,
``encode_masks`` :98, ``decode_mask`` :129, ``_pack`` :150, ``iou_matrix``
:162): pycocotools' semantics (column-major runs that start with a 0-run;
crowd GTs scored as intersection over the detection's area).

The library is the port's copy of the C++ source,
``rsprompter_tpu_torch/native/rle.cpp``, built at first use with the host
compiler into ``build/native/`` at the repository root (``utils/native.py``).
A build or load that fails raises with the compiler's output: there is no
fallback. The numpy functions ``*_plain`` below are the plain versions the
tests hold the library against; nothing on the evaluation path calls them.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from rsprompter_tpu_torch.utils import native

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE_DIR / "native" / "rle.cpp"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "native"

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u32p = ctypes.POINTER(ctypes.c_uint32)
_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_SIGNATURES = {
    "rle_encode_batch": (None, [_u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u32p, _i64p]),
    "rle_iou_matrix": (None, [_u32p, _i64p, ctypes.c_int, _u32p, _i64p, ctypes.c_int, _u8p,
                              _f64p]),
    "rle_decode": (None, [_u32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, _u8p]),
    "rle_area": (ctypes.c_uint64, [_u32p, ctypes.c_int]),
    "match_image": (None, [_f64p, ctypes.c_int, ctypes.c_int, _u8p, _u8p, _f64p,
                           ctypes.c_int, _i64p, _u8p]),
}
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> Path:
    return native.library_path(SOURCE, BUILD_DIR)


def build_library() -> Path:
    """Compile the source where its library is missing; raise with the
    compiler's output if that fails. Returns the library's path."""
    return native.build_library(SOURCE, BUILD_DIR)


def load_library() -> ctypes.CDLL:
    """The RLE library, built and loaded once per process."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = native.load_library(SOURCE, BUILD_DIR, _SIGNATURES)
    return _lib


class RLE:
    """One encoded mask: (h, w, counts uint32 array)."""

    __slots__ = ("h", "w", "counts")

    def __init__(self, h: int, w: int, counts: np.ndarray):
        self.h, self.w = h, w
        self.counts = np.ascontiguousarray(counts, np.uint32)

    def area(self) -> int:
        return int(self.counts[1::2].sum())

    def to_coco(self) -> dict:
        """pycocotools-style dict (uncompressed counts list)."""
        return {"size": [self.h, self.w], "counts": self.counts.tolist()}

    @staticmethod
    def from_coco(d: dict) -> "RLE":
        h, w = d["size"]
        counts = d["counts"]
        if isinstance(counts, (bytes, str)):
            raise ValueError("compressed RLE strings not supported; use lists")
        return RLE(h, w, np.asarray(counts, np.uint32))


def encode_masks(masks: np.ndarray) -> List[RLE]:
    """(N, H, W) bool/uint8 -> list of RLE."""
    masks = np.ascontiguousarray(np.asarray(masks).astype(np.uint8))
    n, h, w = masks.shape
    if n == 0:
        return []
    lib = load_library()
    counts = np.empty(n * (h * w + 1), np.uint32)
    offsets = np.empty(n + 1, np.int64)
    lib.rle_encode_batch(masks.ctypes.data_as(_u8p), n, h, w, counts.ctypes.data_as(_u32p),
                         offsets.ctypes.data_as(_i64p))
    return [RLE(h, w, counts[offsets[i]:offsets[i + 1]].copy()) for i in range(n)]


def decode_mask(rle: RLE) -> np.ndarray:
    out = np.zeros((rle.h, rle.w), np.uint8)
    load_library().rle_decode(rle.counts.ctypes.data_as(_u32p), len(rle.counts), rle.h,
                              rle.w, out.ctypes.data_as(_u8p))
    return out


def _pack(rles: Sequence[RLE]) -> Tuple[np.ndarray, np.ndarray]:
    counts = np.concatenate([r.counts for r in rles]) if rles else np.zeros(0, np.uint32)
    offsets = np.zeros(len(rles) + 1, np.int64)
    np.cumsum([len(r.counts) for r in rles], out=offsets[1:])
    return np.ascontiguousarray(counts), offsets


def iou_matrix(dets: Sequence[RLE], gts: Sequence[RLE],
               iscrowd: Optional[Sequence[bool]] = None) -> np.ndarray:
    """(D, G) IoU (crowd GTs -> intersection over the detection's area)."""
    d, g = len(dets), len(gts)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    crowd = np.ascontiguousarray(iscrowd if iscrowd is not None else np.zeros(g, bool),
                                 np.uint8)
    dc, do = _pack(dets)
    gc, go = _pack(gts)
    out = np.zeros((d, g), np.float64)
    load_library().rle_iou_matrix(
        dc.ctypes.data_as(_u32p), do.ctypes.data_as(_i64p), d, gc.ctypes.data_as(_u32p),
        go.ctypes.data_as(_i64p), g, crowd.ctypes.data_as(_u8p), out.ctypes.data_as(_f64p))
    return out


# --- plain versions (numpy), held against the library by the tests ---------


def encode_masks_plain(masks: np.ndarray) -> List[RLE]:
    out = []
    for m in np.asarray(masks).astype(np.uint8):
        h, w = m.shape
        flat = m.T.reshape(-1) != 0
        changes = np.flatnonzero(flat[1:] != flat[:-1]) + 1
        runs = np.diff(np.concatenate([[0], changes, [flat.size]])).astype(np.uint32)
        if flat.size and flat[0]:
            runs = np.concatenate([[np.uint32(0)], runs])
        out.append(RLE(h, w, runs))
    return out


def decode_mask_plain(rle: RLE) -> np.ndarray:
    runs = np.arange(len(rle.counts), dtype=np.int64) % 2  # 0-run, 1-run, ...
    flat = np.repeat(runs.astype(np.uint8), rle.counts.astype(np.int64))
    return flat.reshape(rle.w, rle.h).T


def iou_matrix_plain(dets: Sequence[RLE], gts: Sequence[RLE],
                     iscrowd: Optional[Sequence[bool]] = None) -> np.ndarray:
    d, g = len(dets), len(gts)
    if d == 0 or g == 0:
        return np.zeros((d, g))
    crowd = np.asarray(iscrowd if iscrowd is not None else np.zeros(g, bool), bool)
    dm = np.stack([decode_mask_plain(r).reshape(-1) for r in dets]).astype(np.float64)
    gm = np.stack([decode_mask_plain(r).reshape(-1) for r in gts]).astype(np.float64)
    inter = dm @ gm.T
    da = dm.sum(1)[:, None]
    union = np.where(crowd[None, :], da, da + gm.sum(1)[None, :] - inter)
    return np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
