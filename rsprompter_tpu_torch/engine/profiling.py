"""Profiling and debugging helpers.

Counterpart of ``rsprompter_tpu/engine/profiling.py``, the analogue of the
reference's ``MemoryProfilerHook`` / ``IterTimerHook``:

- ``trace(dir)``: a ``torch.profiler`` context over the CPU and, where there
  is one, the card, that writes a Chrome trace (``trace.json``) into
  ``dir`` as it closes;
- ``enable_nan_checks()``: forward hooks on every module of a model that
  raise ``FloatingPointError`` naming the first module whose output holds a
  NaN or an infinity, and autograd's anomaly mode for the backward, as
  ``jax_debug_nans`` raises at the operation that made one;
  ``enable_nan_checks(model, False)`` takes them off again;
- ``device_memory_stats()``: per card, ``bytes_in_use``,
  ``peak_bytes_in_use`` and ``bytes_limit`` from ``torch.cuda``;
- ``StepTimer``: smoothed steps a second after a warm-up, JAX's.

The NaN hooks read each output on the host, a wait on the card at every
module: a debugging aid, not for timed runs.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Dict, Iterator, Optional

import torch

_HOOKS = "_nan_check_hooks"


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensors(out) -> Iterator[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        yield out
    elif isinstance(out, dict):
        for v in out.values():
            yield from _tensors(v)
    elif isinstance(out, (tuple, list)):
        for v in out:
            yield from _tensors(v)


def enable_nan_checks(model: torch.nn.Module, enable: bool = True) -> None:
    for handle in getattr(model, _HOOKS, ()):
        handle.remove()
    setattr(model, _HOOKS, [])
    torch.autograd.set_detect_anomaly(enable)
    if not enable:
        return
    names = {m: n or type(model).__name__ for n, m in model.named_modules()}

    def check(module, _inputs, output):
        for t in _tensors(output):
            if t.is_floating_point() and not bool(torch.isfinite(t).all()):
                raise FloatingPointError(
                    f"non-finite output of {names[module]} ({type(module).__name__})")

    getattr(model, _HOOKS).extend(m.register_forward_hook(check) for m in model.modules())


def device_memory_stats() -> Dict[str, Dict[str, int]]:
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        out[f"cuda:{i}"] = {
            "bytes_in_use": torch.cuda.memory_allocated(i),
            "peak_bytes_in_use": torch.cuda.max_memory_allocated(i),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out


class StepTimer:
    def __init__(self, window: int = 50, warmup: int = 2):
        self._times = deque(maxlen=window)
        self._warmup = warmup
        self._count = 0
        self._last: Optional[float] = None

    def tick(self) -> None:
        now = time.perf_counter()
        self._count += 1
        if self._last is not None and self._count > self._warmup:
            self._times.append(now - self._last)
        self._last = now

    @property
    def steps_per_sec(self) -> float:
        if not self._times:
            return 0.0
        return len(self._times) / sum(self._times)
