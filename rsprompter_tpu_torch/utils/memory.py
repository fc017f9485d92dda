"""OOM guard: on CUDA out of memory, halve the batch and run the halves.

Counterpart of ``rsprompter_tpu/utils/memory.py`` (``is_oom_error`` :21,
``oom_guard`` :34, ``convert_batch_bf16`` :70), the analogue of the
reference's ``AvoidOOM`` (``mmdet/utils/memory.py:78``). On the card the
recoverable failure is the caching allocator's ``torch.cuda.OutOfMemoryError``
(or a library's "out of memory"); the batch dict is split in two along
dim 0, the cache emptied, and the halves run one after the other, so the
peak activation memory follows the half. ``evaluation.loop.evaluate``, which
``tools.test`` and the train runner's validation share, guards its
predict, as JAX guards both (``tools/test.py:202-204``,
``engine/runner.py:252-254``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Sequence

import torch


def is_oom_error(err: BaseException) -> bool:
    return isinstance(err, torch.cuda.OutOfMemoryError) or (
        isinstance(err, RuntimeError) and "out of memory" in str(err).lower())


def _concat(parts: Sequence[Any]):
    """The halves' outputs joined along dim 0: tensors, and tuples
    (named or not), lists and dicts of them."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.cat(list(parts), 0)
    if isinstance(first, dict):
        return {k: _concat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*[_concat(xs) for xs in zip(*parts)])
    if isinstance(first, (tuple, list)):
        return type(first)(_concat(xs) for xs in zip(*parts))
    raise TypeError(f"oom_guard cannot join outputs of type {type(first).__name__}")


def oom_guard(fn: Callable, min_batch: int = 1) -> Callable:
    """Wrap ``fn(*leading_args, batch)`` with recursive batch halving on OOM.

    ``batch`` (the last positional argument) is a dict of tensors sharing
    dim 0. Outputs of the halves are joined along dim 0. Errors that are
    not OOM, and an OOM at ``min_batch`` or fewer, propagate unchanged."""

    def run(*args):
        *lead, batch = args

        def attempt(part: Dict[str, torch.Tensor]):
            n = next(iter(part.values())).shape[0]
            try:
                return fn(*lead, part)
            except RuntimeError as err:
                if not is_oom_error(err) or n <= min_batch:
                    raise
            # retried outside the handler, so that the failed call's frames
            # (and the tensors they hold) are released first
            mid = n // 2
            print(f"oom_guard: CUDA out of memory at batch {n}; retrying as {mid}+{n - mid}",
                  flush=True)
            torch.cuda.empty_cache()
            left = attempt({k: v[:mid] for k, v in part.items()})
            right = attempt({k: v[mid:] for k, v in part.items()})
            return _concat([left, right])

        return attempt(batch)

    return run


def convert_batch_bf16(batch: Dict[str, Any]) -> Dict[str, Any]:
    """Floating tensors -> bf16 (the AMP-fallback half of ``AvoidOOM``)."""
    return {k: v.to(torch.bfloat16) if isinstance(v, torch.Tensor) and v.is_floating_point()
            else v for k, v in batch.items()}
