"""Process groups for data parallelism: one process per GPU, launched by
``python -m torch.distributed.run`` (torchrun).

Counterpart of ``rsprompter_tpu/parallel/distributed.py``. JAX runs one
program over a ``data`` mesh; here every rank runs the step on its own
``b`` images and the ranks meet in collectives, so that the step computes
what one process computes on the global batch of ``world * b`` images, the
ranks' batches concatenated in rank order (JAX's ``local_batch_to_global``,
:76). The helpers below are what the model and the loops use for that, and
each is the identity, with no collective, at world 1:

- :func:`local_rows`: a rank's rows of a draw made for the global batch
  (every rank draws the same uniforms from a generator seeded alike);
- :func:`global_count`: a loss normaliser summed over the global batch,
  divided by the world size, so that DDP's mean of the ranks' gradients is
  the global gradient (MMDetection's ``reduce_mean(avg_factor)``);
- :func:`all_reduce_sum`: a differentiable sum over the ranks (its backward
  sums the gradients), which BatchNorm's statistics go through;
- :func:`all_reduce_mean`, :func:`barrier`, :func:`all_gather_object`,
  :func:`broadcast_object`.
"""

from __future__ import annotations

import datetime
import os
from typing import Any, Dict, List, Optional

import torch
import torch.distributed as dist

LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
LAUNCH_HINT = ("python -m torch.distributed.run --nproc_per_node N "
               "-m rsprompter_tpu_torch.tools.train CONFIG")


def initialize(device: str = "cuda", backend: Optional[str] = None,
               init_method: Optional[str] = None, world_size: Optional[int] = None,
               rank: Optional[int] = None, allow_single_process: Optional[bool] = None,
               timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group that torchrun (or the arguments) describe and
    return this rank's device: ``cuda:LOCAL_RANK`` (or the index ``device``
    names, as ``'cuda:0'`` for two ranks on one card), made the current
    device, or the CPU.

    torchrun's ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` are read through ``init_method='env://'``; arguments
    take their place (a ``file://`` or ``tcp://`` ``init_method``,
    ``world_size``, ``rank``). The backend is NCCL on ``cuda`` and gloo on
    the CPU, or ``backend`` where given (gloo on ``cuda``: two ranks on one
    card, which NCCL refuses).

    Failure policy (JAX :19-66): where the environment or the arguments ask
    for a process group, a failed init raises; it never quietly trains on
    one device. Without such a request the run is single-process (no
    group), unless ``allow_single_process=False``, which then raises."""
    intent = (any(k in os.environ for k in LAUNCHER_ENV) or init_method is not None
              or world_size is not None)
    if allow_single_process is None:
        allow_single_process = not intent
    dev = torch.device(device)
    if dist.is_initialized():
        return _device(dev.type)
    if not intent:
        if not allow_single_process:
            raise RuntimeError(f"no process group was asked for: launch with {LAUNCH_HINT}")
        return dev
    if dev.type == "cuda":  # before NCCL's init, which binds to the current device
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    kw: Dict[str, Any] = {}
    if timeout_s is not None:
        kw["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world_size if world_size else -1,
        rank=rank if rank is not None else -1, **kw)
    return _device(dev.type)


def _device(dev_type: str) -> torch.device:
    if dev_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def shutdown() -> None:
    """Leave the process group, where one was joined."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main() -> bool:
    """Rank 0, which alone logs and writes."""
    return rank() == 0


def process_info() -> Dict[str, Any]:
    return dict(rank=rank(), world_size=world_size(),
                local_rank=int(os.environ.get("LOCAL_RANK", 0)),
                backend=dist.get_backend() if dist.is_initialized() else None)


def barrier() -> None:
    if world_size() > 1:
        dist.barrier()


def local_rows(x: torch.Tensor, dim: int, n_local: int) -> torch.Tensor:
    """Rows ``[rank * n_local, (rank + 1) * n_local)`` of ``x`` along
    ``dim``: this rank's share of a draw made for the global batch."""
    world = world_size()
    if world == 1:
        return x
    if x.shape[dim] != world * n_local:
        raise ValueError(f"a global draw of {x.shape[dim]} rows along dim {dim}; "
                         f"expected {world} ranks x {n_local}")
    return x.narrow(dim, rank() * n_local, n_local)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the ranks; differentiable: each rank's gradient
    is the sum of every rank's gradient of the result, which makes DDP's
    mean the global batch's gradient."""
    return _AllReduceSum.apply(x) if world_size() > 1 else x


def global_count(count: torch.Tensor) -> torch.Tensor:
    """A loss normaliser counted over the global batch, at least 1, divided
    by the world size (JAX divides by the global count: a rank's loss then
    is ``world`` times its share of the global loss, and DDP averages).
    ``count.clamp(min=1.0)`` at world 1."""
    world = world_size()
    if world == 1:
        return count.clamp(min=1.0)
    total = count.detach().clone()
    dist.all_reduce(total)
    return total.clamp(min=1.0) / world


def all_reduce_mean(x: torch.Tensor) -> torch.Tensor:
    """The mean of ``x`` over the ranks (no gradient)."""
    world = world_size()
    if world == 1:
        return x
    y = x.detach().clone()
    dist.all_reduce(y)
    return y / world


def all_gather_object(obj: Any) -> List[Any]:
    """Every rank's ``obj``, in rank order; ``[obj]`` at world 1."""
    world = world_size()
    if world == 1:
        return [obj]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, obj)
    return out


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """Rank ``src``'s ``obj`` on every rank."""
    if world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]
