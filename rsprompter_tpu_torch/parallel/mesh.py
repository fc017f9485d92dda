"""The config's ``dist`` section: data parallelism over the ranks.

Counterpart of ``rsprompter_tpu/parallel/mesh.py`` (``mesh_from_config``
:109-128). JAX builds a ``(data, model)`` mesh over every visible device;
the port's mesh is the process group, one rank per GPU, so the ``data`` axis
is the world size and ZeRO shards AdamW's moments over it
(``torch.distributed.optim.ZeroRedundancyOptimizer``, JAX's
``zero_shardings`` :84-101). The ``model`` (TP) axis is not ported (ROADMAP,
"Do not port").
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Tuple

import torch.distributed as dist

from rsprompter_tpu_torch.parallel.distributed import LAUNCH_HINT, world_size


def mesh_from_config(dist_cfg: Optional[Mapping[str, Any]] = None) -> Tuple[int, bool]:
    """``dist`` (``enable``: default on under a launcher of more than one
    process; ``zero``: shard AdamW's moments, default True;
    ``model_parallel``: only 1) -> (world size, ZeRO switch).

    Raises for ``model_parallel`` > 1, for ``enable=True`` in a run that was
    not launched as a process group (it says how to launch one: the run
    never quietly trains on one card), and for ``enable=False`` under a
    launcher of more than one process."""
    dist_cfg = dict(dist_cfg or {})
    n_model = int(dist_cfg.get("model_parallel", 1))
    if n_model > 1:
        raise NotImplementedError(
            f"dist.model_parallel={n_model}: tensor parallelism is not ported "
            "(ROADMAP, 'Do not port'); data parallelism takes model_parallel=1")
    world = world_size()
    enable = dist_cfg.get("enable")
    if enable and not dist.is_initialized():
        raise RuntimeError(f"dist.enable=True needs one process per GPU: launch with {LAUNCH_HINT}")
    if enable is False and world > 1:
        raise ValueError(f"dist.enable=False under a launcher of {world} processes")
    return world, bool(dist_cfg.get("zero", True))

