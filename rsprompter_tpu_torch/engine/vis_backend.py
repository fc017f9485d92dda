"""Experiment-tracking backends (the mmengine VisBackend surface).

The port's copy of ``rsprompter_tpu/engine/vis_backend.py`` (:20-85).
Reference: ``vis_backends=[dict(type='LocalVisBackend'),
dict(type='WandbVisBackend', init_kwargs=...)]``
(``configs/rsprompter/rsprompter_anchor-whu.py:14-18``). The runner fans
scalar records out to every configured backend. ``WandbVisBackend`` uses the
real wandb client when importable; in air-gapped environments it degrades to
wandb-offline-style JSONL under ``work_dir/wandb/`` so runs stay inspectable
and later syncable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional


class LocalVisBackend:
    """JSONL scalars under work_dir (the mmengine LocalVisBackend analogue)."""

    def __init__(self, work_dir: str, **_):
        os.makedirs(work_dir, exist_ok=True)
        self.path = os.path.join(work_dir, "metrics.jsonl")

    def log_scalars(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def close(self) -> None:
        pass


class WandbVisBackend:
    """W&B experiment logging; offline JSONL fallback without the client.

    init_kwargs follow wandb.init (project/group/name as the reference
    configs set them).
    """

    def __init__(self, work_dir: str, init_kwargs: Optional[Dict] = None, **_):
        self._run = None
        self._fallback = None
        kwargs = dict(init_kwargs or {})
        try:
            import wandb  # optional dependency; absent in this image

            self._run = wandb.init(dir=work_dir, **kwargs)
        except Exception as err:  # ImportError or offline init failure
            wdir = os.path.join(work_dir, "wandb")
            os.makedirs(wdir, exist_ok=True)
            self._fallback = os.path.join(wdir, "offline-run.jsonl")
            with open(self._fallback, "a") as f:
                f.write(json.dumps({
                    "_meta": kwargs, "_started": time.time(),
                    "_reason": f"wandb unavailable: {err.__class__.__name__}",
                }) + "\n")

    def log_scalars(self, record: Dict[str, Any], step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(dict(record), step=step)
        else:
            with open(self._fallback, "a") as f:
                f.write(json.dumps({"_step": step, **record}) + "\n")

    def close(self) -> None:
        if self._run is not None:
            self._run.finish()


_BACKENDS = {
    "LocalVisBackend": LocalVisBackend,
    "WandbVisBackend": WandbVisBackend,
}


def build_vis_backends(cfgs: Optional[List[Dict]], work_dir: str) -> List:
    """Build backends from reference-vocabulary config dicts."""
    out = []
    for c in cfgs or [dict(type="LocalVisBackend")]:
        c = dict(c)
        cls = _BACKENDS[c.pop("type")]
        out.append(cls(work_dir=work_dir, **c))
    return out
