"""The detectors' three-mode forward (the reference's
``mmdet/models/detectors/base.py:59-99`` contract).

``forward(batch, mode=...)`` dispatches to the detector's ``loss`` (which
takes the samplers' ``generator`` or ``draws``), ``predict`` or ``tensor``
(the raw outputs, JAX's ``method='tensor'``). It is the one entry that
``DistributedDataParallel`` synchronises through, so the train step calls
the module with ``mode='loss'``.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

MODES = ("loss", "predict", "tensor")


class ThreeModeDetector(nn.Module):
    def forward(self, batch: Dict[str, torch.Tensor], mode: str = "tensor", **kwargs: Any):
        if mode == "loss":
            return self.loss(batch, **kwargs)
        if kwargs:
            raise TypeError(f"mode={mode!r} takes no {sorted(kwargs)}")
        if mode == "predict":
            return self.predict(batch)
        if mode == "tensor":
            return self.tensor(batch)
        raise ValueError(f"mode={mode!r}: one of {MODES}")
