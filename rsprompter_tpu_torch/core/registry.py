"""Registry-lite: string -> constructor maps driving the config system.

The port's copy of ``rsprompter_tpu/core/registry.py`` (``Registry`` :15),
which replaces the reference's scoped mmengine registries with plain dicts.
A config node ``{"type": "Name", ...}`` is built by looking up ``Name`` and
calling the constructor with the remaining keys. The port registers its
datasets (``data/coco.py``) and its metric (``evaluation/coco_metric.py``).
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Dict, Optional


class Registry:
    """A minimal name -> constructor registry with config-driven build."""

    def __init__(self, name: str):
        self.name = name
        self._registry: Dict[str, Callable] = {}

    def register_module(self, name: Optional[str] = None, module: Optional[Callable] = None):
        """Register a class/function, usable as decorator or direct call."""
        if module is not None:
            key = name or module.__name__
            self._registry[key] = module
            return module

        def _decorator(cls):
            key = name or cls.__name__
            self._registry[key] = cls
            return cls

        return _decorator

    def get(self, key: str) -> Callable:
        if key not in self._registry:
            raise KeyError(
                f"'{key}' is not registered in registry '{self.name}'. "
                f"Available: {sorted(self._registry)}"
            )
        return self._registry[key]

    def __contains__(self, key: str) -> bool:
        return key in self._registry

    def build(self, cfg: Any, **extra_kwargs) -> Any:
        """Build an object from a config dict ``{"type": name, **kwargs}``.

        Already-constructed objects (anything without a ``type`` key or not a
        dict) pass through unchanged, mirroring mmengine's behavior.
        """
        if cfg is None:
            return None
        if not isinstance(cfg, dict):
            return cfg
        cfg = dict(cfg)
        type_key = cfg.pop("type", None)
        if type_key is None:
            raise KeyError(f"cfg for registry '{self.name}' has no 'type': {cfg}")
        if isinstance(type_key, str):
            ctor = self.get(type_key)
        else:
            ctor = type_key
        kwargs = {**cfg, **extra_kwargs}
        try:
            return ctor(**kwargs)
        except TypeError as e:
            sig = None
            try:
                sig = str(inspect.signature(ctor))
            except (TypeError, ValueError):
                pass
            raise TypeError(f"Failed to build {type_key}{sig or ''}: {e}") from e


DATASETS = Registry("datasets")
METRICS = Registry("metrics")
