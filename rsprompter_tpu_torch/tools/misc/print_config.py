"""Print a config after ``_base_`` inheritance and ``--cfg-options``.

    python -m rsprompter_tpu_torch.tools.misc.print_config CONFIG [--cfg-options k=v ...]

The port's counterpart of the JAX package's ``tools/misc/print_config.py``
(:20-30): ``Config.fromfile`` (``core/config.py``), then
``merge_from_options``, printed as ``json.dumps(dict(cfg), indent=2,
default=repr)``; its text is the JAX tool's.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence

from rsprompter_tpu_torch.core.config import Config


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description="print the resolved config")
    p.add_argument("config")
    p.add_argument("--cfg-options", nargs="+", default=None)
    args = p.parse_args(argv)
    cfg = Config.fromfile(args.config)
    cfg.merge_from_options(args.cfg_options)
    print(json.dumps(dict(cfg), indent=2, default=repr))


if __name__ == "__main__":
    main()
