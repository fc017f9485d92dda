"""Robustness benchmark: evaluate under image corruptions, report mPC and rPC.

    python -m rsprompter_tpu_torch.tools.analysis_tools.test_robustness CONFIG [CKPT] \\
        [--corruptions gaussian_noise jpeg_compression ...] [--severities 1 3 5] \\
        [--metric bbox_mAP] [--out robustness.json] [--cfg-options ...] \\
        [--device cuda|cpu]

The port's counterpart of the JAX package's
``tools/analysis_tools/test_robustness.py`` (the reference's
``test_robustness.py`` + ``robustness_eval.py``, the COCO-C protocol): one
clean evaluation, then one a corruption and severity, each
``python -m rsprompter_tpu_torch.tools.test CONFIG --corruption NAME
--severity S`` in a process of its own, its ``coco/METRIC`` read from the
printout; then

  P    the clean AP
  mPC  the mean AP over corruptions x severities
  rPC  mPC / P

written as JAX writes them (``--out``: {"clean", "per_corruption", "mPC",
"rPC"}). The corruptions are ``data.corruptions``'. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
from typing import Any, Dict, Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.data.corruptions import CORRUPTIONS

# the repository's root: the child process imports the package from there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
METRIC_LINE = re.compile(r"^(coco/\S+): ([-\d.naef]+)$")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="corruption robustness benchmark")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--corruptions", nargs="+", default=list(CORRUPTIONS), choices=CORRUPTIONS)
    p.add_argument("--severities", nargs="+", type=int, default=[1, 2, 3, 4, 5],
                   choices=range(1, 6))
    p.add_argument("--metric", default="bbox_mAP")
    p.add_argument("--out", default=None, help="write the results as JSON here")
    p.add_argument("--cfg-options", nargs="+", default=None)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def run_eval(config: str, checkpoint: Optional[str], metric: str, device: str,
             corruption: Optional[str] = None, severity: int = 1,
             cfg_options: Optional[Sequence[str]] = None) -> float:
    """One ``tools.test`` process -> its ``coco/{metric}``."""
    cmd = [sys.executable, "-m", "rsprompter_tpu_torch.tools.test", config]
    if checkpoint:
        cmd.append(checkpoint)
    if corruption:
        cmd += ["--corruption", corruption, "--severity", str(severity)]
    if cfg_options:
        cmd += ["--cfg-options", *cfg_options]
    cmd += ["--device", device]
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (ROOT, env.get("PYTHONPATH")) if p)
    out = subprocess.run(cmd, capture_output=True, text=True, env=env)
    if out.returncode != 0:
        raise RuntimeError(f"eval failed ({corruption}/{severity}):\n"
                           f"{out.stdout[-2000:]}\n{out.stderr[-2000:]}")
    metrics = {}
    for line in out.stdout.splitlines():
        m = METRIC_LINE.match(line.strip())
        if m:
            metrics[m.group(1)] = float(m.group(2))
    key = f"coco/{metric}"
    if key not in metrics:
        raise RuntimeError(f"metric {key} not in output: {sorted(metrics)}")
    return metrics[key]


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    args = parse_args(argv)
    run = dict(metric=args.metric, device=args.device, cfg_options=args.cfg_options)
    clean = run_eval(args.config, args.checkpoint, **run)
    print(f"clean {args.metric}: {clean:.4f}", flush=True)
    results: Dict[str, Any] = {"clean": clean, "per_corruption": {}}
    for c in args.corruptions:
        per_sev = []
        for s in args.severities:
            ap = run_eval(args.config, args.checkpoint, corruption=c, severity=s, **run)
            per_sev.append(ap)
            print(f"{c} s{s}: {ap:.4f}", flush=True)
        results["per_corruption"][c] = per_sev
    mpc = float(np.mean([ap for v in results["per_corruption"].values() for ap in v]))
    results["mPC"] = mpc
    results["rPC"] = mpc / clean if clean > 0 else float("nan")
    print(f"P (clean) = {clean:.4f}  mPC = {mpc:.4f}  rPC = {results['rPC']:.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        print(f"saved {args.out}")
    return results


if __name__ == "__main__":
    main()
