"""Training logs: loss and metric curves, and iteration-time statistics.

    python -m rsprompter_tpu_torch.tools.analysis_tools.analyze_logs plot_curve \\
        LOG.jsonl [LOG2.jsonl ...] --keys loss coco/bbox_mAP --out curves.png
    python -m rsprompter_tpu_torch.tools.analysis_tools.analyze_logs cal_train_time LOG.jsonl

The port's copy of the JAX package's ``tools/analysis_tools/analyze_logs.py``
(the reference's ``plot_curve`` and ``cal_train_time``), which imports no
JAX, over the port's runner's ``WORK_DIR/metrics.jsonl``
(``engine.vis_backend.LocalVisBackend``), whose records have the same keys:

  train lines: {"epoch", "iter", "loss", "loss_*", "it_per_s", "lr", ...}
  eval  lines: {"epoch", "coco/bbox_mAP", "coco/segm_mAP", ...}

Plots with matplotlib where it imports; otherwise prints a table an epoch
(the card's machine has no matplotlib).
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict
from typing import Optional, Sequence

import numpy as np


def load_log(path):
    """-> list of record dicts (one per JSONL line)."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                records.append(json.loads(line))
    return records


def series_for_key(records, key):
    """-> (x, y) where x is a fractional-epoch coordinate.

    Train keys appear on iter lines (x = epoch + within-epoch fraction by
    line order); eval keys appear once per validated epoch (x = epoch + 1,
    matching the reference's end-of-epoch convention).
    """
    per_epoch = defaultdict(list)
    for r in records:
        if key in r:
            per_epoch[r.get("epoch", 0)].append(float(r[key]))
    xs, ys = [], []
    for ep in sorted(per_epoch):
        vals = per_epoch[ep]
        n = len(vals)
        for i, v in enumerate(vals):
            xs.append(ep + (i + 1) / n if n > 1 else ep + 1)
            ys.append(v)
    return np.asarray(xs), np.asarray(ys)


def plot_curve(args):
    logs = [load_log(p) for p in args.json_logs]
    legend = args.legend or [
        f"{p}:{k}" for p in args.json_logs for k in args.keys
    ]
    assert len(legend) == len(args.json_logs) * len(args.keys), (
        f"--legend needs {len(args.json_logs) * len(args.keys)} entries"
    )
    curves = []
    li = 0
    for path, records in zip(args.json_logs, logs):
        for key in args.keys:
            x, y = series_for_key(records, key)
            if x.size == 0:
                raise KeyError(f"{path} has no records with key {key!r}")
            curves.append((legend[li], x, y))
            li += 1

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        # no matplotlib: a text table an epoch
        for name, x, y in curves:
            print(f"== {name} ==")
            for ep in np.unique(np.floor(x - 1e-9).astype(int)):
                m = (x > ep) & (x <= ep + 1)
                print(f"  epoch {ep:4d}: mean {y[m].mean():.6g} "
                      f"last {y[m][-1]:.6g}")
        return

    plt.figure(figsize=(8, 5))
    for name, x, y in curves:
        plt.plot(x, y, label=name, linewidth=1.2)
    plt.xlabel("epoch")
    plt.ylabel(" / ".join(args.keys))
    if args.title:
        plt.title(args.title)
    plt.legend(fontsize=8)
    plt.grid(alpha=0.3)
    out = args.out or "curves.png"
    plt.savefig(out, dpi=150, bbox_inches="tight")
    plt.close()
    print(f"saved {out}")


def cal_train_time(args):
    """Per-epoch s/iter stats from the logged ``it_per_s`` throughput."""
    for path in args.json_logs:
        records = load_log(path)
        per_epoch = defaultdict(list)
        for r in records:
            if "it_per_s" in r and r["it_per_s"] > 0:
                per_epoch[r.get("epoch", 0)].append(1.0 / float(r["it_per_s"]))
        if not per_epoch:
            print(f"{path}: no it_per_s records")
            continue
        print(f"----- train time of {path} -----")
        # drop each epoch's first record unless --include-outliers: it folds
        # in compile/warmup (the reference drops index 0 the same way)
        times = {
            ep: (v if args.include_outliers else v[1:]) or v
            for ep, v in per_epoch.items()
        }
        avg = {ep: float(np.mean(v)) for ep, v in times.items()}
        slowest = max(avg, key=avg.get)
        fastest = min(avg, key=avg.get)
        print(f"slowest epoch {slowest}, average time is {avg[slowest]:.4f} s/iter")
        print(f"fastest epoch {fastest}, average time is {avg[fastest]:.4f} s/iter")
        print(f"time std over epochs is {np.std(list(avg.values())):.4f}")
        print(f"average iter time: {np.mean(list(avg.values())):.4f} s/iter\n")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="analyze metrics.jsonl logs")
    sub = p.add_subparsers(dest="task", required=True)
    pc = sub.add_parser("plot_curve", help="plot loss/metric curves")
    pc.add_argument("json_logs", nargs="+")
    pc.add_argument("--keys", nargs="+", default=["loss"])
    pc.add_argument("--legend", nargs="+", default=None)
    pc.add_argument("--title", default=None)
    pc.add_argument("--out", default=None)
    ct = sub.add_parser("cal_train_time", help="iteration time statistics")
    ct.add_argument("json_logs", nargs="+")
    ct.add_argument("--include-outliers", action="store_true")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parse_args(argv)
    if args.task == "plot_curve":
        plot_curve(args)
    else:
        cal_train_time(args)


if __name__ == "__main__":
    main()
