"""Draw a dataset's ground truth over its images (check data and config
before training).

    python -m rsprompter_tpu_torch.tools.analysis_tools.browse_dataset CONFIG \\
        --output-dir DIR [--phase train|val|test] [--max-samples 20] [--pipeline]

The port's counterpart of the JAX package's
``tools/analysis_tools/browse_dataset.py`` (the reference's, without the
interactive window): each sample's boxes, labels and masks drawn by
``apis.visualization`` and written under the image's basename (JPEG at
quality 95 for ``.jpg`` through the port's encoder). By default the raw
annotations; ``--pipeline`` runs the port's train pipeline
(``data.transforms.build_train_pipeline``: flip, resize, crop) first, to
show what the model sees; a sample it filters out is skipped.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional, Sequence

from rsprompter_tpu_torch.apis.visualization import draw_predictions
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.core.registry import DATASETS
from rsprompter_tpu_torch.data import coco as _coco  # noqa: F401  (registers the datasets)
from rsprompter_tpu_torch.data.io import drawn_name, imwrite
from rsprompter_tpu_torch.data.transforms import build_train_pipeline


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="draw dataset ground truth")
    p.add_argument("config")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--phase", default="train", choices=("train", "val", "test"))
    p.add_argument("--max-samples", type=int, default=20)
    p.add_argument("--pipeline", action="store_true",
                   help="draw the train pipeline's output instead of the raw GT")
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    args = parse_args(argv)
    cfg = Config.fromfile(args.config)
    ds_cfg = dict(cfg.get(f"{args.phase}_dataloader", cfg.get("val_dataloader"))["dataset"])
    ds = DATASETS.build(ds_cfg)
    classes = ds.metainfo.get("classes")
    pipeline = (build_train_pipeline(tuple(cfg.get("crop_size", (1024, 1024))))
                if args.pipeline else None)
    os.makedirs(args.output_dir, exist_ok=True)
    n = min(len(ds), args.max_samples)
    written = []
    for i in range(n):
        s = ds.load_raw(i)
        for t in pipeline or ():
            s = t(s)
            if s is None:  # filtered (no GT survived the crop)
                break
        if s is None:
            continue
        keep = ~s["gt_ignore_flags"]
        pred = dict(bboxes=s["gt_bboxes"][keep].tolist(), scores=[1.0] * int(keep.sum()),
                    labels=s["gt_labels"][keep].tolist(),
                    masks=s["gt_masks"][keep].astype(bool))
        name = drawn_name(s.get("img_path") or f"sample_{i}.jpg")
        imwrite(os.path.join(args.output_dir, name),
                draw_predictions(s["img"], pred, classes=classes))
        written.append(name)
        print(f"[{i + 1}/{n}] {name}: {int(keep.sum())} instances")
    return written


if __name__ == "__main__":
    main()
