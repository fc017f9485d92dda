"""Sliced inference on a large scene (satellite imagery).

    python -m rsprompter_tpu_torch.tools.large_image_demo BIG_IMG CONFIG [CKPT] \\
        --out-dir OUT [--patch 1024] [--overlap 0.25] [--batch-size 4] \\
        [--score-thr 0.3] [--merge-iou 0.5] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/large_image_demo.py``
(the reference's ``demo/large_image_demo.py``: sahi slicing -> per-patch
inference -> shift -> NMS merge): the scene is cut into patches of one size
(``utils.large_image.slice_offsets``), which run through ``DetInferencer``
at that size in batches of ``--batch-size``; the detections are shifted
into the scene and merged by class-wise NMS. Writes ``OUT/<name>.png`` (the
merged masks blended in green, then boxes and labels; PNG where JAX writes
the input's format through OpenCV) and ``OUT/predictions.json`` (the merged
boxes, scores, labels). ``CKPT`` is a state_dict of the whole detector.
Runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.apis.inference import DetInferencer
from rsprompter_tpu_torch.apis.visualization import draw_predictions
from rsprompter_tpu_torch.core.config import Config
from rsprompter_tpu_torch.data.io import encode_png, imread
from rsprompter_tpu_torch.utils.large_image import (
    merge_patch_predictions, paste_scene_masks, slice_offsets)

GREEN = np.asarray((0, 255, 0), np.float32)


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="sliced large-image inference")
    p.add_argument("image")
    p.add_argument("config")
    p.add_argument("checkpoint", nargs="?", default=None)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--patch", type=int, default=None,
                   help="tile size (default: config crop)")
    p.add_argument("--overlap", type=float, default=0.25)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--merge-iou", type=float, default=0.5)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the demo; returns {'offsets', 'patch_predictions', 'merged',
    'image_path', 'json_path'}."""
    args = parse_args(argv)
    img = imread(args.image)
    h, w = img.shape[:2]
    cfg = Config.fromfile(args.config)
    patch = args.patch or tuple(cfg.get("crop_size", (1024, 1024)))[0]
    offsets = slice_offsets(h, w, patch, args.overlap)
    print(f"{w}x{h} scene -> {len(offsets)} patches of {patch}^2 (overlap {args.overlap})")

    inferencer = DetInferencer(cfg, weights=args.checkpoint, device=args.device,
                               batch_size=args.batch_size, size_buckets=[patch])
    tiles = [img[y0:y0 + min(patch, h), x0:x0 + min(patch, w)] for x0, y0 in offsets]
    preds = inferencer(tiles, return_masks=True, score_thr=args.score_thr)["predictions"]
    merged = merge_patch_predictions(preds, offsets, (h, w), iou_thr=args.merge_iou)
    print(f"{sum(len(p['scores']) for p in preds)} patch dets "
          f"-> {len(merged['scores'])} after shift+NMS merge")

    os.makedirs(args.out_dir, exist_ok=True)
    vis_pred = dict(bboxes=merged["bboxes"].tolist(), scores=merged["scores"].tolist(),
                    labels=merged["labels"].tolist())
    vis = img.copy()
    if merged["masks"] is not None:
        # blend masks one at a time (O(H*W) peak, not O(dets*H*W))
        for m in paste_scene_masks(merged["masks"], (h, w)):
            vis[m] = (0.5 * vis[m] + 0.5 * GREEN).astype(np.uint8)
    vis = draw_predictions(vis, vis_pred)
    name = os.path.splitext(os.path.basename(args.image))[0] + ".png"
    image_path = os.path.join(args.out_dir, name)
    with open(image_path, "wb") as f:
        f.write(encode_png(vis))
    json_path = os.path.join(args.out_dir, "predictions.json")
    with open(json_path, "w") as f:
        json.dump(vis_pred, f)
    print(f"wrote {image_path}")
    return dict(offsets=offsets, patch_predictions=preds, merged=merged,
                image_path=image_path, json_path=json_path)


if __name__ == "__main__":
    main()
