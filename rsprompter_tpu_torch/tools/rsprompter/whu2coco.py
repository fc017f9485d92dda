"""Convert WHU building masks to COCO instance annotations, without OpenCV.

    python -m rsprompter_tpu_torch.tools.rsprompter.whu2coco IMG_DIR MASK_DIR OUT_JSON

The port's counterpart of the JAX package's ``tools/rsprompter/whu2coco.py``
(:21-90), with its arguments, its messages and its JSON text. Each file of
``IMG_DIR`` (sorted) is an image id from 1; its mask is the file of the
same name in ``MASK_DIR``, read in grey. The instances are the mask's
8-connected components in OpenCV's label order
(``data/contours.connected_components_with_stats``); one under 4 pixels is
dropped, and so is one whose outer contour (``data/contours.component_contour``,
``findContours``' ``RETR_EXTERNAL`` + ``CHAIN_APPROX_SIMPLE`` points) has
under 3 points. Each gives a polygon, its stats box and its area. Images
and masks are read by ``data/io.imread`` (TIFF, PNG, JPEG; the WHU tiles
are TIFF); a pair whose image or mask is missing, cut or corrupt (where
``cv2.imread`` gives None) is skipped with JAX's message. A valid file that
the port's decoders leave out and OpenCV reads (``data.jpeg.NotDecoded``:
a JPEG-compressed TIFF, a progressive JPEG, ...) stops the tool with its
error, rather than dropping the tile the JAX tool would convert.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional, Sequence

import numpy as np

from rsprompter_tpu_torch.data.contours import component_contour, connected_components_with_stats
from rsprompter_tpu_torch.data.io import IMREAD_GRAYSCALE, NotDecoded, imread


def mask_to_coco_anns(mask: np.ndarray, image_id: int, next_ann_id: int):
    anns = []
    cc = connected_components_with_stats(mask > 0)
    for comp in range(1, cc.n):
        x, y, w, h, area = cc.stats[comp]
        if area < 4:
            continue
        contour = component_contour(cc, comp)
        segs = [contour.reshape(-1).astype(float).tolist()] if len(contour) >= 3 else []
        if not segs:
            continue
        anns.append(
            dict(
                id=next_ann_id + len(anns),
                image_id=image_id,
                category_id=1,
                bbox=[float(x), float(y), float(w), float(h)],
                area=float(area),
                segmentation=segs,
                iscrowd=0,
            )
        )
    return anns


def _read(path: str, flags: Optional[int] = None):
    """``imread``, or None where ``cv2.imread`` gives None: a missing file,
    a directory, data that are cut or corrupt. ``NotDecoded`` propagates."""
    try:
        return imread(path) if flags is None else imread(path, flags)
    except NotDecoded:
        raise
    except (OSError, ValueError):
        return None


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("img_dir")
    p.add_argument("mask_dir")
    p.add_argument("out_json")
    args = p.parse_args(argv)

    images, annotations = [], []
    ann_id = 1
    files = sorted(os.listdir(args.img_dir))
    for img_id, fname in enumerate(files, 1):
        img = _read(os.path.join(args.img_dir, fname))
        mask = _read(os.path.join(args.mask_dir, fname), IMREAD_GRAYSCALE)
        if img is None or mask is None:
            print(f"skip {fname} (missing image or mask)", file=sys.stderr)
            continue
        h, w = img.shape[:2]
        images.append(dict(id=img_id, file_name=fname, height=h, width=w))
        anns = mask_to_coco_anns(mask, img_id, ann_id)
        annotations.extend(anns)
        ann_id += len(anns)

    out = dict(
        info={}, licenses=[],
        categories=[dict(id=1, name="building", supercategory=None)],
        images=images, annotations=annotations,
    )
    with open(args.out_json, "w") as f:
        json.dump(out, f)
    print(f"{len(images)} images, {len(annotations)} instances -> {args.out_json}")


if __name__ == "__main__":
    main()
