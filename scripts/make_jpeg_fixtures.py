"""Write the JPEG fixtures of ``tests/data/jpeg/`` and their digests.

    python scripts/make_jpeg_fixtures.py [--out tests/data/jpeg] [--seed 0]

Four seeded NWPU-like scenes (a smooth ground field, rectangular buildings
and vehicles, sensor noise), 600-960 px, encoded with OpenCV (libjpeg-turbo)
at the settings a dataset's JPEGs come in: 4:2:0 at quality 95, 4:2:2 at
quality 75 with a restart interval of 4 MCUs, 4:4:4 at quality 90, and grey.
Beside them, ``digests.json`` holds the sha256 and shape of each file's
``cv2.imread(path, IMREAD_COLOR)``: the bytes the port's decoder must give,
on a machine without OpenCV too (``tests/test_torch_jpeg.py``,
``chip_smoke.py`` phase 17). Needs OpenCV; run it where OpenCV is installed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import cv2
import numpy as np

# name -> (height, width, grey, cv2.imwrite parameters)
FIXTURES = {
    "scene_420_q95.jpg": (600, 958, False, [cv2.IMWRITE_JPEG_QUALITY, 95,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x221111]),
    "scene_422_q75_rst4.jpg": (720, 960, False, [cv2.IMWRITE_JPEG_QUALITY, 75,
                                                cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x211111,
                                                cv2.IMWRITE_JPEG_RST_INTERVAL, 4]),
    "scene_444_q90.jpg": (640, 800, False, [cv2.IMWRITE_JPEG_QUALITY, 90,
                                           cv2.IMWRITE_JPEG_SAMPLING_FACTOR, 0x111111]),
    "scene_grey_q85.jpg": (620, 700, True, [cv2.IMWRITE_JPEG_QUALITY, 85]),
}


def scene(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    """An aerial-looking BGR scene: a blurred ground field, rectangles,
    noise."""
    coarse = rng.uniform(60, 190, (h // 64 + 2, w // 64 + 2, 3))
    img = cv2.resize(coarse, (w, h), interpolation=cv2.INTER_CUBIC)
    for _ in range(int(rng.integers(12, 24))):
        bh, bw = rng.integers(12, 90, 2)
        y, x = rng.integers(0, h - bh), rng.integers(0, w - bw)
        img[y:y + bh, x:x + bw] = rng.uniform(20, 235, 3)
    img = cv2.GaussianBlur(img, (3, 3), 0.8)
    return np.clip(img + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(os.path.dirname(__file__), "..", "tests",
                                                  "data", "jpeg"))
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    rng = np.random.default_rng(args.seed)
    digests = {}
    for name, (h, w, grey, params) in FIXTURES.items():
        img = scene(rng, h, w)
        if grey:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
        path = os.path.join(args.out, name)
        if not cv2.imwrite(path, img, params):
            raise RuntimeError(f"cv2.imwrite failed for {path}")
        ref = cv2.imread(path, cv2.IMREAD_COLOR)
        digests[name] = {"sha256": hashlib.sha256(ref.tobytes()).hexdigest(),
                         "shape": list(ref.shape)}
        print(f"{name}: {ref.shape}, {os.path.getsize(path)} bytes")
    with open(os.path.join(args.out, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
