"""Write ``tests/data/jpeg/encode_digests.json``: ``cv2.imencode``'s bytes of
the JPEG fixtures, by sha256.

    python scripts/make_jpeg_encode_fixtures.py [--dir tests/data/jpeg]

For each fixture of ``tests/data/jpeg/`` (``scripts/make_jpeg_fixtures.py``)
the image ``cv2.imread(path, IMREAD_COLOR)`` gives is encoded with
``cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY, q])`` at qualities 95
(OpenCV's default) and 7 (``jpeg_compression`` at severity 5, where the
scaled tables clamp at 255): the bytes the port's encoder must write, on a
machine without OpenCV too (``tests/test_torch_jpeg_encode.py``,
``chip_smoke.py`` phase 18). Needs OpenCV; run it where OpenCV is installed.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import cv2

QUALITIES = (95, 7)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--dir", default=os.path.join(os.path.dirname(__file__), "..", "tests",
                                                  "data", "jpeg"))
    args = p.parse_args()
    digests = {}
    for name in sorted(f for f in os.listdir(args.dir) if f.endswith(".jpg")):
        img = cv2.imread(os.path.join(args.dir, name), cv2.IMREAD_COLOR)
        entry = {"shape": list(img.shape)}
        for q in QUALITIES:
            ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, q])
            if not ok:
                raise RuntimeError(f"cv2.imencode failed for {name} at quality {q}")
            entry[str(q)] = {"sha256": hashlib.sha256(buf.tobytes()).hexdigest(),
                             "bytes": int(buf.size)}
        digests[name] = entry
        print(name, entry)
    with open(os.path.join(args.dir, "encode_digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
