"""Single / batch image inference demo: a drawn PNG an image, and the boxes.

    python -m rsprompter_tpu_torch.tools.image_demo IMG|DIR CONFIG \\
        [--weights CKPT] [--out-dir DIR] [--score-thr T] [--device cuda|cpu]

The port's counterpart of the JAX package's ``tools/image_demo.py`` (CLI
parity with the reference's ``demo/image_demo.py``): ``DetInferencer`` over
one image or every ``.jpg`` / ``.jpeg`` / ``.png`` / ``.tif`` file of a
directory, batch 1, writing ``OUT_DIR/<name>.png`` (boxes, labels, masks
drawn; PNG where JAX writes the input's format through OpenCV) and
``OUT_DIR/predictions.json`` (boxes, scores, labels a image). ``--weights``
is a state_dict of the whole detector; without it the weights are seeded,
with the config's SAM file where it exists. Runs on the card unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Sequence

from rsprompter_tpu_torch.apis.inference import DetInferencer

EXTENSIONS = (".jpg", ".png", ".jpeg", ".tif")


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="Image demo")
    p.add_argument("img", help="image path (or directory)")
    p.add_argument("config")
    p.add_argument("--weights", default=None)
    p.add_argument("--out-dir", default="outputs")
    p.add_argument("--score-thr", type=float, default=0.3)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return p.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the demo; returns ``DetInferencer``'s ``{'predictions': [...]}``."""
    args = parse_args(argv)
    inputs = args.img
    if os.path.isdir(inputs):
        inputs = [os.path.join(inputs, f) for f in sorted(os.listdir(inputs))
                  if f.lower().endswith(EXTENSIONS)]
    inf = DetInferencer(args.config, weights=args.weights, device=args.device, batch_size=1)
    out = inf(inputs, out_dir=args.out_dir, score_thr=args.score_thr)
    n = sum(len(p["scores"]) for p in out["predictions"])
    print(f"{len(out['predictions'])} image(s), {n} detections -> {args.out_dir}")
    return out


if __name__ == "__main__":
    main()
