"""SAM-det's train step on one CUDA card (``chip_smoke.py`` phase 14's
SAM-det part: ``samdet-nwpu.py`` at 1024^2, batch 2, seeded weights, phase
3's images and GT), with what sets the time of its RoI gather's backward.

    python scripts/torch_roi_gather_groups.py

Prints the ten timed steps, the profiled step's large row gathers (their
indices, distinct rows and largest groups of one row, from the step's
forward again on the same weights and draws: the deterministic backward
sums each row's group in turn), then for each image of that step how many
proposals are valid, how many of the 512 sampled slots are valid and
positive, and the sampled boxes that repeat most (a padding slot's box is
all zeros).
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rsprompter_tpu_torch.core.config import Config  # noqa: E402
from rsprompter_tpu_torch.models.roi_heads import standard_roi_head as srh  # noqa: E402


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(cs.card_line())
    seen = []
    sample = srh.sample_proposals_batch

    def keep(*a, **kw):
        out = sample(*a, **kw)
        seen.append((out, a[1], a[2]))
        return out

    srh.sample_proposals_batch = keep
    batch = cs.baseline_train_batch("cuda")
    config = cs.SAM_BASELINES["samdet"]
    with tempfile.TemporaryDirectory() as tmp:
        sam_file = os.path.join(tmp, "pytorch_model.bin")
        cs.write_hf_sam(sam_file, Config.fromfile(config)["model"], seed=5)
        trainer = cs.baseline_trainer(config, sam_file, "cuda")
    cs.baseline_steps("samdet train", trainer, batch, cs.BASELINE_STEPS, [],
                      cs.BASELINE_LOSS_TERMS["samdet"], gathers=True)
    smp, proposals, valid = seen[-1]  # the profiled step's
    for b in range(smp.boxes.shape[0]):
        boxes = smp.boxes[b]
        uniq, counts = torch.unique(boxes, dim=0, return_counts=True)
        top = torch.topk(counts, min(5, counts.numel()))
        wh = boxes[:, 2:] - boxes[:, :2]
        cs.log(f"image {b}: proposals valid {int(valid[b].sum())} of {valid.shape[1]}; sampled "
               f"slots valid {int(smp.valid[b].sum())}, positive {int(smp.is_pos[b].sum())}; "
               f"distinct sampled boxes {uniq.shape[0]}; most common {uniq[top.indices].tolist()} "
               f"x {top.values.tolist()}; zero-area sampled boxes {int((wh.prod(-1) <= 0).sum())}; "
               f"median box w, h {wh.median(0).values.tolist()}; proposals' median w, h "
               f"{(proposals[b, :, 2:] - proposals[b, :, :2])[valid[b]].median(0).values.tolist()}")
    cs.log(cs.card_line())


if __name__ == "__main__":
    main()
