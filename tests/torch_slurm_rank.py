"""One rank of ``test_torch_whu.py``'s SLURM launcher test, started by
``tools/slurm_train.sh`` (``TRAIN_MODULE=torch_slurm_rank``): the seeded
initial parameters, then ``tools.train``'s main on the same arguments, then
this rank's parameters, step and world size to
``$RSP_PARAM_DUMP/rank{RANK}.pt``."""

import os
import sys

import torch

from rsprompter_tpu_torch.engine import train_state
from rsprompter_tpu_torch.tools import train


def _params(model):
    model = getattr(model, "module", model)
    return {k: v.detach().cpu().clone() for k, v in model.named_parameters()}


def main() -> None:
    init = {}
    build = train_state.build_trainer

    def build_and_keep(*args, **kwargs):  # the parameters before the first step
        trainer = build(*args, **kwargs)
        init.update(_params(trainer.model))
        return trainer

    train.build_trainer = build_and_keep
    runner = train.main(sys.argv[1:])
    torch.save(dict(params=_params(runner.trainer.model), init=init, iter=runner.trainer.iter,
                    world=int(os.environ["WORLD_SIZE"])),
               os.path.join(os.environ["RSP_PARAM_DUMP"], f"rank{os.environ['RANK']}.pt"))


if __name__ == "__main__":
    main()
