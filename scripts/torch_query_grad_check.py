"""The query train step's gradient check (``chip_smoke.py`` phase 10) over
several trained states and draw seeds, on one CUDA card, with the decoder's
cross-attention masks held to the kernels' run's (as ``chip_smoke.py``
checks) and with each run making its own.

    python scripts/torch_query_grad_check.py [--steps 21] [--every 3] [--seeds 7:9]
        [--masks both|held|free] [--window 5] [--no-plus]

Builds ``rsprompter_query-nwpu.py`` as phase 10 does (ViT-B 1024^2, batch 2,
seeded weights, one synthetic batch; ``--no-plus``: with ``decoder_plus=False``,
as phase 14 does), then takes ``--steps`` train steps and,
before every ``--every``-th one, runs the check once per seed and mask mode.
The check runs the batch through the kernels, the plain versions and the
plain versions with the encoder in fp32 (the reference), with the kernels'
run's matches and selected points, and prints each run's distance from the
reference per head parameter tensor (median and worst) and their ratio,
which ``chip_smoke.py`` holds to ``FLOOR_FACTOR``. Held, it also prints how
many mask entries the other two runs would have flipped. For each state and
seed it prints the encoder output's distance from the reference's (rounded
to bf16 as the neck reads it): max and RMS of the difference over max and
RMS of the reference, kernels and plain. Summary lines per mode end it: each
ratio over every check, its median over each state's seeds, and its median
over each ``--window`` consecutive states (the first seed's check), which is
what ``chip_smoke.py``'s gate takes with ``--every`` equal to
``QUERY_GRAD_GAP``.
"""

import argparse
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from rsprompter_tpu_torch.core.config import Config  # noqa: E402
from rsprompter_tpu_torch.engine.train_state import build_trainer  # noqa: E402
from rsprompter_tpu_torch.ops import _cuda  # noqa: E402
from rsprompter_tpu_torch.utils.synthetic import synthetic_batch  # noqa: E402


class Seeded:
    """The check's generator, whose ``manual_seed`` seeds ``seed`` instead."""

    def __init__(self, gen, seed):
        self.gen, self.seed = gen, seed

    def manual_seed(self, _):
        return self.gen.manual_seed(self.seed)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--steps", type=int, default=21)
    parser.add_argument("--every", type=int, default=3)
    parser.add_argument("--seeds", default="7:9", help="draw seeds, start:stop")
    parser.add_argument("--masks", choices=("both", "held", "free"), default="both")
    parser.add_argument("--window", type=int, default=cs.QUERY_GRAD_STATES,
                        help="states a gate's median takes (the first seed's check each)")
    parser.add_argument("--no-plus", action="store_true",
                        help="the head with decoder_plus=False (chip_smoke.py phase 14)")
    args = parser.parse_args()
    modes = {"both": (True, False), "held": (True,), "free": (False,)}[args.masks]
    start, stop = map(int, args.seeds.split(":"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    kernels = _cuda.all_kernels()
    cs.log(f"built: {_cuda.build(kernels)}")

    cfg = Config.fromfile(cs.QUERY_CONFIG)
    if args.no_plus:
        cfg.merge_from_options({"model.decoder_plus": False})
    trainer = build_trainer(cfg, device="cuda", seed=0,
                            steps_per_epoch=cs.QUERY_TRAIN_STEPS_PER_EPOCH)
    cfg, model = trainer.cfg, trainer.model
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in synthetic_batch(
        cfg["train_dataloader"]["batch_size"], tuple(cfg["crop_size"]),
        cfg["model"]["num_classes"], max_gt=8, seed=0).items()}
    gen = torch.Generator(device="cuda")

    outs = []  # the encoder's output of each run, in run order

    def grab(_mod, _inputs, outputs):
        outs.append(outputs[0].detach().to(torch.bfloat16).float())

    model.backbone.register_forward_hook(grab)
    ratios = {hold: [] for hold in modes}
    by_state = {hold: [] for hold in modes}  # per state, its seeds' ratios
    for step in range(args.steps + 1):
        if step % args.every == 0:
            for hold in modes:
                by_state[hold].append([])
            for seed in range(start, stop):
                for hold in modes:
                    name = f"step {step}, seed {seed}, masks {'held' if hold else 'free'}"
                    cs.log(f"=== {name}")
                    outs.clear()
                    got = cs.query_gradient_ratios(model, batch, Seeded(gen, seed), hold)
                    ratio = {k: g / b for k, (g, b) in got.items()}
                    cs.log(f"=== {name}: ratio median tensor {ratio['median']:.4g}, worst "
                           f"{ratio['worst']:.4g} (kernels, plain: {got})")
                    ratios[hold].append(ratio)
                    by_state[hold][-1].append(ratio)
                    kern, plain, ref = outs
                    dist = {k: (float((o - ref).abs().max() / ref.abs().max()),
                                float((o - ref).pow(2).mean().sqrt() / ref.pow(2).mean().sqrt()))
                            for k, o in (("kernels", kern), ("plain", plain))}
                    cs.log("encoder output vs reference (max, rms): " + "; ".join(
                        f"{k} {m:.4g}, {r:.4g}" for k, (m, r) in dist.items()))
        if step < args.steps:
            trainer.step(batch, gen.manual_seed(1000 + step))
    for hold, got in ratios.items():
        for what in ("median", "worst"):
            r = [g[what] for g in got]
            cs.log(f"masks {'held' if hold else 'free'}: {what}-tensor ratio over {len(r)} "
                   f"checks: min {min(r):.4g}, median {statistics.median(r):.4g}, max "
                   f"{max(r):.4g}; over {cs.FLOOR_FACTOR}: {sum(x > cs.FLOOR_FACTOR for x in r)}")
            med = [statistics.median(g[what] for g in s) for s in by_state[hold]]
            cs.log(f"masks {'held' if hold else 'free'}: {what}-tensor ratio, median over "
                   f"each state's {stop - start} seeds, over {len(med)} states: "
                   f"{[round(m, 4) for m in med]}; over {cs.FLOOR_FACTOR}: "
                   f"{sum(m > cs.FLOOR_FACTOR for m in med)}")
            firsts = [s[0][what] for s in by_state[hold]]
            gates = [statistics.median(firsts[i:i + args.window])
                     for i in range(len(firsts) - args.window + 1)]
            cs.log(f"masks {'held' if hold else 'free'}: {what}-tensor ratio, median over "
                   f"each {args.window} consecutive states (seed {start}), over {len(gates)} "
                   f"windows: {[round(m, 4) for m in gates]}; over {cs.FLOOR_FACTOR}: "
                   f"{sum(m > cs.FLOOR_FACTOR for m in gates)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
