"""The port's learning check: the pose head's held-out SSIM, PSNR and L1
over a training run from a DeepFashion-layout tree, the untrained
generator's first.

    python3 -m gfla_tpu_torch.tools.learning_curve --dataroot=DIR \
        [--max_iters=2000] [--eval_iters_freq=250] [train options]

Evaluates the seeded, untrained generator on the trainer's held-out batch
and writes it as iteration 0 to `eval_log.txt`, as the trainer writes its
own lines; then runs `python -m gfla_tpu_torch.train` with the same options,
which evaluates the same batch every `--eval_iters_freq` iterations. With
`--continue_train` it only resumes the trainer. Its defaults are the live
pose configuration at batch 8 (`--model=pose --dataset_mode=fashion
--batchSize=8 --load_size=256`), 2000 iterations, an evaluation every 250.
The tree can be the stick figures of scripts/make_stickfigure_dataset.py.
"""

from __future__ import annotations

import sys

from gfla_tpu_torch.data import collate, get_dataset_class
from gfla_tpu_torch.options import TrainOptions
from gfla_tpu_torch.runtime import select_device, set_tf32
from gfla_tpu_torch.tasks import create_task
from gfla_tpu_torch.train import __main__ as train_cli
from gfla_tpu_torch.train.evaluate import evaluate_held_out, holdout_indices
from gfla_tpu_torch.utils.visualizer import Visualizer

DEFAULTS = ["--model=pose", "--dataset_mode=fashion", "--batchSize=8",
            "--load_size=256", "--max_iters=2000", "--eval_iters_freq=250"]


def main(argv=None) -> int:
    args = DEFAULTS + list(sys.argv[1:] if argv is None else argv)
    opt = TrainOptions().parse(args, save=False)
    if not opt.continue_train:
        device = select_device(opt.gpu_ids)
        if device.type == "cuda":
            set_tf32(False)
        dataset = get_dataset_class(opt.dataset_mode)(opt)
        held = holdout_indices(len(dataset), opt.batchSize, opt.seed)
        if held is None:
            raise SystemExit(f"dataset has {len(dataset)} samples: too few to "
                             f"hold out a batch of {opt.batchSize}")
        task = create_task(opt, device)
        batch = task.prepare_batch(collate([dataset[int(i)] for i in held]))
        Visualizer(opt).print_current_eval(0, 0,
                                           evaluate_held_out(task, batch))
        del task, batch
    return train_cli.main(args)


if __name__ == "__main__":
    sys.exit(main())
