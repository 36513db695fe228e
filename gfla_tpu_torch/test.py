"""Inference entry point, CLI-compatible with the original test.py:

    python -m gfla_tpu_torch.test --model=pose --dataset_mode=fashion \
        --dataroot=DIR --gpu_ids=0 --name=NAME --checkpoints_dir=DIR \
        --results_dir=DIR

loads `{checkpoints_dir}/{name}/{which_iter}_net_G.pth` (random init if
absent), serves the `--phase` pairs of the dataset in order and writes
`{src}_2_{tgt}_vis.jpg` under `{results_dir}/{name}` (on the card through
nvJPEG).
`--gpu_ids=-1` runs on the CPU. gfla_tpu's multi-device flags are refused.
"""

from __future__ import annotations

from gfla_tpu_torch.data import get_dataset_class, make_loader
from gfla_tpu_torch.options import TestOptions, refuse_parallel_flags
from gfla_tpu_torch.runtime import card_line, select_device, set_tf32
from gfla_tpu_torch.tasks import create_task
from gfla_tpu_torch.tasks.testing import run_test_pose


def main(args=None) -> int:
    opt = TestOptions().parse(args)
    refuse_parallel_flags(opt)
    device = select_device(opt.gpu_ids)
    if device.type == "cuda":
        set_tf32(False)  # f32 work stays f32 (TF32 off), in either dtype
        print(card_line())
    dataset = get_dataset_class(opt.dataset_mode)(opt)
    task = create_task(opt, device)
    task.load_checkpoint()
    return run_test_pose(task, opt, make_loader(dataset, opt, train=False))


if __name__ == "__main__":
    main()
