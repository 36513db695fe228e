"""Inference entry point, CLI-compatible with the original test.py:

    python -m gfla_tpu_torch.test --model=pose --dataset_mode=fashion \
        --dataroot=DIR --gpu_ids=0 --name=NAME --checkpoints_dir=DIR \
        --results_dir=DIR

loads `{checkpoints_dir}/{name}/{which_iter}_net_G.pth` (random init if
absent), serves the `--phase` pairs of the dataset in order and writes
`{src}_2_{tgt}_vis.jpg` under `{results_dir}/{name}` (on the card through
nvJPEG); `--model=shapenet` serves each test source at all 18 azimuths of
its sweep, one `_vis.jpg` each, and `--model=dance|face` streams each clip
chunk by chunk, the last frame carried, writing `{frame}_vis` and
`{frame}_gt` (`--write_ext`, png by default) per frame (the task's
`run_test`).
`--gpu_ids=-1` runs on the CPU. Serving runs on one device (the first of a
`--gpu_ids` list), as gfla_tpu's test.py serves on one chip: its
multi-device flags, `--mesh_devices`, `--spatial` and `--distributed`, are
accepted, and a line says they are not used.
"""

from __future__ import annotations

from gfla_tpu_torch.data import get_dataset_class, make_loader
from gfla_tpu_torch.options import TestOptions
from gfla_tpu_torch.runtime import card_line, select_device, set_tf32
from gfla_tpu_torch.tasks import create_task


def main(args=None) -> int:
    opt = TestOptions().parse(args)
    if opt.mesh_devices > 1 or (opt.spatial or 1) > 1 or opt.distributed:
        print("serving runs on one device, as gfla_tpu's test.py does: "
              "--mesh_devices, --spatial and --distributed are not used")
    device = select_device(opt.gpu_ids)
    if device.type == "cuda":
        set_tf32(False)  # f32 work stays f32 (TF32 off), in either dtype
        print(card_line())
    dataset = get_dataset_class(opt.dataset_mode)(opt)
    task = create_task(opt, device)
    task.load_checkpoint()
    return task.run_test(opt, make_loader(dataset, opt, train=False))


if __name__ == "__main__":
    main()
