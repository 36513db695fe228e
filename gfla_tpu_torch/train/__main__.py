"""Training entry point (`python -m gfla_tpu_torch.train`), CLI-compatible
with the original train.py:

    python -m gfla_tpu_torch.train --model=pose --dataset_mode=fashion \
        --dataroot=DIR --gpu_ids=0 --name=NAME --checkpoints_dir=DIR --niter=N

takes `--niter` epochs of iterations (or `--max_iters`) from the dataset
(`fashion` and `market` read a DeepFashion or Market-1501 tree, `synthetic`
makes its samples, `synthetic_video` its clips for `--model=dance|face`,
which take one optimizer step per chunk of an iteration's clip), and, as
gfla_tpu's train.py does:
- holds out one batch of samples when `--eval_iters_freq` is set and the
  dataset has two batches, and prints and logs its SSIM, PSNR and L1 every
  `--eval_iters_freq` iterations (`eval_log.txt`);
- prints and logs the losses every `--print_freq` (`loss_log.txt`);
- writes the visuals every `--display_freq` (`web/images/`);
- traces `--profile_iters` steps from the third with torch.profiler
  (`profile/`, a Chrome trace);
- saves `latest_net_{G,D}.pth` every `--save_latest_freq` and
  `{iter}_net_{G,D}.pth` every `--save_iters_freq` and at the end, and
  resumes from `--which_iter` with `--continue_train`.
All of it goes under `{checkpoints_dir}/{name}`; the animation heads save
`net_D_V` beside G and D. `--model=poseflownet` trains
the stage-1 flow head, which has no D; a later `--model=pose
--continue_train` with the same `--name` starts the pose generator's flow
net from it (the two-stage protocol). `--gpu_ids=-1` runs on the CPU;
`--remat` recomputes the generator's forward (each frame's, for the
animation heads) in the backward.

Data parallelism, as gfla_tpu's `--mesh_devices` and `--distributed`
(gfla_tpu_torch.parallel): `--mesh_devices=N` (or `--gpu_ids=0,1,...`)
trains on N local ranks, one process a device started here, and
`--distributed` joins the multi-host world torchrun's environment
describes (`torchrun --nnodes=... --nproc_per_node=L -m
gfla_tpu_torch.train --distributed ...`). `--batchSize` is a host's
batch, split over its ranks; the global batch is hosts x `--batchSize`,
and each step applies the gradient of its mean. Only rank 0 prints, logs,
evaluates, writes visuals, traces and checkpoints. `--gpu_ids=-1
--mesh_devices=N` runs N ranks on the CPU (gloo).

The data x spatial mode, as gfla_tpu's `--spatial=S --halo=h`
(gfla_tpu_torch.parallel's spatial axis; every head, in either
`--compute_dtype`, with or without `--remat`): the ranks form N / S spatial
groups of S consecutive ranks, each a data index that loads its rows of
the global batch; each rank of a group holds one row band of every image,
clip and activation, exchanges halo rows with its neighbours, and sums its
reductions over the group. The step is gfla_tpu's single-device step, but
where a local attention's flow leaves its band's window of h rows, where
it clamps as gfla_tpu's halo gather does. keypoint's (B, T, 34) batch has
no rows: as in gfla_tpu, the S ranks of a group hold the same batch and
take the same step. Rank 0's group evaluates and writes the visuals, each
rank on its band, gathered whole.
"""

from __future__ import annotations

from gfla_tpu_torch import parallel
from gfla_tpu_torch.options import TrainOptions, spatial_layout
from gfla_tpu_torch.runtime import select_devices
from gfla_tpu_torch.train.loop import train


def main(args=None) -> int:
    options = TrainOptions()
    opt = options.parse(args, show=False)
    if opt.distributed:
        at = parallel.env_world()
        if opt.mesh_devices not in (0, at.size):
            raise SystemExit(f"--mesh_devices={opt.mesh_devices} with "
                             f"--distributed: 0 or the world size {at.size}")
        devices = select_devices(opt.gpu_ids, at.local_size)
    else:
        devices = select_devices(opt.gpu_ids, opt.mesh_devices)
        at = parallel.World(size=len(devices), local_size=len(devices))
    sp = spatial_layout(opt, at.size, at.local_size)
    if opt.batchSize % (at.local_size // sp):
        raise SystemExit(f"--batchSize={opt.batchSize} does not split over "
                         f"{at.local_size} ranks on this host")
    if at.rank == 0 and opt.phase != "val":
        options.print_options(opt)
    if opt.distributed:
        parallel.init_world(at, devices[at.local_rank])
        try:
            return train(devices[at.local_rank], opt)
        finally:
            parallel.close_world()
    if len(devices) > 1:
        print(f"data parallel: {len(devices)} ranks on "
              f"{[str(d) for d in devices]}, "
              f"{opt.batchSize * sp // len(devices)} rows each")
        parallel.spawn(train, devices, opt)
        return 0
    return train(devices[0], opt)


if __name__ == "__main__":
    main()
