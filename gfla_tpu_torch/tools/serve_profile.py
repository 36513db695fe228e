"""Where a serving forward's or a training step's device time goes, by
kernel family.

    python3 -m gfla_tpu_torch.tools.serve_profile [--iters N] [--train]
        [--model pose|shapenet|dance|face|keypoint] [test or train options, e.g.
        --compute_dtype=bfloat16]

Builds the task as `python -m gfla_tpu_torch.test` (or, with `--train`,
`python -m gfla_tpu_torch.train`) does (full width, seeded random weights
unless a checkpoint is named), takes one batch at `--load_size=256
--batchSize=8` (of the synthetic pose dataset, or for ShapeNet random uint8
images and viewpoint labels in the HDF5 dataset's layout), or for dance and
face one batch-2 clip of the synthetic video dataset (6 frames: one chunk of
`--max_frames_per_gpu`, as gfla_tpu's bench.py times them), or for the
keypoint head random normalised joints: 8 training windows of 86 frames,
or one 40-frame sequence padded to 120 to serve, and runs
`--iters` forwards of the task's `test_step` (or steps of its `train_step`:
D, then G with its losses, backward and Adam) under torch.profiler. Device
time is summed per kernel over the card's own events and grouped into
families by kernel name; the wall time per forward or step comes from CUDA
events around the same work without the profiler. In a training step the
"transposed convolutions" family (cuDNN's dgrad kernels) also holds the
convolutions' input gradients. Needs one CUDA card. Prints the card, one
line per family, the twenty largest kernels, and the same as one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import tempfile

import numpy as np
import torch

from gfla_tpu_torch.data import collate, get_dataset_class
from gfla_tpu_torch.options import TestOptions, TrainOptions
from gfla_tpu_torch.runtime import card_line, select_device, set_tf32
from gfla_tpu_torch.tasks import create_task

FAMILIES = [  # first match wins; lower-case substrings of the kernel name
    ("warp forward kernel", ("warp_fwd_kernel",)),
    ("warp backward kernels", ("warp_bwd_pos_kernel", "warp_bwd_w1_kernel",
                               "reduce_parts")),
    ("memory copies", ("memcpy", "memset")),
    ("layout conversions", ("nchwtonhwc", "nhwctonchw", "transpose")),
    ("transposed convolutions", ("dgrad", "conv_transpose", "deconv")),
    ("convolutions", ("cudnn", "conv", "xmma", "cutlass", "gemm", "winograd",
                      "fft")),
    ("optimizer", ("multi_tensor_apply", "adam")),
    ("norm reductions", ("reduce", "norm", "welford", "mean", "var")),
    ("elementwise", ("elementwise", "vectorized", "copy", "fill", "cat",
                     "index", "gather", "upsample", "pad", "softmax")),
]


DATASET = {"pose": "synthetic", "shapenet": "shapenet",
           "keypoint": "keypoint"}
# a batch-2 clip of one 6-frame chunk, served and trained whole
ANIMATION = {kind: ["--batchSize=2", "--n_frames_total=6",
                    "--n_frames_pre_load_test=6"] for kind in ("dance", "face")}


def is_annotation(evt) -> bool:
    """A range the profiler draws on the device's timeline around kernels it
    also records (an optimizer step, an op), which would count them twice."""
    return (bool(getattr(evt, "is_user_annotation", False))
            or evt.name.startswith(("aten::", "Optimizer.")))


def family(name: str) -> str:
    low = name.lower()
    for label, keys in FAMILIES:
        if any(key in low for key in keys):
            return label
    return "other"


def shapenet_batch(B: int, size: int, seed: int = 0):
    """Random uint8 images and viewpoint labels (azimuth / 10, elevation) in
    the ShapeNet dataset's training layout."""
    rng = np.random.RandomState(seed)
    images = [rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8)
              for _ in "12"]
    labels = [np.stack([rng.randint(0, 18, B) * 2, rng.randint(0, 3, B) * 10],
                       axis=1).astype(np.int32) for _ in "12"]
    return {"P1": images[0], "P2": images[1], "BP1": labels[0],
            "BP2": labels[1]}


def keypoint_batch(B: int, T: int, seed: int = 0):
    """Random joints in [-1, 1], (B, T, 34), and gt for the T - 80 frames
    the net returns, in the keypoint datasets' layout."""
    rng = np.random.RandomState(seed)
    return {"input_data": rng.uniform(-1, 1, (B, T, 34)).astype(np.float32),
            "gt_data": rng.uniform(-1, 1, (B, T - 80, 34)).astype(
                np.float32)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--train", action="store_true",
                        help="profile training steps, not serving forwards")
    parser.add_argument("--model", default="pose",
                        choices=["pose", "shapenet", "dance", "face",
                                 "keypoint"])
    args, rest = parser.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: CUDA is not available", file=sys.stderr)
        return 1
    common = [f"--model={args.model}", "--load_size=256", "--gpu_ids=0",
              *ANIMATION.get(args.model, ["--batchSize=8"]),
              f"--dataset_mode={DATASET.get(args.model, 'synthetic_video')}"]
    ckpt = tempfile.TemporaryDirectory()
    if args.train:
        opt = TrainOptions().parse(
            [*common, f"--checkpoints_dir={ckpt.name}", *rest], save=False)
    else:
        opt = TestOptions().parse([*common, *rest], save=False)
    device = select_device(opt.gpu_ids)
    set_tf32(False)
    print(card_line())
    task = create_task(opt, device)
    if not args.train:
        task.load_checkpoint()
    step = task.train_step if args.train else task.test_step
    if args.model == "shapenet":
        host = shapenet_batch(opt.batchSize, opt.load_size)
    elif args.model == "keypoint":
        host = keypoint_batch(*((opt.batchSize, 86) if args.train
                                else (1, 120)))
    else:
        dataset = get_dataset_class(opt.dataset_mode)(opt)
        host = collate([dataset[i] for i in range(opt.batchSize)])
    batch = task.prepare_batch(host)

    for _ in range(3):  # builds the kernels, lets cuDNN choose
        step(batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(args.iters):
        step(batch)
    stop.record()
    stop.synchronize()
    wall_ms = start.elapsed_time(stop) / args.iters

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(args.iters):
            step(batch)
        torch.cuda.synchronize()
    ckpt.cleanup()
    per_kernel = collections.Counter()
    for evt in prof.events():
        if evt.device_type != DeviceType.CUDA or is_annotation(evt):
            continue
        us = getattr(evt, "device_time", None)
        if us is None:
            us = evt.cuda_time
        per_kernel[evt.name] += us / 1e3 / args.iters
    if not per_kernel or sum(per_kernel.values()) == 0:
        print("serve_profile: the profiler recorded no device time",
              file=sys.stderr)
        return 1
    per_family = collections.Counter()
    for name, ms in per_kernel.items():
        per_family[family(name)] += ms
    busy_ms = sum(per_family.values())
    what = "training step" if args.train else "forward"
    n = next(len(v) for v in host.values() if isinstance(v, np.ndarray))
    print(f"batch {n} {what} at {opt.load_size} in "
          f"{opt.compute_dtype}: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (means of {args.iters} {what}s)")
    for label, ms in per_family.most_common():
        print(f"  {label:<28} {ms:8.3f} ms  {ms / busy_ms:6.1%}")
    top = per_kernel.most_common(20)
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {family(name):<24} {name[:90]}")
    print(json.dumps({"serve_profile": {
        "step": "train" if args.train else "serve", "model": args.model,
        "compute_dtype": opt.compute_dtype, "wall_ms": wall_ms,
        "busy_ms": busy_ms, "iters": args.iters,
        "families": dict(per_family),
        "top_kernels": [{"name": n, "ms": ms} for n, ms in top]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
