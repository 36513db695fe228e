"""Where a serving forward's or a training step's device time goes, by
kernel family.

    python3 -m gfla_tpu_torch.tools.serve_profile [--iters N] [--train]
        [test or train options, e.g. --compute_dtype=bfloat16]

Builds the pose task as `python -m gfla_tpu_torch.test` (or, with
`--train`, `python -m gfla_tpu_torch.train`) does (full width, seeded
random weights unless a checkpoint is named), takes one batch of the
synthetic dataset at `--load_size=256 --batchSize=8`, and runs `--iters`
forwards of `PoseTask.test_step` (or steps of `PoseTask.train_step`: D,
then G with its losses, backward and Adam) under torch.profiler. Device
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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--iters", type=int, default=5)
    parser.add_argument("--train", action="store_true",
                        help="profile training steps, not serving forwards")
    args, rest = parser.parse_known_args(argv)
    if not torch.cuda.is_available():
        print("serve_profile: CUDA is not available", file=sys.stderr)
        return 1
    common = ["--model=pose", "--dataset_mode=synthetic", "--load_size=256",
              "--batchSize=8", "--gpu_ids=0"]
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
    dataset = get_dataset_class(opt.dataset_mode)(opt)
    batch = task.prepare_batch(collate([dataset[i]
                                        for i in range(opt.batchSize)]))

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
    print(f"batch {opt.batchSize} {what} at {opt.load_size} in "
          f"{opt.compute_dtype}: wall "
          f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} (means of {args.iters} {what}s)")
    for label, ms in per_family.most_common():
        print(f"  {label:<28} {ms:8.3f} ms  {ms / busy_ms:6.1%}")
    top = per_kernel.most_common(20)
    for name, ms in top:
        print(f"    {ms:8.3f} ms  {family(name):<24} {name[:90]}")
    print(json.dumps({"serve_profile": {
        "step": "train" if args.train else "serve",
        "compute_dtype": opt.compute_dtype, "wall_ms": wall_ms,
        "busy_ms": busy_ms, "iters": args.iters,
        "families": dict(per_family),
        "top_kernels": [{"name": n, "ms": ms} for n, ms in top]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
