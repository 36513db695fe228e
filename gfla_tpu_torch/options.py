"""Command-line options of the port: the same flag surface as gfla_tpu's
options (gfla_tpu/options/options.py), which follows the original GFLA's, so
the same command lines parse to the same namespace.

The composition is the same three phases: base flags, then the task's
`modify_options` (from the port's own task registry), then the dataset's
defaults. `--gpu_ids` selects the device here: -1 is the CPU, anything else
`cuda:<id>` (gfla_tpu_torch.runtime.select_device).
"""

from __future__ import annotations

import argparse
import os
import sys


class StoreDictKeyPair(argparse.Action):
    """--kernel_size=2=5,3=3 -> {"2": 5, "3": 3}."""

    def __call__(self, parser, namespace, values, option_string=None):
        d = {}
        for kv in values.split(","):
            k, v = kv.split("=")
            d[k] = int(v)
        setattr(namespace, self.dest, d)


class StoreList(argparse.Action):
    """--attn_layer=2,3 -> [2, 3]."""

    def __call__(self, parser, namespace, values, option_string=None):
        setattr(namespace, self.dest, [int(x) for x in values.split(",")])


class StoreRange(argparse.Action):
    """--angle/--shift/--scale: 'False'/'none' (off), 'lo,hi', or one
    magnitude M meaning (-M, M)."""

    def __call__(self, parser, namespace, values, option_string=None):
        v = values.strip().lower()
        if v in ("false", "none", "0", ""):
            setattr(namespace, self.dest, False)
            return
        parts = [float(x) for x in values.split(",")]
        if len(parts) == 1:
            parts = [-abs(parts[0]), abs(parts[0])]
        setattr(namespace, self.dest, tuple(parts[:2]))


def add_spect_d_flags(parser):
    """--use_spect_d is store_false with default True, as in the original
    (passing it disables spectral norm in D); --no_spect_d is an alias."""
    parser.add_argument("--use_spect_d", dest="use_spect_d",
                        action="store_false", default=True)
    parser.add_argument("--no_spect_d", dest="use_spect_d",
                        action="store_false")
    return parser


def resolve_use_spect_d(opt) -> bool:
    """True when D uses spectral norm: the parsed `use_spect_d`, or, for a
    namespace that only carries the legacy `no_spect_d`, its negation."""
    v = getattr(opt, "use_spect_d", None)
    if v is not None:
        return bool(v)
    return not getattr(opt, "no_spect_d", False)


MULTI_GPU_TODO = ("multi-GPU runs are not ported yet (ROADMAP.md, queue 1, "
                  "item 9)")


def refuse_parallel_flags(opt) -> None:
    """Raise NotImplementedError for a parallelism flag of gfla_tpu that asks
    for more than one device: `--mesh_devices` other than 0 or 1, `--spatial`
    above 1 (gfla_tpu's train.py reads 0 as 1 too, and `--halo` only under
    it) or `--distributed`. The port runs on one device."""
    if opt.mesh_devices not in (0, 1):
        raise NotImplementedError(
            f"--mesh_devices={opt.mesh_devices}: {MULTI_GPU_TODO}")
    if (opt.spatial or 1) > 1:
        raise NotImplementedError(f"--spatial={opt.spatial}: {MULTI_GPU_TODO}")
    if opt.distributed:
        raise NotImplementedError(f"--distributed: {MULTI_GPU_TODO}")


class BaseOptions:
    isTrain = False

    def __init__(self):
        self.parser = argparse.ArgumentParser()
        self.initialized = False

    def initialize(self, parser):
        add = parser.add_argument
        add("--name", type=str, default="experiment_name")
        add("--model", type=str, default="pose")
        add("--checkpoints_dir", type=str, default="./result")
        add("--which_iter", type=str, default="latest")
        add("--gpu_ids", "--gpu_id", dest="gpu_ids", type=str, default="0",
            help="-1 runs on the CPU; N runs on cuda:N")
        add("--phase", type=str, default="train")
        add("--continue_train", action="store_true")

        add("--batchSize", type=int, default=8)
        add("--old_size", type=int, default=None)
        add("--load_size", type=int, default=256)
        add("--structure_nc", type=int, default=18)
        add("--image_nc", type=int, default=3)

        add("--dataroot", type=str, default="./dataset/fashion/")
        add("--dataset_mode", type=str, default="fashion")
        add("--fid_gt_path", type=str)
        add("--serial_batches", action="store_true")
        add("--nThreads", default=2, type=int)
        add("--max_dataset_size", type=int, default=sys.maxsize)

        add("--display_winsize", type=int, default=256)
        add("--display_freq", type=int, default=1000)
        add("--results_dir", type=str, default="./eval_results")

        add("--angle", action=StoreRange, default=None, metavar="LO,HI")
        add("--shift", action=StoreRange, default=None, metavar="LO,HI")
        add("--scale", action=StoreRange, default=None, metavar="LO,HI")
        add("--debug", action="store_true", default=False)
        add("--eval_set", type=str, default="train")
        # display flags of the original, accepted and ignored
        add("--display_port", type=int, default=8096)
        add("--display_single_pane_ncols", type=int, default=0)
        add("--display_env", type=str, default=None)

        add("--compute_dtype", type=str, default="float32",
            choices=["float32", "bfloat16"],
            help="the pose head's compute dtype: f32 master parameters, "
                 "G, D and VGG19 (and the warp kernels) in this type, as "
                 "gfla_tpu's; poseflownet trains in float32")
        # parallelism flags of gfla_tpu: the defaults parse, any other value
        # is refused by both CLIs (refuse_parallel_flags); the port runs on
        # one device
        add("--mesh_devices", type=int, default=0)
        add("--spatial", type=int, default=1)
        add("--halo", type=int, default=8)
        add("--distributed", action="store_true", default=False)
        add("--remat", action="store_true", default=False)
        add("--seed", type=int, default=0)
        return parser

    def gather_options(self, args=None):
        from gfla_tpu_torch import data, tasks

        if not self.initialized:
            self.parser = self.initialize(self.parser)
            self.initialized = True
        parser = self.parser
        opt, _ = parser.parse_known_args(args)
        parser = tasks.get_task_class(opt.model).modify_options(
            parser, self.isTrain)
        opt = parser.parse_args(args)
        ds_cls = data.get_dataset_class(opt.dataset_mode)
        return ds_cls.apply_defaults(opt, self.isTrain)

    def parse(self, args=None, save: bool = True):
        opt = self.gather_options(args)
        opt.isTrain = self.isTrain
        if opt.phase != "val":
            self.print_options(opt, save=save)
        self.opt = opt
        return opt

    @staticmethod
    def print_options(opt, save: bool = True):
        lines = ["--------------Options--------------",
                 *(f"{k}: {v}" for k, v in sorted(vars(opt).items())),
                 "----------------End----------------"]
        print("\n".join(lines))
        if not save:
            return
        expr_dir = os.path.join(opt.checkpoints_dir, opt.name)
        os.makedirs(expr_dir, exist_ok=True)
        fname = "train_opt.txt" if opt.isTrain else "test_opt.txt"
        with open(os.path.join(expr_dir, fname), "wt") as f:
            f.write("\n".join(lines) + "\n")


class TestOptions(BaseOptions):
    isTrain = False

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        parser.set_defaults(serial_batches=True, batchSize=1, phase="test")
        return parser


class TrainOptions(BaseOptions):
    """gfla_tpu's TrainOptions flags (options.py:231-), which follow the
    original's train_options.py."""

    isTrain = True

    def initialize(self, parser):
        parser = BaseOptions.initialize(self, parser)
        add = parser.add_argument
        add("--iter_count", type=int, default=1)
        add("--niter", type=int, default=5_000_000)
        add("--niter_decay", type=int, default=0)
        add("--max_iters", type=int, default=0,
            help="stop after this many iterations (0 = run by niter epochs)")
        add("--lr_policy", type=str, default="lambda")
        add("--lr", type=float, default=1e-4)
        add("--gan_mode", type=str, default="lsgan",
            choices=["wgan-gp", "hinge", "lsgan"])
        add("--display_id", type=int, default=1)
        add("--eval_iters_freq", type=int, default=15000)
        add("--print_freq", type=int, default=1000)
        add("--save_latest_freq", type=int, default=1000)
        add("--save_iters_freq", type=int, default=10000)
        add("--no_html", action="store_true")
        add("--iters_per_epoch", type=int, default=0,
            help="0 = derive from dataset size (epoch-based LR schedule)")
        add("--profile_iters", type=int, default=0)
        return parser
