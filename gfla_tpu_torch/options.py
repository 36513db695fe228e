"""Command-line options of the port: the same flag surface as gfla_tpu's
options (gfla_tpu/options/options.py), which follows the original GFLA's, so
the same command lines parse to the same namespace.

The composition is the same three phases: base flags, then the task's
`modify_options` (from the port's own task registry), then the dataset's
flags and defaults. `--gpu_ids` selects the device here: -1 is the CPU,
anything else `cuda:<id>`, and with `--mesh_devices` the devices of a
host's training ranks (gfla_tpu_torch.runtime.select_devices).
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


# the heads that train under --spatial, and what the others wait for
SPATIAL_HEADS = ("pose", "poseflownet", "shapenet", "shapenetflow")
SPATIAL_TODO = ("not ported yet (ROADMAP.md, queue 1, item 2: --spatial for "
                "dance, face and keypoint)")


def refuse_parallel_flags(opt) -> None:
    """Raise NotImplementedError for `--spatial` above 1 (gfla_tpu's
    train.py reads 0 as 1 too, and `--halo` only under it) where the port
    has no data x spatial mode yet: the animation heads and keypoint. The
    message names the ROADMAP item that will port it. The four single-frame
    heads take it in either compute dtype and with `--remat`."""
    sp = opt.spatial or 1
    if sp > 1 and opt.model not in SPATIAL_HEADS:
        raise NotImplementedError(
            f"--spatial={sp} with --model={opt.model}: {SPATIAL_TODO}")


def _height(opt) -> int:
    size = opt.load_size
    return size if isinstance(size, int) else size[0]


def spatial_levels(opt):
    """(what, rows, rows each band must hold) of every resolution the
    head's step convolves, pools or gathers: every band needs a whole
    number of rows, at least 1 (each conv lends a neighbour 1 row), 2 where
    the flow net's and G's output reflect-pad (a band reflects about its
    edge row), and at an attention level k - 1 (the target's edge pad
    lends k//2, the affine regularisation's patches k - 1).
    - pose: G (its encoder and decoder levels), the flow net's five
      levels, D's and VGG19's;
    - poseflownet and shapenetflow (stage 1): the flow net's levels (for
      shapenetflow its bottleneck holds the tiled viewpoint code), VGG19's
      and the regularisation at the attention levels; no G decoder, no D;
    - shapenet: first the target net's seed, the code tiled to 8x8 rows,
      and its 16 and 32 levels (ShapeNetTargetNet grows from it whatever
      the image's height), then as pose."""
    H = _height(opt)
    model = getattr(opt, "model", "pose")
    flow = [(f"the flow net's level {d}", H >> d, 2 if d < 5 else 1)
            for d in range(1, 6)]
    if model.startswith("shapenet"):
        flow[-1] = ("the flow net's level 5 (the tiled code)", H >> 5, 1)
    vgg = [(f"VGG19's level {d}", H >> d, 1) for d in range(1, 5)]
    attn = [(key, k) for key, k in opt.kernel_size.items()
            if int(key) in [int(a) for a in opt.attn_layer]]
    if model in ("poseflownet", "shapenetflow"):
        return flow + vgg + [
            (f"the regularisation at level {key} (k={k})", H >> int(key),
             max(1, k - 1)) for key, k in attn]
    d_layers = getattr(opt, "d_layers", None) or (
        3 if opt.dataset_mode == "market" else 4)
    levels = []
    if model == "shapenet":
        levels += [("the target net's 8x8 seed", 8, 1),
                   ("the target net's level 16", 16, 1),
                   ("the target net's level 32", 32, 1)]
    levels += [("G's output", H, 2)]
    levels += [(f"G's level {d}", H >> d, 1) for d in range(1, opt.layers + 1)]
    levels += flow
    levels += [(f"D's level {d}", H >> d, 1) for d in range(1, d_layers + 1)]
    levels += vgg
    levels += [(f"the attention at level {key} (k={k})", H >> int(key),
                max(1, k - 1)) for key, k in attn]
    return levels


def spatial_layout(opt, ranks: int, local_ranks: int) -> int:
    """The spatial size S of `--spatial` on `ranks` ranks, `local_ranks` of
    them on this host, after gfla_tpu's checks (train.py:153-162: S divides
    the device count and the image height) and the port's: a spatial group
    stays on one host, the host's batch splits over its data indices, and
    at every level of the path (`spatial_levels`) a band holds a whole
    number of rows, enough for what it lends (gfla_tpu's GSPMD also takes
    uneven shards; the port does not). Raises SystemExit otherwise."""
    sp = max(1, opt.spatial or 1)
    if sp == 1:
        return 1
    if ranks % sp:
        raise SystemExit(f"--spatial {sp} must divide the device count "
                         f"{ranks}")
    if _height(opt) % sp:
        raise SystemExit(f"--spatial {sp} must divide the image height "
                         f"{opt.load_size}")
    if local_ranks % sp:
        raise SystemExit(f"--spatial {sp}: a spatial group stays on one "
                         f"host, which has {local_ranks} ranks")
    if opt.batchSize % (local_ranks // sp):
        raise SystemExit(f"--batchSize={opt.batchSize} does not split over "
                         f"{local_ranks // sp} data indices on this host")
    for what, rows, need in spatial_levels(opt):
        if rows % sp or rows // sp < need:
            raise SystemExit(
                f"--spatial {sp}: {what} has {rows} rows, which do not "
                f"split into {sp} bands of at least {need} row"
                f"{'s' if need > 1 else ''} each (raise --load_size)")
    return sp


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
            help="-1 runs on the CPU; N runs on cuda:N; a list N,M,... "
                 "trains on each (serving takes the first)")
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
        # gfla_tpu's parallelism flags. Training: --mesh_devices=N runs N
        # ranks on this host, --distributed joins a torchrun world, and
        # --spatial=S splits every image's rows over S of them (the four
        # single-frame heads, refuse_parallel_flags and spatial_layout).
        # Serving runs on one device, as gfla_tpu's test.py does.
        add("--mesh_devices", type=int, default=0,
            help="training: data-parallel ranks on this host, one a device "
                 "(the first N --gpu_ids, or cuda:0..N-1 when one id is "
                 "given; N CPU ranks with --gpu_ids=-1); 0 = every listed "
                 "id; the global batch is --batchSize per host")
        add("--spatial", type=int, default=1,
            help="training, --model=pose, poseflownet, shapenet or "
                 "shapenetflow (either --compute_dtype, with or without "
                 "--remat): split every image's rows into this many bands, "
                 "one a rank (the ranks / S data indices split the batch)")
        add("--halo", type=int, default=8,
            help="rows each band's attention gathers take from each "
                 "neighbour under --spatial")
        add("--distributed", action="store_true", default=False,
            help="training: join the multi-host world torchrun's "
                 "environment describes (RANK, WORLD_SIZE, LOCAL_RANK, "
                 "LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT)")
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
        ds_cls = data.get_dataset_class(opt.dataset_mode)
        if hasattr(ds_cls, "modify_options"):  # the dataset's own flags
            parser = ds_cls.modify_options(parser, self.isTrain)
        opt = parser.parse_args(args)
        return ds_cls.apply_defaults(opt, self.isTrain)

    def parse(self, args=None, save: bool = True, show: bool = True):
        """The parsed options, printed and (with `save`) written to the
        experiment directory unless `show` is False."""
        opt = self.gather_options(args)
        opt.isTrain = self.isTrain
        if show and opt.phase != "val":
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
