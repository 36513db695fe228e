"""Metrics CLI, flag for flag gfla_tpu's (`python -m gfla_tpu.metrics`):

    python -m gfla_tpu_torch.metrics --gt_path=GT --distorated_path=GEN \
        --fid_real_path=REAL --name=exp [--allow_fallback_weights] \
        [--gpu_ids=0]

writes `{out_dir}/{name}.csv` with gfla_tpu's columns in its order (name,
the reconstruction means and variances, fid, lpips), `metrics.npz` into
GEN and `statistics.npz` into REAL. Without the Inception or LPIPS weights
in assets/ it refuses, unless --allow_fallback_weights, and then stamps
the file `{name}_FALLBACK-WEIGHTS.csv` and adds a FALLBACK_WEIGHTS column.
`--gpu_ids=-1` runs on the CPU; the default is the first card.
"""

from __future__ import annotations

import argparse
import csv
import os

from gfla_tpu_torch.metrics import (
    FID,
    LPIPS,
    ReconstructionMetrics,
    preprocess_path_for_deform_task,
)
from gfla_tpu_torch.runtime import card_line, select_device


def write_csv(path: str, columns: dict) -> None:
    """One row as pandas' `DataFrame(columns).to_csv(path, index=True)`
    writes it: an empty first header cell, the row index 0, floats as
    their repr."""
    names = list(columns)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f, lineterminator="\n")
        writer.writerow([""] + names)
        writer.writerow([0] + [repr(columns[k][0]) if isinstance(
            columns[k][0], float) else columns[k][0] for k in names])


def main(args=None) -> None:
    parser = argparse.ArgumentParser(
        description="compute FID / reconstruction / LPIPS metrics")
    parser.add_argument("--gt_path", type=str)
    parser.add_argument("--distorated_path", type=str)
    parser.add_argument("--fid_real_path", type=str)
    parser.add_argument("--name", type=str, default="exp")
    parser.add_argument("--calculate_mask", action="store_true")
    parser.add_argument("--out_dir", type=str, default="./eval_results")
    parser.add_argument(
        "--allow_fallback_weights", action="store_true",
        help="proceed without inception/lpips assets (random feature nets); "
             "all outputs are stamped FALLBACK-WEIGHTS and are NOT "
             "comparable to published numbers")
    parser.add_argument("--gpu_ids", type=str, default="0",
                        help="the card to run on; -1 for the CPU")
    args = parser.parse_args(args)
    for arg in vars(args):
        print(f"[{arg}] = {getattr(args, arg)}")

    device = select_device(args.gpu_ids)
    if device.type == "cuda":
        print(card_line())

    fid = FID(allow_fallback=args.allow_fallback_weights, device=device)
    rec = ReconstructionMetrics(device=device)
    lpips = LPIPS(allow_fallback=args.allow_fallback_weights, device=device)
    fallback = fid.fallback or lpips.fallback
    if fallback:
        print("=" * 70)
        print("WARNING: FALLBACK-WEIGHTS — FID/LPIPS below use random "
              "feature nets.\nThey are NOT comparable to published numbers.")
        print("=" * 70)

    print("calculate fid metric...")
    fid_score = fid.calculate_from_disk(args.distorated_path,
                                        args.fid_real_path)
    gt_list, distorted_list = preprocess_path_for_deform_task(
        args.gt_path, args.distorated_path)
    print("calculate reconstruction metric...")
    rec_dic = rec.calculate_from_disk(
        distorted_list, gt_list, save_path=args.distorated_path, sort=False)
    print("calculate LPIPS...")
    lpips_score = lpips.calculate_from_disk(distorted_list, gt_list,
                                            sort=False)

    dic = {"name": [args.name]}
    dic.update(rec_dic)
    dic["fid"] = [fid_score]
    dic["lpips"] = [lpips_score]
    if fallback:
        dic["FALLBACK_WEIGHTS"] = [True]
    if args.calculate_mask:
        print("mask-LPIPS requires pose CSVs; see gfla_tpu_torch.metrics."
              "lpips masked API")

    os.makedirs(args.out_dir, exist_ok=True)
    stem = args.name + ("_FALLBACK-WEIGHTS" if fallback else "")
    path = os.path.join(args.out_dir, stem + ".csv")
    write_csv(path, dic)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
