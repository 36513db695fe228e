"""chip_smoke.py's data x spatial phase (10c) alone, with the kernel build and
the full-width pose task (phase 6) it starts from: the warp kernels' window
form at S=2 and S=4 on every machine (f32 at the pose, ShapeNet and
animation sites, bf16 at the pose and animation sites), and, where the
machine has two or four cards, the spawned ranks' steps held to one card's:
pose (and its --remat step held to the step without it), shapenet,
shapenetflow under GFLA_PALLAS_CORR=1, and pose in bf16; then, from dance's
and face's full-width tasks (`anim_spatial_states`, in place of phase 18's
states), their chunk steps (f32, dance with --use_mask under
GFLA_PALLAS_CORR=1, dance in bf16, face with --remat) and a keypoint step
(phase_spatial_anim). It prints the card line, each phase's lines and wall
time, the launches of each path that ran, and exits 0 only if every check
held.

    python3 scripts/chip_spatial.py

It needs CUDA; the ranks' part runs on a machine of two or more cards
(dp 2 x sp 2 on four).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_spatial: CUDA is not available", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    from gfla_tpu_torch.runtime import set_tf32

    set_tf32(False)
    with chip_smoke.switches(GFLA_ATTN_PALLAS="auto", GFLA_PALLAS_CORR="0"):
        chip_smoke.timed(chip_smoke.phase_card)
        chip_smoke.timed(chip_smoke.phase_build)
        train = chip_smoke.timed(chip_smoke.phase_train)
        spatial = chip_smoke.timed(chip_smoke.phase_spatial, train)
        del train
        if torch.cuda.device_count() >= 2:
            states = chip_smoke.timed(chip_smoke.anim_spatial_states)
        else:  # phase_spatial_anim reads no state on one card
            states = None
        spatial.update(chip_smoke.timed(chip_smoke.phase_spatial_anim,
                                        states))
    for path in (*chip_smoke.SP_PATHS, *chip_smoke.SP_ANIM_PATHS):
        if spatial[path] is not None:
            print(f"{path} launches {spatial[path]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
