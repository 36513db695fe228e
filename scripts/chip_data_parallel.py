"""chip_smoke.py's data-parallel phase (10b) alone, with the kernel build and
the full-width pose task (phase 6) it starts from: a world of one under
NCCL, the training CLI with --distributed, and, where the machine has two
cards, two spawned ranks held to one card. It prints the card line, each
phase's lines and wall time, and exits 0 only if every check held.

    python3 scripts/chip_data_parallel.py

It needs CUDA; on a four-card machine the two-rank part runs.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_data_parallel: CUDA is not available", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    from gfla_tpu_torch.runtime import set_tf32

    set_tf32(False)
    with chip_smoke.switches(GFLA_ATTN_PALLAS="auto", GFLA_PALLAS_CORR="0"):
        chip_smoke.timed(chip_smoke.phase_card)
        chip_smoke.timed(chip_smoke.phase_build)
        train = chip_smoke.timed(chip_smoke.phase_train)
        counts = chip_smoke.timed(chip_smoke.phase_data_parallel, train)
    print(f"ddp_train launches {counts['ddp_train']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
