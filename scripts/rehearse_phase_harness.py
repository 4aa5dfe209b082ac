"""Rehearse ``chip_smoke.py``'s phase harness on the CPU.

    python3 scripts/rehearse_phase_harness.py

Runs ``chip_smoke.phase_harness`` with the coordinators on the CPU. The
step wrappers take the plain torch-op step for CPU tensors and launch
nothing, so the two step functions are wrapped by stand-ins that count
as the kernels' wrappers would; everything else (the harness runs, the
linearizability workload, the planted stale-read bug, the coordinator
checks and the phase's assertions) runs as on the card. Prints the
phase line and the phase's wall time. Times here are CPU times, not
the card's.
"""

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ra_tpu_torch.ops import consensus as C  # noqa: E402
from ra_tpu_torch.ops import step as S  # noqa: E402


def counting(fn, counter):
    def wrapped(*args, **kw):
        setattr(S, counter, getattr(S, counter) + 1)
        return fn(*args, **kw)
    return wrapped


def main() -> int:
    torch.set_num_threads(1)
    C.consensus_step_packed_scat = counting(
        C.consensus_step_packed_scat, "LAUNCHES_FULL")
    C.consensus_step_packed_sub_scat = counting(
        C.consensus_step_packed_sub_scat, "LAUNCHES_SUB")
    t = time.perf_counter()
    kh = chip_smoke.phase_harness(torch, C, S, torch.device("cpu"))
    print(f"phase harness (CPU rehearsal): "
          f"{chip_smoke.harness_line(kh, 'cpu')} | "
          f"{time.perf_counter() - t:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
