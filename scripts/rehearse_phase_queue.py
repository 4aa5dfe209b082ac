"""Rehearse ``chip_smoke.py``'s phase queue on the CPU at a small width.

    python3 scripts/rehearse_phase_queue.py [--groups 256]

Runs ``chip_smoke.phase_queue`` with the coordinators on the CPU and
``QUEUE_GROUPS`` set to ``--groups``. On CPU tensors the step wrappers launch
nothing and take the plain torch-op step, which the phase counts as a
fault, so the two step entry points are replaced by stand-ins that
count as the kernels' wrappers would and run the plain step (under its
CPU lock) without passing the phase's counter;
``torch.cuda.synchronize`` is a no-op. Everything else (the scenario,
the cut and the catch-up, ``queue_cases.check``, the phase's launch
checks) runs as on the card. Prints the phase's line and its wall time;
times here are CPU times, not the card's.
"""

import argparse
import os
import shutil
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from ra_tpu_torch.ops import consensus as C  # noqa: E402
from ra_tpu_torch.ops import step as S  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--groups", type=int, default=256)
    args = ap.parse_args()
    torch.set_num_threads(1)
    chip_smoke.QUEUE_GROUPS = args.groups
    full, sub = (C.consensus_step_packed_scat_plain,
                 C.consensus_step_packed_sub_scat_plain)

    def step_full(state, packed):
        S.LAUNCHES_FULL += 1
        with C._CPU_STEP_LOCK:
            return full(state, packed)

    def step_sub(state, packed, gidx):
        S.LAUNCHES_SUB += 1
        with C._CPU_STEP_LOCK:
            return sub(state, packed, gidx)

    C.consensus_step_packed_scat = step_full
    C.consensus_step_packed_sub_scat = step_sub
    torch.cuda.synchronize = lambda *a: None
    workdir = tempfile.mkdtemp(prefix="ra_rehearse_queue_")
    t = time.perf_counter()
    try:
        kq = chip_smoke.phase_queue(torch, C, S, torch.device("cpu"), workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"phase queue (CPU rehearsal): {chip_smoke.queue_line(kq, 'cpu')} "
          f"| {time.perf_counter() - t:.2f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
