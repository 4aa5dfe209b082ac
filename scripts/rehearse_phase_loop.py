"""Rehearse ``chip_smoke.py``'s phase loop, the failover (d), the
restart (e) and the replacement (f) included, on the CPU at a small
width.

    python3 scripts/rehearse_phase_loop.py [--groups 256]

Runs ``chip_smoke.phase_loop`` with the coordinators on the CPU,
``GROUPS`` cut to ``--groups`` and the full-width flip soak's bursts to
three (all groups, a tenth, all groups). On CPU tensors the step
wrappers launch nothing and take the plain torch-op step, which the
phase counts as a fault, so the two step entry points are replaced by
stand-ins that count as the kernels' wrappers would and run the plain
step (under its CPU lock) without passing the phase's counter;
``torch.cuda.synchronize`` is a no-op. Everything else (the scenarios,
the failover, the restart and the replacement on (b)'s cluster, the
phase's assertions) runs as on the card. Prints the phase's lines and its wall time; times here are CPU
times, not the card's.
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
    g = chip_smoke.GROUPS = args.groups
    chip_smoke.LOOP_FLIP_BURSTS = (range(g), range(g // 10), range(g))
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
    workdir = tempfile.mkdtemp(prefix="ra_rehearse_loop_")
    t = time.perf_counter()
    try:
        kp = chip_smoke.phase_loop(torch, C, S, torch.device("cpu"), workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"phase loop (CPU rehearsal): {chip_smoke.loop_line(kp, 'cpu')} | "
          f"{time.perf_counter() - t:.2f} s")
    then = kp["flip_soak_full"]["then"]
    print(f"phase loop (d) (CPU rehearsal): "
          f"{chip_smoke.failover_line(then['failover'], 'cpu')}")
    print(f"phase loop (e) (CPU rehearsal): "
          f"{chip_smoke.restart_line(then['restart'], 'cpu')}")
    print(f"phase loop (f) (CPU rehearsal): "
          f"{chip_smoke.replace_line(then['replace'], 'cpu')}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
