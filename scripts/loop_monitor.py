#!/usr/bin/env python3
"""One full-width started-loop scenario of ``tests/loop_cases.py`` on the
card, with a monitor that prints the process's resident memory and
thread count, the card's allocated bytes, PyTorch's pinned host pool and
the step-kernel launch counts every 2 s.

    python3 scripts/loop_monitor.py flip   # the flip soak, 10240 x 3, WAL
    python3 scripts/loop_monitor.py idle   # idle parking, 10240 groups

Each line goes to standard output and to ``chiprun_out/loop_monitor.log``.
It is the shape of ``chip_smoke.phase_loop`` (b) or (c), without the
phase's launch checks; it imports nothing of JAX.
"""

import os
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ra_tpu_torch import bench  # noqa: E402
from ra_tpu_torch.ops import kernels  # noqa: E402
from ra_tpu_torch.ops import step as S  # noqa: E402

T0 = time.perf_counter()


def main(which: str) -> None:
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    out = open(os.path.join(HERE, "chiprun_out", "loop_monitor.log"), "w")

    def say(*a):
        line = f"[{time.perf_counter() - T0:8.2f}] " + " ".join(map(str, a))
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def status():
        with open("/proc/self/status") as f:
            return {k: v.strip() for k, v in (
                line.split(":", 1) for line in f
                if line.startswith(("VmRSS", "VmHWM", "Threads")))}

    done = threading.Event()

    def monitor():
        while not done.wait(2.0):
            host = {k: v for k, v in torch.cuda.host_memory_stats().items()
                    if k in ("allocated_bytes.current", "num_host_alloc")}
            say("mon", status(), "cuda_alloc", torch.cuda.memory_allocated(),
                "host", host, "launches", S.LAUNCHES_FULL, S.LAUNCHES_SUB)

    def probe():
        say("probe", S.LAUNCHES_FULL, S.LAUNCHES_SUB)
        return (S.LAUNCHES_FULL, S.LAUNCHES_SUB)

    kernels.build_many(["quorum", "step"])
    say("built", cs.nvidia_smi_line())
    threading.Thread(target=monitor, daemon=True).start()
    LC = cs.loop_cases()
    card = cs.lane_cases().Lane("ra_tpu_torch", torch.device("cuda", 0))
    try:
        if which == "flip":
            wd = tempfile.mkdtemp(prefix="ra_loop_monitor_")
            storage = []

            def logs(coords, names):
                cs.open_storage(coords, names, wd, storage)
                return bench.wal_logs(storage, cs.GROUPS)

            try:
                rec = LC.flip_soak(
                    card, prefix="fsw", groups=cs.GROUPS,
                    capacity=cs.GROUPS, per_burst=1,
                    bursts=cs.LOOP_FLIP_BURSTS,
                    election_timeout_s=cs.API_ELECTION_TIMEOUT_S,
                    detector_poll_s=0.1, logs=logs, probe=probe, bulk=True,
                    reply_timeout_s=cs.LOOP_REPLY_TIMEOUT_S,
                    settle_timeout_s=cs.LOOP_SETTLE_TIMEOUT_S)
            finally:
                for _tables, w, _d in storage:
                    w.close()
                    w.segment_writer.close()
            del rec["expect"]
        else:
            rec = LC.idle_parking(
                card, prefix="zwfull", groups=cs.GROUPS, capacity=cs.GROUPS,
                cmds=1, probe=probe, reply_timeout_s=cs.LOOP_REPLY_TIMEOUT_S,
                settle_timeout_s=cs.LOOP_SETTLE_TIMEOUT_S)
        del rec["states"]
        say(which, "done", rec, status())
    finally:
        done.set()
        out.close()


if __name__ == "__main__":
    if len(sys.argv) != 2 or sys.argv[1] not in ("flip", "idle"):
        sys.exit(__doc__)
    main(sys.argv[1])
