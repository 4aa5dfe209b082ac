"""Benchmark machine + driver.

Capability parity with the reference's ``ra_bench`` (``src/ra_bench.erl``):
a no-op apply machine that emits a release_cursor every
``RELEASE_EVERY`` entries (:48-55), plus a pipelining driver that keeps
``pipe_size`` commands in flight per client and reports ops/sec.
"""

from __future__ import annotations

import threading
import time
from typing import Any, List, Tuple

from ra_tpu_torch.effects import ReleaseCursor
from ra_tpu_torch.machine import Machine

RELEASE_EVERY = 100_000


class BenchMachine(Machine):
    """No-op apply; periodic release cursor (state is an entry counter)."""

    def init(self, config) -> int:
        return 0

    def apply(self, meta, cmd, state: int):
        state += 1
        if meta["index"] % RELEASE_EVERY == 0:
            return state, state, [ReleaseCursor(meta["index"], state)]
        return state, state

    def apply_many(self, meta, cmds, state):
        """O(1) batch apply for plain command runs (the pipeline hot
        path): the machine only counts entries, so a run of n commands
        is state+n — unless the run crosses a release-cursor boundary,
        where we fall back to per-entry apply so the effect still
        fires (reference: no-op apply, src/ra_bench.erl:48-55)."""
        n = len(cmds)
        hi = meta["index"]
        lo = hi - n + 1
        if (lo - 1) // RELEASE_EVERY != hi // RELEASE_EVERY:
            return None  # boundary inside the batch: per-entry path
        return state + n

    def overview(self, state):
        return {"type": "bench", "applied": state}


def run_driver(
    api_mod,
    member,
    who: str,
    node_name: str,
    target_ops: int = 10_000,
    degree: int = 5,
    pipe_size: int = 500,
    payload: bytes = b"x" * 256,
) -> Tuple[float, int]:
    """Pipelined load driver (reference defaults: DEGREE=5 concurrent
    clients, PIPE_SIZE=500 in flight, 256-byte payloads,
    src/ra_bench.erl:18-40). Returns (ops_per_sec, completed)."""
    done = threading.Event()
    completed = [0]
    lock = threading.Lock()
    # each client sends total // degree; round so completion is reachable
    total = (target_ops // degree) * degree

    def sink(_from, corrs):
        with lock:
            completed[0] += len(corrs)
            if completed[0] >= total:
                done.set()

    api_mod.register_client(node_name, who, sink)
    t0 = time.perf_counter()
    sent = [0]

    def client(k: int):
        budget = total // degree
        for i in range(budget):
            while True:
                with lock:
                    inflight = sent[0] - completed[0]
                if inflight < pipe_size:
                    break
                time.sleep(0.0005)
            api_mod.pipeline_command(member, payload, (k, i), who)
            with lock:
                sent[0] += 1

    threads = [threading.Thread(target=client, args=(k,), daemon=True) for k in range(degree)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    done.wait(timeout=120)
    dt = time.perf_counter() - t0
    return completed[0] / dt, completed[0]
