"""Linearizability checking — the framework's Jepsen tier.

The reference relies on continuous external Jepsen runs against its KV
store (reference: ``README.md:31-34``, ``.github/workflows/
trigger-jepsen.yml:1-17``; the checker lives in rabbitmq/ra-kv-store).
This module brings that verification tier in-repo:

- a **history recorder**: concurrent clients issue put/delete/read
  operations against a live cluster while a nemesis injects faults,
  recording ``invoke``/``ok``/``fail``/``info`` events with monotonic
  timestamps (``info`` = timed out, may or may not have taken effect —
  Jepsen's indeterminate result);
- a **register checker**: Wing–Gong linearizability search with
  memoization, applied per key (P-compositionality: a KV map is
  linearizable iff each key's sub-history is a linearizable register);
- a **workload driver** (``run_workload``) wiring both against either
  execution backend.

Write values are made unique per (client, seq) so the register search
prunes hard; at CI scale (5 keys x a few hundred ops) a check completes
in milliseconds. ``check_register`` is deliberately independent of the
driver so synthetic histories (including buggy ones) can be verified in
unit tests — a checker that cannot catch a planted stale read proves
nothing.
"""

from __future__ import annotations

import dataclasses
import math
import random
import threading
import time
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class Op:
    """One client operation on a single key.

    ``kind``: "write" (put/delete — delete writes None) or "read".
    ``value``: the written value, or the value the read observed.
    ``ret`` is ``math.inf`` for indeterminate ops (timeout — the write
    may take effect at any later time, or never).
    """

    client: int
    kind: str
    value: Any
    inv: float
    ret: float

    @property
    def indeterminate(self) -> bool:
        return self.ret == math.inf


class TooManyStates(Exception):
    """The search exceeded its state budget (raise, never guess)."""


def check_register(
    ops: List[Op],
    init: Any = None,
    max_states: int = 2_000_000,
) -> Optional[List[int]]:
    """Wing–Gong search for a single register.

    Returns a witness linearization (list of op positions) if the
    history is linearizable, else ``None``. Indeterminate writes may
    linearize anywhere after their invocation or never; failed reads
    should not be passed in (a read that returned nothing constrains
    nothing).
    """
    ops = sorted(ops, key=lambda o: (o.inv, o.ret))
    n = len(ops)
    if n == 0:
        return []
    if n > 2000:
        # guard explicitly instead of silently degrading (Python ints
        # handle any mask width; cost is the concern)
        raise TooManyStates(f"history too long for bitmask search: {n}")
    invs = [o.inv for o in ops]
    rets = [o.ret for o in ops]
    full = (1 << n) - 1
    determinate_mask = 0
    for i, o in enumerate(ops):
        if not o.indeterminate:
            determinate_mask |= 1 << i
    # iterative DFS; the memo maps (mask, state) -> (parent_key, op_i)
    # so each stack entry is O(1) and the witness is reconstructed by
    # walking predecessors (carrying the order tuple per entry would
    # allocate O(n) per state and defeat the max_states budget)
    parent: Dict[Tuple[int, Any], Tuple[Optional[Tuple[int, Any]], int]] = {}
    stack: List[Tuple[int, Any, Optional[Tuple[int, Any]], int]] = [
        (0, init, None, -1)
    ]
    while stack:
        if len(parent) > max_states:
            raise TooManyStates(f"exceeded {max_states} search states")
        mask, state, pkey, op_i = stack.pop()
        key = (mask, state)
        if key in parent:
            continue
        parent[key] = (pkey, op_i)
        if mask & determinate_mask == determinate_mask:
            out: List[int] = []
            k: Optional[Tuple[int, Any]] = key
            while k is not None:
                pk, oi = parent[k]
                if oi >= 0:
                    out.append(oi)
                k = pk
            out.reverse()
            return out
        # two smallest return times among un-linearized ops, so the
        # real-time constraint (j returned before i invoked => j first)
        # can exclude each candidate's own ret
        m1 = m2 = math.inf
        a1 = -1
        for i in range(n):
            if mask >> i & 1:
                continue
            r = rets[i]
            if r < m1:
                m2, m1, a1 = m1, r, i
            elif r < m2:
                m2 = r
        for i in range(n):
            if mask >> i & 1:
                continue
            bound = m2 if i == a1 else m1
            if invs[i] > bound:
                continue  # some other pending op returned before i began
            o = ops[i]
            if o.kind == "read":
                if o.value != state:
                    continue
                nxt = state
            else:
                nxt = o.value
            stack.append((mask | (1 << i), nxt, key, i))
    return None


@dataclasses.dataclass
class CheckResult:
    ok: bool
    violations: List[str]
    per_key_ops: Dict[Any, int]

    def __bool__(self) -> bool:  # pragma: no cover - convenience
        return self.ok


def check_history(
    history: Dict[Any, List[Op]], init: Any = None, max_states: int = 2_000_000
) -> CheckResult:
    """Check a per-key history map (P-compositionality: each key is an
    independent register)."""
    violations = []
    for key, ops in sorted(history.items(), key=lambda kv: str(kv[0])):
        witness = check_register(ops, init=init, max_states=max_states)
        if witness is None:
            detail = "; ".join(
                f"c{o.client} {o.kind}({o.value!r}) "
                f"[{o.inv:.4f},{'inf' if o.indeterminate else f'{o.ret:.4f}'}]"
                for o in sorted(ops, key=lambda o: o.inv)[:12]
            )
            violations.append(f"key {key!r} not linearizable: {detail}")
    if violations:
        # a nemesis-tier linearizability failure dumps the flight
        # recorder: the election/deposition/failpoint trace around the
        # violating window is the first thing a debugger needs
        from ra_tpu_torch import obs

        obs.flight_recorder().dump(header=" [linearize]")
    return CheckResult(
        ok=not violations,
        violations=violations,
        per_key_ops={k: len(v) for k, v in history.items()},
    )


class HistoryRecorder:
    """Thread-safe invoke/complete recorder building per-key op lists."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._by_key: Dict[Any, List[Op]] = {}
        self.t0 = time.monotonic()

    def now(self) -> float:
        return time.monotonic() - self.t0

    def record(self, key, op: Op) -> None:
        with self._lock:
            self._by_key.setdefault(key, []).append(op)

    def history(self) -> Dict[Any, List[Op]]:
        with self._lock:
            return {k: list(v) for k, v in self._by_key.items()}


def _client_loop(
    recorder: HistoryRecorder,
    cid: int,
    seed: int,
    keys: List[str],
    n_ops: int,
    do_write,
    do_read,
) -> None:
    rng = random.Random(seed * 1000 + cid)
    seq = 0
    for _ in range(n_ops):
        key = rng.choice(keys)
        roll = rng.random()
        inv = recorder.now()
        if roll < 0.5:
            seq += 1
            value = (cid, seq)
            try:
                do_write(key, value)
                recorder.record(key, Op(cid, "write", value, inv, recorder.now()))
            except Exception:  # noqa: BLE001 — indeterminate
                recorder.record(key, Op(cid, "write", value, inv, math.inf))
        elif roll < 0.6:
            try:
                do_write(key, None)  # delete
                recorder.record(key, Op(cid, "write", None, inv, recorder.now()))
            except Exception:  # noqa: BLE001
                recorder.record(key, Op(cid, "write", None, inv, math.inf))
        else:
            try:
                got = do_read(key)
                recorder.record(key, Op(cid, "read", got, inv, recorder.now()))
            except Exception:  # noqa: BLE001 — failed read constrains nothing
                pass


def run_workload(
    seed: int = 0,
    backend: str = "per_group_actor",
    n_clients: int = 4,
    ops_per_client: int = 40,
    n_keys: int = 5,
    nodes: int = 3,
    partitions: bool = True,
    op_timeout: float = 10.0,
    device=None,
) -> CheckResult:
    """Concurrent clients + nemesis against a live KV cluster; returns
    the checker verdict over the recorded history. ``device`` places the
    batch backend's coordinators (``None``: ``"cuda"``)."""
    if backend == "per_group_actor":
        setup = _setup_actor
    elif backend == "tpu_batch":
        def setup(seed, nodes, op_timeout):
            return _setup_batch(seed, nodes, op_timeout, device=device)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    do_write, do_read, nemesis_step, heal, teardown = setup(seed, nodes, op_timeout)
    recorder = HistoryRecorder()
    keys = [f"k{i}" for i in range(n_keys)]
    try:
        threads = [
            threading.Thread(
                target=_client_loop,
                args=(recorder, cid, seed, keys, ops_per_client,
                      do_write, do_read),
                daemon=True,
            )
            for cid in range(n_clients)
        ]
        for t in threads:
            t.start()
        nem_rng = random.Random(seed ^ 0xFA11)
        while any(t.is_alive() for t in threads):
            if partitions and nem_rng.random() < 0.4:
                nemesis_step(nem_rng)
            time.sleep(0.25)
        heal()
        for t in threads:
            t.join(timeout=60)
    finally:
        teardown()
    return check_history(recorder.history())


# -- backend wiring ---------------------------------------------------------


def _make_ops(ids, op_timeout: float, seed: int):
    """The client closures are backend-independent: both backends serve
    the same public API surface."""
    from ra_tpu_torch import api

    pick = random.Random(seed ^ 0xC11E)

    def do_write(key, value):
        cmd = ("put", key, value) if value is not None else ("delete", key)
        api.process_command(pick.choice(ids), cmd, timeout=op_timeout)

    def do_read(key):
        out = api.consistent_query(
            pick.choice(ids), lambda s, k=key: s.get(k), timeout=op_timeout
        )
        return out[1]

    return do_write, do_read


def _make_nemesis(names, get_transport):
    """Partition nemesis over a ``name -> transport`` accessor (the only
    thing that differs between backends)."""
    blocked = [None]

    def nemesis_step(rng):
        if blocked[0] is None and rng.random() < 0.7:
            victim = rng.choice(names)
            for n in names:
                if n != victim:
                    tv, tn = get_transport(victim), get_transport(n)
                    if tv is not None:
                        tv.block(victim, n)
                    if tn is not None:
                        tn.block(n, victim)
            blocked[0] = victim
        else:
            heal()

    def heal():
        for n in names:
            t = get_transport(n)
            if t is not None:
                t.unblock_all()
        blocked[0] = None

    return nemesis_step, heal


def _setup_actor(seed: int, nodes: int, op_timeout: float):
    import tempfile

    from ra_tpu_torch import api, leaderboard
    from ra_tpu_torch.kv_harness import DictKv
    from ra_tpu_torch.runtime.transport import registry as node_registry
    from ra_tpu_torch.system import SystemConfig

    leaderboard.clear()
    base = tempfile.mkdtemp(prefix="ra_linear_")
    names = [f"lin{seed}_{i}" for i in range(nodes)]
    for n in names:
        api.start_node(
            n, SystemConfig(name=f"lin{seed}", data_dir=f"{base}/{n}"),
            election_timeout_s=0.15, tick_interval_s=0.1, detector_poll_s=0.05,
        )
    ids = [(f"lk{i}", names[i]) for i in range(nodes)]
    api.start_cluster(f"linc{seed}", DictKv, ids, timeout=20)
    do_write, do_read = _make_ops(ids, op_timeout, seed)

    def get_transport(n):
        node = node_registry().get(n)
        return None if node is None else node.transport

    nemesis_step, heal = _make_nemesis(names, get_transport)

    def teardown():
        heal()
        for n in names:
            try:
                api.stop_node(n)
            except Exception:  # noqa: BLE001
                pass
        leaderboard.clear()

    return do_write, do_read, nemesis_step, heal, teardown


def _setup_batch(seed: int, nodes: int, op_timeout: float, device=None):
    from ra_tpu_torch import leaderboard
    from ra_tpu_torch.kv_harness import DictKv
    from ra_tpu_torch.protocol import ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator
    from ra_tpu_torch.ops import consensus as C

    leaderboard.clear()
    names = [f"linb{seed}_{i}" for i in range(nodes)]
    coords = {}
    for n in names:
        c = BatchCoordinator(n, capacity=8, num_peers=nodes,
                             tick_interval_s=0.3, election_timeout_s=0.15,
                             detector_poll_s=0.05, device=device)
        coords[n] = c
        c.start()
    gname = f"ling{seed}"
    ids = [(gname, n) for n in names]
    for n in names:
        coords[n].add_group(gname, f"lincb{seed}", ids, DictKv())
    coords[names[0]].deliver(ids[0], ElectionTimeout(), None)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and not any(
        coords[n].by_name[gname].role == C.R_LEADER for n in names
    ):
        time.sleep(0.05)
    do_write, do_read = _make_ops(ids, op_timeout, seed)
    nemesis_step, heal = _make_nemesis(
        names, lambda n: coords[n].transport
    )

    def teardown():
        heal()
        for c in coords.values():
            c.stop()
        leaderboard.clear()

    return do_write, do_read, nemesis_step, heal, teardown


if __name__ == "__main__":  # pragma: no cover — ops entry point
    import argparse
    import sys

    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--backend", default="per_group_actor")
    ap.add_argument("--clients", type=int, default=5)
    ap.add_argument("--ops", type=int, default=100)
    ap.add_argument("--device", default=None,
                    help="torch device of the batch backend's "
                         "coordinators (default: cuda)")
    args = ap.parse_args()
    res = run_workload(seed=args.seed, backend=args.backend,
                       n_clients=args.clients, ops_per_client=args.ops,
                       device=args.device)
    print(f"keys={res.per_key_ops} linearizable={res.ok}")
    for v in res.violations:
        print("VIOLATION:", v)
    sys.exit(0 if res.ok else 1)
