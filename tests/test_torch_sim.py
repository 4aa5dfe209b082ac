"""The deterministic simulator on both packages, on the CPU.

``run_schedule`` of ``ra_tpu.sim`` and of ``ra_tpu_torch.sim`` runs the
same schedules (the seeds and fault mixes of ``tests/test_sim.py``) and
must give the same result, exactly:

- ``violations``, ``steps``, ``virtual_ms``, ``replies`` and
  ``client_msgs`` are equal;
- ``dumps(result.schedule)`` is equal after the package-name rewrite
  (its header names the package);
- each node's ``last_applied`` is equal, and so is its final machine
  state, compared decoded (the fifo and session states are dataclasses,
  whose pickles, and so whose fingerprints, name their package);
- ``trace_text`` is equal after the package-name rewrite where the
  states are builtin dicts (kv, kvread); for the dataclass states every
  trace line is equal apart from its fingerprint, and the fingerprints
  of the two packages correspond one to one.

Then the port's own oracles are held to the claims of the reference
tests: the explorer finds and shrinks the reversed-requeue bug, the
lease drift-bound bug is caught and shrunk, and the disk-budget cases
hold.
"""

import re

import pytest
import torch

import ra_tpu.sim as ref_sim
import ra_tpu.sim.world as ref_world
import ra_tpu_torch.lease as port_lease
import ra_tpu_torch.models.fifo as port_fifo
import ra_tpu_torch.sim as port_sim
import ra_tpu_torch.sim.world as port_world

from torch_batch import decode

torch.set_num_threads(1)

FAULTS = dict(drop_p=0.02, dup_p=0.02, delay_p=0.15, nemesis=True)
# the lines whose last token is a state fingerprint
FP_KINDS = ("apply", "install", "final")


def rewrite(text: str) -> str:
    return re.sub(r"\bra_tpu\b", "ra_tpu_torch", text)


def run_world(world_mod, sched):
    """(SimResult, each running node's machine state) of one schedule."""
    w = world_mod.SimWorld(sched)
    res = w.run()
    return res, {n: node.server.machine_state
                 for n, node in w.nodes.items() if node.running}


def _lease_deposition_ops():
    """The deposition-race op list of ``tests/test_sim.py``."""
    ops = [(t, ("cmd", ("put", "seq", 0))) for t in range(600, 2801, 200)]
    return tuple(ops + [
        (2990, ("cmd", ("put", "seq", 0))),
        (3000, ("isolate", "leader")),
        (3170, ("etimo", "other")),
        (3200, ("cmd", ("put", "seq", 0))),
        (3215, ("read", "old")),
        (3230, ("read", "old")),
        (3245, ("read", "old")),
        (3255, ("read", "old")),
        (3400, ("unblock",)),
    ])


def _disk_ops():
    return tuple((200 + 150 * i, ("cmd", ("put", "seq", i)))
                 for i in range(20))


def schedule(sim, case):
    kind, seed = case
    if kind == "deposition":
        return sim.Schedule(seed=seed, workload="kvread", lease=True,
                            horizon_ms=4_000, settle_ms=2_000,
                            ops=_lease_deposition_ops())
    if kind == "disk":
        return sim.Schedule(seed=0, workload="kv", nodes=3, horizon_ms=4_000,
                            settle_ms=3_000, disk_budget_bytes=seed,
                            ops=_disk_ops())
    workload, faulted = kind.split("/")
    kw = dict(FAULTS) if faulted == "faults" else {}
    if workload == "kvread":
        kw.update(lease=True, skew_ppm=10_000)
    return sim.Schedule(seed=seed, workload=workload, **kw)


# the schedules of tests/test_sim.py:37-97 and 186-251. The disk-budget
# schedules are left out here: the sim's disk model charges each entry
# ``len(pickle.dumps(cmd))`` bytes, and a pickled ``Command`` names its
# package, so the port's entries cost more bytes and a budget runs out
# at another entry (as with the fingerprints, nothing in the copy is
# changed for it); the port's disk-budget cases are held to the
# reference tests' claims below.
CASES = [
    ("kv/faults", 11), ("fifo/faults", 11), ("session/faults", 11),
    ("kv/clean", 5), ("fifo/clean", 5), ("session/clean", 5),
    ("fifo/faults", 23), ("session/faults", 77), ("kv/faults", 5),
    ("kv/faults", 0), ("kv/faults", 1), ("kv/faults", 2),
    ("session/faults", 0), ("session/faults", 1), ("session/faults", 2),
    ("session/faults", 3),
    ("kvread/faults", 1), ("kvread/faults", 3), ("kvread/faults", 8),
    ("deposition", 1), ("deposition", 2), ("deposition", 3),
]


def assert_same_result(a, b, states_a, states_b):
    assert b.violations == a.violations
    assert (b.steps, b.virtual_ms) == (a.steps, a.virtual_ms)
    assert b.replies == a.replies
    assert b.client_msgs == a.client_msgs
    assert port_sim.dumps(b.schedule) == rewrite(ref_sim.dumps(a.schedule))
    assert {n: v[0] for n, v in b.final.items()} == \
        {n: v[0] for n, v in a.final.items()}
    assert {n: decode(s) for n, s in states_b.items()} == \
        {n: decode(s) for n, s in states_a.items()}
    if all(type(s) is dict for s in states_a.values()):
        assert b.final == a.final
        assert b.trace_text == rewrite(a.trace_text)
        return
    la, lb = rewrite(a.trace_text).splitlines(), b.trace_text.splitlines()
    assert len(lb) == len(la)
    fwd, back = {}, {}
    for x, y in zip(la, lb):
        if x.split(" ", 1)[0] in FP_KINDS:
            (x, fx), (y, fy) = x.rsplit(" ", 1), y.rsplit(" ", 1)
            assert fwd.setdefault(fx, fy) == fy and back.setdefault(fy, fx) == fx, \
                (x, fx, fy)
        assert y == x
    assert fwd, "no fingerprinted line in the trace"


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}-{c[1]}")
def test_run_schedule_equal_on_both_packages(case):
    a, sa = run_world(ref_world, schedule(ref_sim, case))
    b, sb = run_world(port_world, schedule(port_sim, case))
    assert_same_result(a, b, sa, sb)
    # and a dumped schedule replays identically on the port
    c, _ = run_world(port_world, port_sim.loads(port_sim.dumps(b.schedule)))
    assert c.trace_text == b.trace_text and c.final == b.final


def test_schedule_dump_loads_across_packages():
    """A dump of either package loads in the other (after the header's
    rewrite) into the same ops."""
    sched = ref_sim.Schedule(seed=23, workload="fifo", **FAULTS)
    a = ref_sim.run_schedule(sched)
    back = port_sim.loads(rewrite(ref_sim.dumps(a.schedule)))
    assert back.ops == a.schedule.ops
    assert port_sim.run_schedule(back).violations == a.violations == []


# ---------------------------------------------------------------------------
# the port's oracles have teeth (the claims of tests/test_sim.py)


def test_explorer_finds_and_shrinks_reversed_requeue_bug_on_port(monkeypatch):
    monkeypatch.setattr(port_fifo, "SIM_BUG_REVERSED_REQUEUE", True)
    r = port_sim.run_schedule(port_sim.Schedule(seed=0, workload="fifo", **FAULTS))
    assert not r.ok, "planted reversed-requeue bug went undetected"
    assert "requeue order violated" in r.violations[0]
    minimized, replays = port_sim.shrink(r.schedule)
    assert len(minimized.ops) <= 10, (len(minimized.ops), replays)
    assert not port_sim.run_schedule(minimized).ok
    monkeypatch.setattr(port_fifo, "SIM_BUG_REVERSED_REQUEUE", False)
    assert port_sim.run_schedule(minimized).ok


def test_explorer_summary_on_port(monkeypatch):
    """``sim.explorer.explore`` over the port: clean seeds pass, and with
    the planted fifo bug the failure comes back minimized."""
    from ra_tpu_torch.sim.explorer import explore

    clean = explore(["kv", "fifo"], [0, 1])
    assert clean["schedules"] == 4 and not clean["failures"]
    monkeypatch.setattr(port_fifo, "SIM_BUG_REVERSED_REQUEUE", True)
    buggy = explore(["fifo"], [0])
    assert len(buggy["failures"]) == 1
    assert "requeue order violated" in buggy["failures"][0]["violations"][0]


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_lease_drift_bound_bug_caught_and_shrunk_on_port(seed, monkeypatch):
    sched = schedule(port_sim, ("deposition", seed))
    assert port_sim.run_schedule(sched).ok
    monkeypatch.setattr(port_lease, "SIM_BUG_DRIFT_BOUND", True)
    r = port_sim.run_schedule(sched)
    assert not r.ok, "planted lease drift-bound bug went undetected"
    assert "stale consistent read" in r.violations[0], r.violations
    if seed != 1:
        return
    minimized, replays = port_sim.shrink(r.schedule)
    assert len(minimized.ops) <= 10, (len(minimized.ops), replays)
    assert not port_sim.run_schedule(minimized).ok
    monkeypatch.setattr(port_lease, "SIM_BUG_DRIFT_BOUND", False)
    assert port_sim.run_schedule(minimized).ok


def test_disk_budget_degrades_and_acked_writes_survive_on_port():
    r = port_sim.run_schedule(schedule(port_sim, ("disk", 600)))
    assert r.ok, r.violations
    kinds = {ln.split()[0] for ln in r.trace_text.splitlines()}
    assert {"disk_full", "disk_heal"} <= kinds
    back = port_sim.loads(port_sim.dumps(r.schedule))
    assert back.disk_budget_bytes == 600
    assert port_sim.run_schedule(back).trace_text == r.trace_text


def test_space_as_poison_bug_caught_and_shrunk_on_port(monkeypatch):
    monkeypatch.setattr(port_world, "SIM_BUG_SPACE_AS_POISON", True)
    r = port_sim.run_schedule(schedule(port_sim, ("disk", 600)))
    assert not r.ok, "planted space-as-poison bug went undetected"
    assert "acked write lost" in r.violations[0]
    assert "disk_poison" in r.trace_text
    minimized, replays = port_sim.shrink(r.schedule)
    assert len(minimized.ops) <= 8, (len(minimized.ops), replays)
    assert not port_sim.run_schedule(minimized).ok
    monkeypatch.setattr(port_world, "SIM_BUG_SPACE_AS_POISON", False)
    assert port_sim.run_schedule(minimized).ok


def test_planted_bugs_equal_on_both_packages(monkeypatch):
    """With the reversed-requeue bug planted in both packages, both
    report the same violations on the same schedule."""
    import ra_tpu.models.fifo as ref_fifo

    monkeypatch.setattr(ref_fifo, "SIM_BUG_REVERSED_REQUEUE", True)
    monkeypatch.setattr(port_fifo, "SIM_BUG_REVERSED_REQUEUE", True)
    a, sa = run_world(ref_world, schedule(ref_sim, ("fifo/faults", 0)))
    b, sb = run_world(port_world, schedule(port_sim, ("fifo/faults", 0)))
    assert a.violations
    assert_same_result(a, b, sa, sb)
