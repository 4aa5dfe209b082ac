"""The models the harnesses drive, ``utils/range`` and ``dbg.replay_log``
on both packages, on the CPU.

``FifoMachine`` and ``SessionMachine`` fold the same seeded command
sequences (numpy ``default_rng`` seeds 2, 9, 17 and 40, the seeds of
``tests/test_fifo_machine.py`` and ``tests/test_session_machine.py``)
on ``ra_tpu`` and on ``ra_tpu_torch``: at every step the replies, the
effects and the states must be equal, field by field (states and
effects are dataclasses of each package, so they are compared decoded
into their class names and field values). Everything is exact: there
is no floating point in these machines.
"""

import numpy as np
import pytest
import torch

import ra_tpu.dbg as ref_dbg
import ra_tpu.models.fifo as ref_fifo
import ra_tpu.models.session as ref_session
import ra_tpu.utils.range as ref_range
import ra_tpu_torch.dbg as port_dbg
import ra_tpu_torch.models.fifo as port_fifo
import ra_tpu_torch.models.session as port_session
import ra_tpu_torch.utils.range as port_range

from torch_batch import decode, on_both

torch.set_num_threads(1)

SEEDS = (2, 9, 17, 40)


def _meta(i):
    return {"index": i, "term": 1, "machine_version": 0}


def _normalize(out):
    return out if len(out) == 3 else (out[0], out[1], [])


class Fold:
    """One machine of each package, folding the same commands."""

    def __init__(self, ref_cls, port_cls):
        self.machines = (ref_cls(), port_cls())
        self.states = [m.init({}) for m in self.machines]
        self.idx = 0
        self.steps = 0

    def apply(self, cmd):
        self.idx += 1
        outs = [_normalize(m.apply(_meta(self.idx), cmd, st))
                for m, st in zip(self.machines, self.states)]
        self.states = [o[0] for o in outs]
        ref, port = (tuple(decode(v) for v in o) for o in outs)
        assert port[1] == ref[1], f"replies differ after {cmd!r}"
        assert port[2] == ref[2], f"effects differ after {cmd!r}"
        assert port[0] == ref[0], f"states differ after {cmd!r}"
        self.steps += 1
        return outs[0]

    def state_enter(self, role):
        effs = [m.state_enter(role, st)
                for m, st in zip(self.machines, self.states)]
        assert decode(effs[1]) == decode(effs[0]), role


@pytest.mark.parametrize("seed", SEEDS)
def test_fifo_machine_equal_on_both_packages(seed):
    rng = np.random.default_rng(seed)
    fold = Fold(ref_fifo.FifoMachine, port_fifo.FifoMachine)
    cids = ["c0", "c1", "c2"]
    held = {}  # (cid, msg_id) delivered and not yet settled or returned

    def apply(cmd):
        _state, _reply, effs = fold.apply(cmd)
        for e in effs:
            msg = getattr(e, "msg", None)
            if isinstance(msg, tuple) and msg and msg[0] == "delivery":
                held[(e.to, msg[1])] = True
        if cmd[0] in ("settle", "return"):
            held.pop((cmd[1], cmd[2]), None)
        elif cmd[0] == "down":
            for k in [k for k in held if k[0] == cmd[1]]:
                held.pop(k)
        return effs

    for i in range(300):
        r = rng.random()
        cands = sorted(held)
        if r < 0.40:
            apply(("enqueue", f"p{seed}_{i}"))
        elif r < 0.55:
            apply(("checkout", cids[rng.integers(3)],
                   int((1, 2, 3, 5)[rng.integers(4)])))
        elif r < 0.75 and cands:
            apply(("settle", *cands[rng.integers(len(cands))]))
        elif r < 0.85 and cands:
            apply(("return", *cands[rng.integers(len(cands))]))
        elif r < 0.93:
            apply(("down", cids[rng.integers(3)], "crash"))
        else:
            apply(("settle", cids[rng.integers(3)], 10_000))
    # drain through a wide-credit consumer, as the reference test does
    for cid in cids:
        apply(("down", cid, "teardown"))
    apply(("checkout", "drain", 100_000))
    while any(k[0] == "drain" for k in held):
        for k in sorted(k for k in held if k[0] == "drain"):
            apply(("settle", *k))
    assert not fold.states[0].queue
    fold.state_enter("leader")
    assert fold.steps > 300


@pytest.mark.parametrize("seed", SEEDS)
def test_session_machine_equal_on_both_packages(seed):
    rng = np.random.default_rng(seed)
    fold = Fold(ref_session.SessionMachine, port_session.SessionMachine)
    sids = ["s0", "s1", "s2", "s3"]
    keys = ["lk0", "lk1"]
    for _ in range(400):
        r = rng.random()
        sid = sids[rng.integers(4)]
        key = keys[rng.integers(2)]
        if r < 0.22:
            fold.apply(("session_open", sid, 100 + int(rng.integers(900))))
        elif r < 0.34:
            fold.apply(("session_renew", sid))
        elif r < 0.42:
            fold.apply(("session_close", sid))
        elif r < 0.60:
            fold.apply(("lock_acquire", sid, key))
        elif r < 0.70:
            fold.apply(("lock_acquire", sid, key, "steal"))
        elif r < 0.82:
            fold.apply(("lock_release", sid, key))
        elif r < 0.90:
            fold.apply(("down", sid, "crash"))
        else:
            sess = fold.states[0].sessions.get(sid)
            if sess is not None:
                gen = sess.gen if rng.random() < 0.5 else max(sess.gen - 1, 0)
                fold.apply(("timeout", ("session", sid, gen)))
        if rng.random() < 0.05:
            fold.state_enter("leader")
    for sid in list(fold.states[0].sessions):
        fold.apply(("down", sid, "teardown"))
    assert not fold.states[0].locks
    assert fold.steps > 300


# ---------------------------------------------------------------------------
# utils/range: every function over a seeded grid of ranges


RANGES = [None] + [(lo, hi) for lo in range(0, 7) for hi in range(lo, 8)]


def _call(mod, fn, *args):
    try:
        return ("ok", getattr(mod, fn)(*args))
    except Exception as e:  # noqa: BLE001 — the raised type is compared
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("fn,arity", [
    ("new", "ii"), ("size", "r"), ("contains", "ri"), ("extend", "ri"),
    ("limit", "ri"), ("floor", "ri"), ("truncate", "ri"),
    ("overlap", "rr"), ("union", "rr"), ("subtract", "rr"),
])
def test_range_equal_on_both_packages(fn, arity):
    rng = np.random.default_rng(7)
    picks = {"r": lambda: RANGES[rng.integers(len(RANGES))],
             "i": lambda: int(rng.integers(-1, 10))}
    for _ in range(400):
        args = [picks[a]() for a in arity]
        assert _call(port_range, fn, *args) == _call(ref_range, fn, *args), \
            (fn, args)


def test_range_module_has_no_function_left_out():
    names = {n for n in dir(ref_range)
             if callable(getattr(ref_range, n)) and not n.startswith("_")
             and getattr(getattr(ref_range, n), "__module__", "") == ref_range.__name__}
    assert names == {"new", "size", "contains", "extend", "limit", "floor",
                     "truncate", "overlap", "union", "subtract"}
    assert all(hasattr(port_range, n) for n in names)


# ---------------------------------------------------------------------------
# dbg.replay_log: the flow of tests/test_models.py::test_dbg_replay_log


def _replay_flow(pkg, tmp):
    dbg = ref_dbg if pkg.name == "ra_tpu" else port_dbg
    api = pkg.api
    names = ("mA", "mB", "mC")
    ids = [("x1", "mA"), ("x2", "mB"), ("x3", "mC")]
    values = np.random.default_rng(3).integers(1, 100, 5).tolist()
    try:
        for n in names:
            api.start_node(n, pkg.SystemConfig(name="rp", data_dir=str(tmp)),
                           election_timeout_s=0.1, tick_interval_s=0.1,
                           detector_poll_s=0.05)
        api.start_cluster("rp", pkg.adder, ids)
        replies = [api.process_command(ids[0], v)[0] for v in values]
    finally:
        for n in names:
            try:
                api.stop_node(n)
            except Exception:  # noqa: BLE001
                pass
    seen = []
    state, applied = dbg.replay_log(
        str(tmp / "mA"), "rp_x1", pkg.adder(),
        on_entry=lambda i, cmd, st: seen.append((cmd, st)))
    partial = dbg.replay_log(str(tmp / "mA"), "rp_x1", pkg.adder(),
                             to_index=applied - 2)
    return {"replies": replies, "state": state, "applied": applied,
            "seen": seen, "partial": partial}


def test_dbg_replay_log_equal_on_both_packages(tmp_path):
    got = on_both(_replay_flow, tmp_path)
    assert got["state"] == got["replies"][-1] and len(got["seen"]) == 5
    assert got["partial"][1] == got["applied"] - 2
