"""Quorum queues on the batch backend, on both packages, on the CPU:
the fifo machine over three coordinators with WAL-backed logs, a
consumer's failure with in-order requeue, release-cursor snapshots on
every replica and a cut-off follower's catch-up by snapshot install,
on ``ra_tpu`` and on ``ra_tpu_torch`` (its coordinators on
``device="cpu"``).

The scenarios live in ``tests/queue_cases.py``, which ``chip_smoke.py``
(phase queue) also runs on the card. The two packages' coordinators
are hand-stepped on a ``ManualClock`` and their records must be equal,
exactly (every field is an integer or a string): replies, delivery
sequences, fingerprints, snapshot indexes and terms, the device's
snapshot columns and each group's whole device row (the port writes a
pass's snapshot rows in one call a field, the reference one call a
group), and
the compacted logs' first indexes. Waits are on state.

Two cases hold where the port's coordinator differs by design, on both
packages: the catch-up's transfers run on a bounded pool (the reference
starts a thread a transfer), and the release-cursor snapshots are
written on writer threads, off the apply path (the reference writes
them inline); the records stay the reference's. The last case shows a
fault that phase queue found at 10240 queues on the card, in the
reference too, and that the port repairs: an ingress lane's length
read while the step thread drains it could be negative.
"""

import importlib
import threading

import numpy as np
import pytest
import torch

import lane_cases as L
import queue_cases as QC
from torch_batch import PACKAGES, clear_both

torch.set_num_threads(1)

QUEUES = 16
SEED = 14
# the fields of a record the machine fixes (queue_cases' module doc)
EQUAL = ("cmds", "replies", "deliveries", "cursor", "fingerprints",
         "snapshots", "first_index", "device_snap", "host_snap", "rows")
CATCH_UP = ("cut_last_index", "leader_first_index", "installs",
            "applied_at_install")


@pytest.fixture
def both_clear():
    clear_both()
    yield
    clear_both()


def on_both(flow, tmp_path, **kw):
    recs = {}
    for name in PACKAGES:
        clear_both()
        lane = L.Lane(name)
        recs[name] = flow(lane, str(tmp_path / name), QUEUES, seed=SEED,
                          clock=L.ManualClock(), **kw)
        QC.check(lane, recs[name], 0)
    return recs["ra_tpu"], recs["ra_tpu_torch"]


def test_queue_waves_equal_on_both_packages(tmp_path, both_clear):
    """16 queues x 3: every acknowledged enqueue delivered in order and
    settled once, the downed consumer's pair requeued to the next one
    first, a snapshot at the release cursor on every replica with the
    log compacted under it and the device's columns at the host's
    floor; the same record on both packages."""
    ref, port = on_both(QC.queue_waves, tmp_path)
    for key in EQUAL:
        assert port[key] == ref[key], key
    # cursor after noop, checkout, 4 enqueues, 2 settles, down,
    # checkout, 2 settles
    assert ref["cursor"] == [12] * QUEUES
    assert ref["snapshots"] == [[(12, 1)] * QUEUES] * 3
    assert ref["first_index"] == [[13] * QUEUES] * 3
    assert ref["host_snap"] == [[[12, 1]] * QUEUES] * 3
    assert ref["snapshot_writes"] == port["snapshot_writes"] == {
        f"qw{i}": QUEUES for i in range(3)}


def test_snapshot_catch_up_equal_on_both_packages(tmp_path, both_clear):
    """The same waves with node 2 cut off from before wave E until the
    leaders' snapshots: each of node 2's replicas reaches the leader's
    commit by one install, from below the snapshot index, and ends in
    the other replicas' state; the same record on both packages."""
    ref, port = on_both(QC.snapshot_catch_up, tmp_path)
    for key in EQUAL + CATCH_UP:
        assert port[key] == ref[key], key
    assert ref["installs"] == [1] * QUEUES
    # node 2 had applied the noop and the checkout before the cut; the
    # leader's log starts above the snapshot
    assert ref["cut_last_index"] == ref["applied_at_install"] == [2] * QUEUES
    assert ref["leader_first_index"] == [13] * QUEUES
    assert ref["snapshots"] == [[(12, 1)] * QUEUES] * 3
    # node 2 wrote no snapshot of its own: it installed the leader's
    assert ref["snapshot_writes"]["qc2"] == port["snapshot_writes"]["qc2"] == 0


@pytest.mark.parametrize("name", PACKAGES)
def test_queue_phase_on_started_loops(name, tmp_path, both_clear):
    """The card's phase queue at 16 queues x 3 on started coordinators:
    both runs on one cluster, node 2 cut off for the second, whose
    catch-up installs over the first run's snapshots; ``check`` holds
    for both runs."""
    lane = L.Lane(name)
    out = QC.queue_phase(lane, str(tmp_path), QUEUES, seed=SEED,
                         timeout_s=60.0)
    first, second = out["runs"]
    assert second["installs"] == [1] * QUEUES
    assert first["cursor"] == [12] * QUEUES
    assert second["cursor"] == [24] * QUEUES
    assert second["snapshots"] == [[(24, 1)] * QUEUES] * 3


class _Threads:
    """Records the threads a method runs on (``names``, in call order)
    and the most calls in it at once (``peak``)."""

    def __init__(self, monkeypatch, cls, name):
        self.names, self.peak, self._now = [], 0, 0
        lock = threading.Lock()
        fn = getattr(cls, name)
        spy = self

        def wrapped(*args, **kw):
            with lock:
                spy.names.append(threading.current_thread().name)
                spy._now += 1
                spy.peak = max(spy.peak, spy._now)
            try:
                return fn(*args, **kw)
            finally:
                with lock:
                    spy._now -= 1

        monkeypatch.setattr(cls, name, wrapped)


def test_catch_up_transfers_run_on_a_bounded_pool(tmp_path, both_clear,
                                                  monkeypatch):
    """The catch-up's 16 transfers: the reference streams each on a
    thread of its own, all at once; the port runs them on its
    coordinator's bounded pool (cut to 4 threads here), at most 4 at a
    time, and ends in the same record."""
    recs, spies = {}, {}
    for name in PACKAGES:
        clear_both()
        lane = L.Lane(name)
        mod = importlib.import_module(f"{name}.runtime.proc")
        spies[name] = _Threads(monkeypatch, mod.SnapshotSender, "_run")
        if name == "ra_tpu_torch":
            monkeypatch.setattr(lane.BatchCoordinator, "SNAPSHOT_SENDERS", 4)
        recs[name] = QC.snapshot_catch_up(lane, str(tmp_path / name), QUEUES,
                                          seed=SEED, clock=L.ManualClock())
        QC.check(lane, recs[name], 0)
    ref, port = recs["ra_tpu"], recs["ra_tpu_torch"]
    for key in EQUAL + CATCH_UP:
        assert port[key] == ref[key], key
    ref_t, port_t = spies["ra_tpu"], spies["ra_tpu_torch"]
    assert len(ref_t.names) == len(port_t.names) == QUEUES
    assert len(set(ref_t.names)) == QUEUES and ref_t.peak == QUEUES
    assert len(set(port_t.names)) <= 4 and port_t.peak <= 4
    assert all(n.startswith("ra-snap-send-qc0-") for n in port_t.names)


@pytest.mark.parametrize("name", PACKAGES)
def test_release_cursor_snapshots_leave_the_apply_path(name, tmp_path,
                                                       both_clear,
                                                       monkeypatch):
    """Where the 48 release-cursor snapshots of ``queue_waves`` are
    written: the reference writes each inline on the apply path (here
    the hand-stepping thread), the port on its coordinators' writer
    threads, so an apply pass never waits on a snapshot's file writes;
    the records are the same (``test_queue_waves_equal_on_both_packages``)."""
    lane = L.Lane(name)
    store = importlib.import_module(f"{name}.log.snapshot").SnapshotStore
    spy = _Threads(monkeypatch, store, "write")
    rec = QC.queue_waves(lane, str(tmp_path), QUEUES, seed=SEED,
                         clock=L.ManualClock())
    QC.check(lane, rec, 0)
    assert len(spy.names) == 3 * QUEUES
    here = threading.current_thread().name
    if name == "ra_tpu":
        assert set(spy.names) == {here}
    else:
        assert here not in spy.names
        assert {n.rsplit("-", 1)[0] for n in spy.names} <= {
            f"ra-snap-write-qw{i}" for i in range(3)}


class _DrainBetweenReads(np.ndarray):
    """A lane's index pair (head, tail) that runs ``hook`` once, right
    after the first of its reads: the consumer's drain landing between
    the two reads of a length."""

    def __getitem__(self, k):
        v = super().__getitem__(k)
        hook, self.hook = getattr(self, "hook", None), None
        if hook is not None:
            hook()
        return v


@pytest.mark.parametrize("name", PACKAGES)
def test_lane_length_while_the_step_thread_drains(name):
    """The egress thread asks whether a lane is pending (``len``) while
    the step thread drains it. A producer pushes and the drain pops
    between the length's two reads: the reference reads the tail first
    and its length goes negative, so ``len`` raises ValueError (what
    killed phase queue's egress thread on the card); the port reads the
    head first and its length stays at or above 0."""
    rings = importlib.import_module(f"{name}.rings")
    ring = rings.SpscRing(8)
    for i in range(3):
        assert ring.try_push(i)
    ring._idx = idx = ring._idx.view(_DrainBetweenReads)
    out = []

    def drain():
        for i in range(3):
            assert ring.try_push(i)
        assert ring.pop_many(out) == 6

    idx.hook = drain
    if name == "ra_tpu_torch":
        assert len(ring) >= 0
    else:
        with pytest.raises(ValueError, match="should return >= 0"):
            len(ring)
    assert out == [0, 1, 2, 0, 1, 2] and len(ring) == 0
