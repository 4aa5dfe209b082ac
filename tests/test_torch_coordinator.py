"""The slice as a whole on the CPU: two 3-coordinator WAL-backed
clusters side by side — ``ra_tpu``'s with the Pallas quorum backend and
``ra_tpu_torch``'s on ``device="cpu"`` — driven by one thread in the
same seeded order with the same seeded commands, must end in the same
place: host mirrors per group on every replica, and the device
``GroupState`` field by field."""

import inspect
import os
import time

import numpy as np
import pytest

import torch

from ra_tpu.log.log import Log as JLog
from ra_tpu.log.segment_writer import SegmentWriter as JSegmentWriter
from ra_tpu.log.tables import TableRegistry as JTableRegistry
from ra_tpu.log.wal import Wal as JWal
from ra_tpu.machine import SimpleMachine as JSimpleMachine
from ra_tpu.ops import consensus as J
from ra_tpu.protocol import Command as JCommand
from ra_tpu.protocol import ElectionTimeout as JElectionTimeout
from ra_tpu.protocol import USR
from ra_tpu.runtime import coordinator as JC

from ra_tpu_torch.log.log import Log as TLog
from ra_tpu_torch.log.segment_writer import SegmentWriter as TSegmentWriter
from ra_tpu_torch.log.tables import TableRegistry as TTableRegistry
from ra_tpu_torch.log.wal import Wal as TWal
from ra_tpu_torch.machine import SimpleMachine as TSimpleMachine
from ra_tpu_torch.ops import consensus as T
from ra_tpu_torch.protocol import Command as TCommand
from ra_tpu_torch.protocol import ElectionTimeout as TElectionTimeout
from ra_tpu_torch.runtime import coordinator as TC

import torch_parity  # noqa: F401  (bounds torch's threads)

G = 64


def _add(cmd, s):
    return s + cmd


class _Cluster:
    """Three WAL-backed coordinators of one package, stepped
    cooperatively (stage every coordinator, then finish every one)."""

    def __init__(self, tmp_path, tag, coord_mod, wal_cls, sw_cls, tables_cls,
                 log_cls, machine_cls, **kw):
        self.tag = tag
        self.names = [f"{tag}{i}" for i in range(3)]
        self.coords = [
            coord_mod.BatchCoordinator(n, capacity=G, num_peers=3,
                                       idle_sleep_s=0, **kw)
            for n in self.names
        ]
        self.storage = []
        for n, c in zip(self.names, self.coords):
            d = str(tmp_path / n)
            tables = tables_cls()
            sw = sw_cls(os.path.join(d, "data"), tables, c.wal_notify)
            wal = wal_cls(os.path.join(d, "wal"), tables, c.wal_notify,
                          segment_writer=sw)
            wal.notify_many = c.wal_notify_many
            self.storage.append((tables, wal, sw, d))
        for i, c in enumerate(self.coords):
            tables, wal, _sw, d = self.storage[i]
            c.add_groups([
                (f"g{g}", f"{tag}cl{g}",
                 [(f"g{g}", n) for n in self.names],
                 machine_cls(_add, 0),
                 log_cls(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, wal))
                for g in range(G)
            ])

    def step(self) -> bool:
        worked = False
        for c in self.coords:
            worked = c.step_stage() or worked
        for c in self.coords:
            worked = c.step_finish() or worked
        return worked

    def deliver(self, gids, msgs) -> None:
        c0 = self.coords[0]
        for g, m in zip(gids, msgs):
            c0.deliver((f"g{g}", self.names[0]), m, None)

    def stop(self) -> None:
        for c in self.coords:
            c.stop()
        for _t, wal, sw, _d in self.storage:
            wal.close()
            sw.close()


def _quiesce(clusters, done, timeout=60.0) -> None:
    """Step every cluster until ``done()`` holds and ten consecutive
    passes (with WAL fsyncs given time to land) find no work."""
    deadline = time.monotonic() + timeout
    idle = 0
    while time.monotonic() < deadline:
        worked = False
        for cl in clusters:
            worked = cl.step() or worked
        if worked:
            idle = 0
            continue
        idle += 1
        if idle >= 10 and done():
            return
        time.sleep(0.005)
    raise AssertionError("clusters did not quiesce")


@pytest.fixture
def clusters(tmp_path):
    J.configure(quorum_backend="pallas")
    built = []
    try:
        built.append(_Cluster(tmp_path / "jax", "jx", JC, JWal, JSegmentWriter,
                              JTableRegistry, JLog, JSimpleMachine))
        built.append(_Cluster(tmp_path / "torch", "tt", TC, TWal,
                              TSegmentWriter, TTableRegistry, TLog,
                              TSimpleMachine, device="cpu"))
        yield built
    finally:
        for cl in built:
            cl.stop()
        J.configure(quorum_backend="sort")


def test_wal_backed_clusters_match_the_reference(clusters):
    jx, tt = clusters
    rng = np.random.default_rng(2026)
    expect_sum = np.zeros(G, np.int64)
    expect_n = np.zeros(G, np.int64)
    jx.deliver(range(G), [JElectionTimeout() for _ in range(G)])
    tt.deliver(range(G), [TElectionTimeout() for _ in range(G)])

    def leaders():
        return all(
            cl.coords[0].by_name[f"g{g}"].role == J.R_LEADER
            for cl in clusters for g in range(G)
        )

    _quiesce(clusters, leaders)
    for _round in range(6):
        gids = rng.choice(G, size=int(rng.integers(8, G)), replace=False)
        data = rng.integers(1, 1000, len(gids))
        for g, d in zip(gids, data):
            expect_sum[g] += d
            expect_n[g] += 1
        jx.deliver(gids, [JCommand(kind=USR, data=int(d), reply_mode="noreply")
                          for d in data])
        tt.deliver(gids, [TCommand(kind=USR, data=int(d), reply_mode="noreply")
                          for d in data])
        # same number of interleaved passes per cluster, then on
        for _ in range(int(rng.integers(1, 4))):
            jx.step()
            tt.step()

    def applied():
        return all(
            (c._applied_np[:G] == expect_n + 1).all()  # + the election noop
            for cl in clusters for c in cl.coords
        )

    _quiesce(clusters, applied)

    for i in range(3):
        jc, tc = jx.coords[i], tt.coords[i]
        for g in range(G):
            a, b = jc.by_name[f"g{g}"], tc.by_name[f"g{g}"]
            where = (i, g)
            assert (a.role, a.term, a.leader_slot) == (b.role, b.term, b.leader_slot), where
            assert a.last_applied == b.last_applied == expect_n[g] + 1, where
            assert a.machine_state == b.machine_state == expect_sum[g], where
            assert a.pre_vote_token == b.pre_vote_token, where
        # every device field, exactly: at quiescence nothing in the
        # state depends on host timing — each follower has acked the
        # whole log (so the leaders' match/next rows sit at the tail),
        # every WAL fsync has landed (written == last) and every staged
        # log-tail scatter has been dispatched (staleness cleared)
        js = {k: np.asarray(v) for k, v in jc.state._asdict().items()}
        ts = T.state_to_numpy(tc.state)
        assert js.keys() == ts.keys()
        for k in js:
            np.testing.assert_array_equal(js[k], ts[k], err_msg=f"coord {i} {k}")
        assert tc.state.role.device.type == "cpu"


def test_coordinator_defines_every_method_of_the_reference():
    ref = {n for n, _ in inspect.getmembers(JC.BatchCoordinator)
           if not (n.startswith("__") and n.endswith("__"))}
    port = {n for n, _ in inspect.getmembers(TC.BatchCoordinator)
            if not (n.startswith("__") and n.endswith("__"))}
    assert ref - port == set()
    assert JC.GroupHost.__slots__ == TC.GroupHost.__slots__
    ref_params = inspect.signature(JC.BatchCoordinator.__init__).parameters
    port_params = inspect.signature(TC.BatchCoordinator.__init__).parameters
    assert set(ref_params) <= set(port_params)
    assert set(port_params) - set(ref_params) == {"device"}


def test_coordinator_device_rules():
    # a mesh replaces the device: naming both is refused
    with pytest.raises(ValueError, match="device or mesh"):
        TC.BatchCoordinator("tmesh", capacity=8, num_peers=3, device="cpu",
                            mesh=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.BatchCoordinator("tnocuda", capacity=8, num_peers=3)
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.BatchCoordinator("tnocudamesh", capacity=8, num_peers=3,
                                mesh=["cuda"] * 2)
