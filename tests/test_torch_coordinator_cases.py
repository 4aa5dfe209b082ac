"""Coordinator cases of ``tests/test_coordinator.py`` that the graft
entry's dryrun phases mirror, run on both packages: leader failover
(``test_coordinator_failover``), snapshot catch-up of a member that lost
everything (``test_batch_snapshot_catchup``) and the roll-back of a
deposed leader's uncommitted cluster change
(``test_leader_rolls_back_uncommitted_cluster_change``).

Each scenario runs on the JAX package and on the port (its coordinators
on the CPU, unsharded or over a mesh of 4 CPU slices), stepped
cooperatively by the test thread in one order, with the elections the
originals leave to the failure detector delivered as ``ElectionTimeout``
(so no run waits on a clock). The two records — every reply, the
machine states, roles and terms, and the group's device row — must be
equal.
"""

import time

import numpy as np
import pytest

from torch_batch import Pkg, clear_both

# GroupState fields of the group's row compared across the packages
ROW = ("current_term", "voted_for", "commit_index", "last_index",
       "last_term", "written_index", "snapshot_index", "snapshot_term",
       "role", "leader_slot", "self_slot", "match_index", "voting", "active")


class Cluster:
    """Coordinators of one package on one private node registry,
    stepped cooperatively; ``mesh`` > 0 cuts the port's state into that
    many CPU slices."""

    def __init__(self, pkg: Pkg, names, capacity: int, mesh: int):
        self.pkg, self.capacity, self.mesh = pkg, capacity, mesh
        self.reg = pkg.transport.NodeRegistry()
        self.coords = {n: self.make(n) for n in names}

    def make(self, name):
        kw = {}
        if self.pkg.torch:
            kw = {"mesh": ["cpu"] * self.mesh} if self.mesh else {"device": "cpu"}
        return self.pkg.coordinator.BatchCoordinator(
            name, capacity=self.capacity, num_peers=3, nodes=self.reg,
            idle_sleep_s=0, **kw)

    def pump(self, done, what, limit_s=60.0):
        """Step every live coordinator until ``done()``; the snapshot
        sender streams from a thread of its own, so an idle pass yields
        a millisecond to it."""
        deadline = time.monotonic() + limit_s
        while time.monotonic() < deadline:
            worked = False
            for c in self.coords.values():
                if c.running:
                    worked = c.step_once() or worked
            if done():
                return
            if not worked:
                time.sleep(0.001)
        raise AssertionError(f"timeout waiting for {what}")

    def command(self, node, group, data):
        """A command awaited to its reply."""
        fut = self.pkg.api.Future()
        self.coords[node].deliver((group, node),
                                  self.pkg.command(data, fut), None)
        self.pump(fut.done, f"reply to {data}")
        return fut.result(0)

    def elect(self, node, group):
        c = self.coords[node]
        c.deliver((group, node), self.pkg.election(), None)
        self.pump(lambda: c.by_name[group].role == self.pkg.C.R_LEADER,
                  f"{node} leads {group}")

    def record(self, group):
        out = {}
        for name, c in self.coords.items():
            if not c.running:
                continue
            g = c.by_name[group]
            st = (self.pkg.C.state_to_numpy(c.state) if self.pkg.torch else
                  {k: np.asarray(v) for k, v in c.state._asdict().items()})
            out[name] = ((g.machine_state, g.role, g.term, g.last_applied),
                         {f: st[f][g.gid].tolist() for f in ROW})
        return out

    def stop(self):
        for c in self.coords.values():
            c.stop()


def failover(pkg, mesh):
    cl = Cluster(pkg, [f"fc{i}" for i in range(3)], 64, mesh)
    try:
        ids = [("f1", f"fc{i}") for i in range(3)]
        for c in cl.coords.values():
            c.add_group("f1", "fgrp", ids, pkg.adder())
        cl.elect("fc0", "f1")
        first = cl.command("fc0", "f1", 5)
        # kill the leader coordinator; fc1 stands for election
        cl.coords["fc0"].stop()
        cl.elect("fc1", "f1")
        second = cl.command("fc1", "f1", 7)
        cl.pump(lambda: cl.coords["fc2"].by_name["f1"].machine_state == 12,
                "fc2 applies")
        return {"replies": (first, second), "rows": cl.record("f1")}
    finally:
        cl.stop()


def snapshot_catchup(pkg, mesh):
    cl = Cluster(pkg, [f"sc{i}" for i in range(3)], 64, mesh)
    ids = [("s1", f"sc{i}") for i in range(3)]
    try:
        for c in cl.coords.values():
            c.add_group("s1", "sgrp", ids, pkg.adder())
        cl.elect("sc0", "s1")
        replies = [cl.command("sc0", "s1", i) for i in range(1, 11)]
        assert replies[-1][1] == 55
        # compact the leader's log below a fresh member's needs: the
        # snapshot state is the machine state AT index 9 (noop at idx 1,
        # commands 1..8 at idx 2..9 -> 36)
        g0 = cl.coords["sc0"].by_name["s1"]
        g0.log.update_release_cursor(9, ids, 0, 36)
        assert g0.log.snapshot_index_term() is not None
        # sc2 loses everything: a fresh coordinator with an empty log
        cl.coords["sc2"].stop()
        cl.coords["sc2"] = cl.make("sc2")
        cl.coords["sc2"].add_group("s1", "sgrp", ids, pkg.adder())
        replies.append(cl.command("sc0", "s1", 5))
        g2 = cl.coords["sc2"].by_name["s1"]
        cl.pump(lambda: g2.machine_state == 60, "snapshot catch-up")
        assert g2.log.snapshot_index_term() is not None
        return {"replies": replies, "rows": cl.record("s1"),
                "snapshot": g2.log.snapshot_index_term()}
    finally:
        cl.stop()


def cluster_change_rollback(pkg, mesh):
    cl = Cluster(pkg, [f"rb{i}" for i in range(3)], 8, mesh)
    ids = [("rg", f"rb{i}") for i in range(3)]
    try:
        for c in cl.coords.values():
            c.add_group("rg", "rbc", ids, pkg.adder())
        cl.elect("rb0", "rg")
        replies = [cl.command("rb0", "rg", 1)]
        # isolate the leader, then ask it to drop rb2: the change
        # mutates its host member table at once but can never commit
        coords = list(cl.coords.values())
        for other in coords[1:]:
            coords[0].transport.block("rb0", other.name)
            other.transport.block(other.name, "rb0")
        g0 = cl.coords["rb0"].by_name["rg"]
        cl.coords["rb0"].deliver(
            ids[0], pkg.protocol.Command(kind=pkg.protocol.RA_LEAVE,
                                         data=ids[2]), None)
        cl.pump(lambda: g0.members[2] is None, "leave applied on host")
        assert g0.voter_status.get(2) is None
        # a new leader rises on the majority side over the orphaned
        # RA_LEAVE suffix
        cl.elect("rb1", "rg")
        for c in coords:
            c.transport.unblock_all()
        # its next append reaches rb0, which steps down, truncates and
        # must ROLL BACK its member table to the full 3-member config
        replies.append(cl.command("rb1", "rg", 2))
        cl.pump(lambda: g0.role != pkg.C.R_LEADER and g0.members[2] == ids[2]
                and g0.voter_status.get(2) == "voter"
                and g0.machine_state == 3, "rb0 rolled back and converged")
        return {"replies": replies, "rows": cl.record("rg"),
                "members": [tuple(m) for m in g0.members if m is not None]}
    finally:
        cl.stop()


@pytest.mark.parametrize("mesh", [0, 4], ids=["unsharded", "mesh4"])
@pytest.mark.parametrize("flow", [failover, snapshot_catchup,
                                  cluster_change_rollback])
def test_coordinator_case_on_both_packages(flow, mesh):
    got = {}
    for name in ("ra_tpu", "ra_tpu_torch"):
        clear_both()
        try:
            got[name] = flow(Pkg(name), mesh)
        finally:
            clear_both()
    assert got["ra_tpu_torch"] == got["ra_tpu"]
