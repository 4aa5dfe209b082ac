"""Coordinator cases of ``tests/test_coordinator.py`` run on both
packages: leader failover (``test_coordinator_failover``), snapshot
catch-up of a member that lost everything
(``test_batch_snapshot_catchup``), the roll-back of a deposed leader's
uncommitted cluster change
(``test_leader_rolls_back_uncommitted_cluster_change``), commits with one
dead replica (``test_commit_with_one_dead_replica``), the election storm
after the leader coordinator dies
(``test_election_storm_after_leader_coordinator_death``), the reload of
term and vote from the meta store
(``test_coordinator_reloads_term_and_vote_from_meta``) and the heartbeat
that adopts a term and steps a stale leader down
(``test_heartbeat_adopts_term_and_steps_down_stale_leader``).

Each scenario runs on the JAX package and on the port (its coordinators
on the CPU, unsharded or over a mesh of 4 CPU slices), stepped
cooperatively by the test thread in one order, with the elections the
originals leave to the failure detector delivered as ``ElectionTimeout``
(so no run waits on a clock). The two records — every reply, the
machine states, roles and terms, and the group's device row — must be
equal.

Batch/actor interop (``test_batch_group_interops_with_actor_backend``)
runs within one package at a time, on started nodes as the original
does: a batch member and two actor members of the same package in one
cluster; the replies and the states must be equal across the packages.
"""

import importlib
import time

import numpy as np
import pytest

from torch_batch import Pkg, await_, clear_both

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

    def make(self, name, **kw):
        if self.pkg.torch:
            kw.update({"mesh": ["cpu"] * self.mesh} if self.mesh
                      else {"device": "cpu"})
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

    def add_group(self, group, cluster, nodes):
        ids = [(group, n) for n in nodes]
        for c in self.coords.values():
            c.add_group(group, cluster, ids, self.pkg.adder())
        return ids

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


def failover(pkg, mesh, tmp):
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


def snapshot_catchup(pkg, mesh, tmp):
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


def cluster_change_rollback(pkg, mesh, tmp):
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


def dead_replica(pkg, mesh, tmp):
    """Quorum (2 of 3) keeps committing after a replica coordinator
    dies."""
    cl = Cluster(pkg, [f"dc{i}" for i in range(3)], 64, mesh)
    try:
        cl.add_group("d1", "dgrp", cl.coords)
        cl.elect("dc0", "d1")
        first = cl.command("dc0", "d1", 4)
        assert first[1] == 4
        cl.coords["dc2"].stop()
        second = cl.command("dc0", "d1", 6)
        assert second[0] == "ok" and second[1] == 10
        return {"replies": (first, second), "rows": cl.record("d1")}
    finally:
        cl.stop()


STORM_GROUPS = 24


def election_storm(pkg, mesh, tmp):
    """Every group loses its leader at once (the hosting coordinator
    dies) and all of them re-elect on the survivors, then take a
    command each."""
    cl = Cluster(pkg, [f"es{i}" for i in range(3)], 64, mesh)
    groups = [f"e{g}" for g in range(STORM_GROUPS)]
    try:
        for g, name in enumerate(groups):
            cl.add_group(name, f"egrp{g}", cl.coords)
        es0, es1, es2 = cl.coords.values()
        for name in groups:
            es0.deliver((name, "es0"), pkg.election(), None)
        leads = pkg.C.R_LEADER
        cl.pump(lambda: all(es0.by_name[n].role == leads for n in groups),
                "es0 leads all")
        es0.stop()
        for name in groups:
            es1.deliver((name, "es1"), pkg.election(), None)
        cl.pump(lambda: all(any(c.by_name[n].role == leads for c in (es1, es2))
                            for n in groups), "storm recovery")
        replies = []
        for name in groups:
            leader = next(c for c in (es1, es2) if c.by_name[name].role == leads)
            out = cl.command(leader.name, name, 1)
            assert out[0] == "ok"
            replies.append(out)
        return {"replies": replies,
                "rows": {n: cl.record(n) for n in groups}}
    finally:
        cl.stop()


def meta_reload(pkg, mesh, tmp):
    """A batch-backed member comes back from its meta store with its
    durable current_term and voted_for, on the host and in its device
    row."""
    FileMeta = importlib.import_module(f"{pkg.name}.log.meta_store").FileMeta
    meta = FileMeta(str(tmp / "meta"))
    cl = Cluster(pkg, [], 8, mesh)
    sid = ("gm", "mv1")
    try:
        c = cl.coords["mv1"] = cl.make("mv1", meta=meta)
        c.add_group("gm", "clm", [sid], pkg.adder())
        cl.elect("mv1", "gm")
        cl.pump(lambda: meta.fetch("clm_gm", "current_term", 0) >= 1,
                "term persisted")
        term = meta.fetch("clm_gm", "current_term", 0)
        assert tuple(meta.fetch("clm_gm", "voted_for")) == sid
        first = cl.record("gm")
        c.stop()
        # restart: the device row is seeded from meta, not term 0
        c2 = cl.coords["mv1"] = cl.make("mv1", meta=meta)
        c2.add_group("gm", "clm", [sid], pkg.adder())
        g = c2.by_name["gm"]
        assert g.term == term
        row = cl.record("gm")["mv1"][1]
        assert row["current_term"] == term
        assert row["voted_for"] == g.self_slot
        return {"term": term, "voted_for": tuple(meta.fetch("clm_gm",
                                                            "voted_for")),
                "before": first, "after": cl.record("gm")}
    finally:
        cl.stop()
        meta.close()


def heartbeat_step_down(pkg, mesh, tmp):
    """A follower seeing a higher-term HeartbeatRpc adopts the term
    before acking; a leader receiving a higher-term HeartbeatReply steps
    down at once."""
    P, C = pkg.protocol, pkg.C
    cl = Cluster(pkg, ["hb1"], 8, mesh)
    ids = [("hg", "hb1"), ("hg", "hbX"), ("hg", "hbY")]
    try:
        c = cl.coords["hb1"]
        c.add_group("hg", "hbc", ids, pkg.adder())
        g = c.by_name["hg"]
        c.deliver(ids[0], P.HeartbeatRpc(term=7, leader_id=ids[1],
                                         query_index=1), ids[1])
        cl.pump(lambda: g.term == 7
                and cl.record("hg")["hb1"][1]["current_term"] == 7,
                "term adopted from heartbeat, on the host and the device")
        assert g.leader_slot == 1
        follower = cl.record("hg")
        assert follower["hb1"][1]["voted_for"] == -1
        # the one reachable member cannot win: once it has entered
        # pre-vote, force the leader role on the host and feed the
        # higher-term reply to the leader handler
        c.deliver(ids[0], pkg.election(), None)
        cl.pump(lambda: g.role == C.R_PRE_VOTE, "pre-vote entered")
        g.role = C.R_LEADER
        c.deliver(ids[0], P.HeartbeatReply(term=11, query_index=1), ids[1])
        cl.pump(lambda: g.role == C.R_FOLLOWER and g.term == 11,
                "stale leader stepped down")
        return {"follower": follower, "deposed": cl.record("hg")}
    finally:
        cl.stop()


@pytest.mark.parametrize("mesh", [0, 4], ids=["unsharded", "mesh4"])
@pytest.mark.parametrize("flow", [failover, snapshot_catchup,
                                  cluster_change_rollback, dead_replica,
                                  election_storm, meta_reload,
                                  heartbeat_step_down])
def test_coordinator_case_on_both_packages(flow, mesh, tmp_path):
    got = {}
    for name in ("ra_tpu", "ra_tpu_torch"):
        clear_both()
        try:
            got[name] = flow(Pkg(name), mesh, tmp_path / name)
        finally:
            clear_both()
    assert got["ra_tpu_torch"] == got["ra_tpu"]


def interop(pkg, tmp):
    """One member on a started batch coordinator, two on actor nodes of
    the same package; then an actor member takes over and the batch
    member follows it."""
    api, C = pkg.api, pkg.C
    coord = pkg.coord("bx", capacity=64, num_peers=3)
    coord.start()
    nodes = ("ax1", "ax2")
    try:
        for n in nodes:
            api.start_node(n, pkg.SystemConfig(name="iop", data_dir=str(tmp)),
                           election_timeout_s=0.1, tick_interval_s=0.1,
                           detector_poll_s=0.05)
        ids = [("m1", "bx"), ("m2", "ax1"), ("m3", "ax2")]
        coord.add_group("m1", "iopc", ids, pkg.adder())
        for sid in ids[1:]:
            api.start_server(sid, "iopc", pkg.adder(), ids)
        coord.deliver(ids[0], pkg.election(), None)
        await_(lambda: coord.by_name["m1"].role == C.R_LEADER,
               what="batch leader")
        fut = api.Future()
        coord.deliver(ids[0], pkg.command(42, fut), None)
        out = fut.result(10)
        assert out[0] == "ok" and out[1] == 42
        for sid in ids[1:]:
            await_(lambda: api.local_query(sid, lambda s: s)[1] == 42,
                   what=f"actor follower {sid} applied")
        api.trigger_election(ids[1])
        await_(lambda: pkg.leaderboard.lookup_leader("iopc") == ids[1],
               what="actor takes over")
        r, _ = api.process_command(ids[1], 8)
        assert r == 50
        await_(lambda: coord.by_name["m1"].machine_state == 50,
               what="batch member follows actor leader")
        return {"first": out, "second": r,
                "states": [coord.by_name["m1"].machine_state]
                + [api.local_query(sid, lambda s: s)[1] for sid in ids[1:]]}
    finally:
        coord.stop()
        for n in nodes:
            try:
                api.stop_node(n)
            except Exception:  # noqa: BLE001
                pass


def test_batch_actor_interop_within_each_package(tmp_path):
    got = {}
    for name in ("ra_tpu", "ra_tpu_torch"):
        clear_both()
        try:
            got[name] = interop(Pkg(name), tmp_path / name)
        finally:
            clear_both()
    assert got["ra_tpu_torch"] == got["ra_tpu"]
