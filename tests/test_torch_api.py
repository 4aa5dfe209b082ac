"""The client API over the actor backend, on both packages, on the CPU.

Each flow of the README quick start and of ``tests/test_runtime.py``
runs twice in one process, on ``ra_tpu`` and on ``ra_tpu_torch``, with
the same seeded commands: three in-proc nodes with real storage,
scheduler, timers and transport, driven only through ``<package>.api``.
The replies, the final machine states and the member lists must be
equal. Leader identities and timings are not compared: the actor
backend elects on wall-clock timers. The consensus-over-TCP test runs on
the port with the deadlines of the JAX package's passing TCP test.
"""

import socket
import threading
import time
from contextlib import contextmanager

import numpy as np
import pytest

from torch_batch import await_, on_both

NODE_KW = dict(election_timeout_s=0.1, tick_interval_s=0.1,
               detector_poll_s=0.05)


def seeded(seed):
    return np.random.default_rng(seed).integers(1, 1000, 40).tolist()


def adder(pkg):
    return pkg.machine.SimpleMachine(lambda c, s: s + c, 0)


@contextmanager
def nodes(pkg, tmp, names, system="t", **cfg_attrs):
    """Started nodes of one package (stopped on the way out)."""
    try:
        for n in names:
            cfg = pkg.SystemConfig(name=system, data_dir=str(tmp))
            for k, v in cfg_attrs.items():
                setattr(cfg, k, v)
            pkg.api.start_node(n, cfg, **NODE_KW)
        yield
    finally:
        for n in names:
            try:
                pkg.api.stop_node(n)
            except Exception:  # noqa: BLE001
                pass


def local_states(pkg, ids, want=None, timeout=15.0):
    """Every member's machine state, once they all agree (on ``want``
    when given)."""
    def agreed():
        vals = [pkg.api.local_query(sid, lambda s: s)[1] for sid in ids]
        ok = len(set(map(repr, vals))) == 1 and (want is None or vals[0] == want)
        return vals if ok else None

    return await_(agreed, timeout, "replicas to converge")


IDS = [("s1", "nA"), ("s2", "nB"), ("s3", "nC")]


@contextmanager
def adder_cluster(pkg, tmp, lease=False):
    with nodes(pkg, tmp, ("nA", "nB", "nC")):
        started, failed = pkg.api.start_cluster(
            "add", lambda: adder(pkg), IDS,
            extra_cfg={"lease": True} if lease else None)
        assert failed == []
        yield sorted(started)


# ---------------------------------------------------------------------------
# flows


def quick_start(pkg, tmp):
    """README "Quick start", verbatim apart from the data directory."""
    api = pkg.api
    with nodes(pkg, tmp, ("n1", "n2", "n3"), system="demo"):
        ids = [("a", "n1"), ("b", "n2"), ("c", "n3")]
        started, failed = api.start_cluster(
            "counter", lambda: pkg.machine.SimpleMachine(lambda c, s: s + c, 0), ids)
        reply, _leader = api.process_command(ids[0], 5)
        query = api.consistent_query(ids[0], lambda s: s)
        added = api.add_member(ids[0], ("d", "n1"))
        mem, _ = api.members(ids[0])
        return {"started": sorted(started), "failed": failed, "reply": reply,
                "query": query[:2], "added": added[0], "members": sorted(mem)}


def commands_and_queries(pkg, tmp, values, lease):
    api = pkg.api
    with adder_cluster(pkg, tmp, lease) as started:
        leader = api.wait_for_leader("add", timeout=15)
        replies = [api.process_command(IDS[0], values[0], timeout=15)[0],
                   api.process_command(IDS[1], values[1], timeout=15)[0]]
        total = values[0] + values[1]
        states = local_states(pkg, IDS, want=total)
        km = api.key_metrics(leader)
        mem, _ = api.members(IDS[2])
        return {
            "started": started, "replies": replies, "states": states,
            "leader_query": api.leader_query(IDS[0], lambda s: s * 2)[:2],
            "consistent": api.consistent_query(IDS[0], lambda s: s + 1)[:2],
            "consistent_via_follower": api.consistent_query(
                IDS[2], lambda s: s, timeout=15)[:2],
            "leader_state": km["state"], "members": sorted(mem),
        }


def pipeline_notifications(pkg, tmp, values):
    api = pkg.api
    with adder_cluster(pkg, tmp):
        got = []
        evt = threading.Event()

        def sink(_from_sid, corrs):
            got.extend(corrs)
            if len(got) >= 4:
                evt.set()

        leader = api.wait_for_leader("add", timeout=15)
        api.register_client(leader[1], "client1", sink)
        sent = [api.pipeline_command(leader, values[i], f"corr{i}", "client1")
                for i in range(4)]
        assert evt.wait(15), got
        return {"sent": sent, "notified": sorted(got),
                "states": local_states(pkg, IDS, want=sum(values[:4]))}


def add_and_remove_member(pkg, tmp, values):
    api = pkg.api
    with adder_cluster(pkg, tmp):
        api.process_command(IDS[0], values[0], timeout=15)
        cfg = pkg.SystemConfig(name="t", data_dir=str(tmp))
        api.start_node("nD", cfg, **NODE_KW)
        try:
            sid4 = ("s4", "nD")
            api.start_server(sid4, "add", adder(pkg), [sid4])
            added = api.add_member(IDS[0], sid4, timeout=15)
            caught_up = local_states(pkg, [sid4], want=values[0])
            with_4 = sorted(api.members(IDS[0])[0])
            removed = api.remove_member(IDS[0], sid4, timeout=15)
            without_4 = sorted(api.members(IDS[0])[0])
            reply = api.process_command(IDS[0], values[1], timeout=15)[0]
        finally:
            api.stop_node("nD")
        return {"added": added[0], "caught_up": caught_up, "with": with_4,
                "removed": removed[0], "without": without_4, "reply": reply,
                "states": local_states(pkg, IDS, want=values[0] + values[1])}


def transfer_leadership(pkg, tmp, values):
    api = pkg.api
    with adder_cluster(pkg, tmp):
        total = api.process_command(IDS[0], values[0], timeout=15)[0]
        local_states(pkg, IDS, want=total)
        # a transfer can lose to a wall-clock election under load: retry
        # until the chosen member leads
        outcomes, target = [], None
        for _attempt in range(5):
            leader = api.wait_for_leader("add", timeout=15)
            target = next(sid for sid in IDS if sid != leader)
            out = api.transfer_leadership(IDS[0], target, timeout=15)
            outcomes.append(out[0])
            try:
                await_(lambda: pkg.leaderboard.lookup_leader("add") == target,
                       timeout=5, what="the transfer")
                break
            except AssertionError:
                continue
        assert pkg.leaderboard.lookup_leader("add") == target, outcomes
        reply = api.process_command(target, values[1], timeout=15)[0]
        return {"transferred": outcomes[-1], "reply": reply,
                "states": local_states(pkg, IDS, want=reply)}


def failover(pkg, tmp, values):
    api = pkg.api
    with adder_cluster(pkg, tmp):
        first = api.process_command(IDS[0], values[0], timeout=15)[0]
        leader = api.wait_for_leader("add", timeout=15)
        api.stop_server(leader)

        def new_leader():
            cand = pkg.leaderboard.lookup_leader("add")
            ok = cand is not None and cand != leader and api._is_running(cand)
            return cand if ok else None

        cand = await_(new_leader, what="failover")
        reply = api.process_command(cand, values[1], timeout=15)[0]
        live = [sid for sid in IDS if sid != leader]
        return {"first": first, "reply": reply,
                "states": local_states(pkg, live, want=reply)}


def restart_catch_up(pkg, tmp, values):
    api = pkg.api
    with adder_cluster(pkg, tmp):
        replies = [api.process_command(IDS[0], v, timeout=15)[0]
                   for v in values[:5]]
        leader = api.wait_for_leader("add", timeout=15)
        follower = next(sid for sid in IDS if sid != leader)
        api.restart_server(follower)
        replies.append(api.process_command(IDS[0], values[5], timeout=15)[0])
        return {"replies": replies,
                "states": local_states(pkg, IDS, want=sum(values[:6]))}


def snapshot_catch_up(pkg, tmp, values):
    """A stopped follower falls behind a snapshot-compacted leader and
    catches up through the chunked snapshot transfer."""
    api = pkg.api

    class SnappyAdder(pkg.machine.Machine):
        def init(self, config):
            return 0

        def apply(self, meta, cmd, state):
            state += cmd
            effs = []
            if meta["index"] % 10 == 0:
                effs.append(pkg.fx.ReleaseCursor(meta["index"], state))
            return state, state, effs

    ids = [("z1", "sA"), ("z2", "sB"), ("z3", "sC")]
    with nodes(pkg, tmp, ("sA", "sB", "sC"), system="snap",
               min_snapshot_interval=5):
        api.start_cluster("snapc", SnappyAdder, ids)
        leader = api.wait_for_leader("snapc", timeout=15)
        lagging = next(sid for sid in ids if sid != leader)
        api.stop_server(lagging)
        leader = api.wait_for_leader("snapc", timeout=15)
        replies = [api.process_command(leader, v, timeout=15)[0]
                   for v in values[:30]]
        srv = pkg.registry().get(leader[1]).procs[leader[0]].server
        leader_snap = srv.log.snapshot_index_term() is not None
        api.restart_server(lagging)
        states = local_states(pkg, ids, want=sum(values[:30]))
        lag = pkg.registry().get(lagging[1]).procs[lagging[0]].server
        return {"replies": replies, "states": states,
                "leader_snapshot": leader_snap,
                "lagging_snapshot": lag.log.snapshot_index_term() is not None}


# ---------------------------------------------------------------------------
# tests


def test_readme_quick_start(tmp_path):
    out = on_both(quick_start, tmp_path)
    assert out["reply"] == 5 and out["query"] == ("ok", 5)
    assert out["added"] == "ok" and ("d", "n1") in out["members"]


@pytest.mark.parametrize("lease", [False, True], ids=["lease-off", "lease-on"])
def test_commands_and_queries(tmp_path, lease):
    out = on_both(commands_and_queries, tmp_path, values=seeded(2), lease=lease)
    assert out["leader_state"] == "leader"
    assert out["consistent"][1] == out["states"][0] + 1


def test_pipeline_command_notifications(tmp_path):
    out = on_both(pipeline_notifications, tmp_path, values=seeded(3))
    assert [c for c, _ in out["notified"]] == [f"corr{i}" for i in range(4)]


def test_add_and_remove_member(tmp_path):
    out = on_both(add_and_remove_member, tmp_path, values=seeded(4))
    assert ("s4", "nD") in out["with"] and ("s4", "nD") not in out["without"]


def test_transfer_leadership(tmp_path):
    out = on_both(transfer_leadership, tmp_path, values=seeded(5))
    assert out["transferred"] == "ok"


def test_failover_by_stopping_the_leader(tmp_path):
    on_both(failover, tmp_path, values=seeded(6))


def test_restart_and_catch_up(tmp_path):
    on_both(restart_catch_up, tmp_path, values=seeded(7))


def test_snapshot_catch_up_of_a_lagging_follower(tmp_path):
    out = on_both(snapshot_catch_up, tmp_path, values=seeded(8))
    assert out["leader_snapshot"] and out["lagging_snapshot"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("lease", [False, True], ids=["lease-off", "lease-on"])
def test_consensus_over_tcp(tmp_path, lease):
    """Three port nodes, each with its own TCP transport on a localhost
    port: every protocol message crosses a real socket."""
    from ra_tpu_torch import api, leaderboard
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.system import SystemConfig

    leaderboard.clear()
    names = [f"127.0.0.1:{_free_port()}" for _ in range(3)]
    try:
        for n in names:
            cfg = SystemConfig(name="tcp", data_dir=str(tmp_path))
            api.start_node(n, cfg, election_timeout_s=0.15,
                           tick_interval_s=0.1, detector_poll_s=0.05, tcp=True)
        ids = [(f"t{i}", names[i]) for i in range(3)]
        _started, failed = api.start_cluster(
            "tcpc", lambda: SimpleMachine(lambda c, s: s + c, 0), ids,
            timeout=15, extra_cfg={"lease": True} if lease else None,
        )
        assert failed == []
        reply, _leader = api.process_command(ids[0], 5, timeout=10)
        assert reply == 5
        reply, _ = api.process_command(ids[1], 7, timeout=10)
        assert reply == 12
        deadline = time.monotonic() + 8
        while time.monotonic() < deadline:
            vals = [api.local_query(sid, lambda s: s)[1] for sid in ids]
            if vals == [12, 12, 12]:
                break
            time.sleep(0.05)
        assert vals == [12, 12, 12]
        assert api.consistent_query(ids[0], lambda s: s, timeout=10)[1] == 12
    finally:
        for n in names:
            try:
                api.stop_node(n)
            except Exception:  # noqa: BLE001
                pass
        leaderboard.clear()
