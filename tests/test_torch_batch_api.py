"""The port's batch coordinators behind the client API, against the JAX
package's, on the CPU.

Each case comes from the JAX package's batch-backend tests
(``test_batch_parity.py``, ``test_lease_runtime.py``,
``test_snapshot_streaming.py``, ``test_active_set.py``) and runs twice
in one process: with ``ra_tpu``'s ``BatchCoordinator``s and with
``ra_tpu_torch``'s on ``device="cpu"``, each package driven through its
own ``api``. The replies, machine states and the device ``GroupState``
read back at quiescence (``torch_batch.device_state``) must be equal.
"""

import shutil
import time

import pytest

from torch_batch import (LEADER_AGNOSTIC, await_, close_storage,
                         device_state, on_both, wal_log, wal_storage)


def mk_cluster(pkg, prefix, n=3, machine=None, groups=1, **kw):
    """``n`` started coordinators hosting ``groups`` groups, every group
    led from coordinator 0."""
    coords = {i: pkg.coord(f"{prefix}{i}", capacity=16, num_peers=3, **kw)
              for i in range(n)}
    for c in coords.values():
        c.start()
    members = lambda g: [(f"{prefix}g{g}", f"{prefix}{i}") for i in range(n)]  # noqa: E731
    for g in range(groups):
        for c in coords.values():
            c.add_group(f"{prefix}g{g}", f"{prefix}cl{g}", members(g),
                        (machine or pkg.adder)())
    for g in range(groups):
        coords[0].deliver((f"{prefix}g{g}", f"{prefix}0"), pkg.election(), None)
    # led, and the leader's noop committed: until then a membership
    # change is refused (cluster_change_not_permitted) on both packages
    await_(lambda: all(
        coords[0].by_name[f"{prefix}g{g}"].role == pkg.C.R_LEADER
        and coords[0].by_name[f"{prefix}g{g}"].cluster_change_permitted
        for g in range(groups)), what="election")
    return coords


def stop_all(coords):
    for c in coords.values():
        c.stop()


# ---------------------------------------------------------------------------
# machines of the cases, built on each package's Machine and effects


def snap_every(pkg, n=5):
    class SnapEveryN(pkg.machine.Machine):
        def init(self, config):
            return 0

        def apply(self, meta, cmd, state):
            state = state + cmd
            if meta["index"] % n == 0:
                return state, state, [pkg.fx.ReleaseCursor(meta["index"], state)]
            return state, state, []
    return SnapEveryN


def tick_machine(pkg):
    class TickMachine(pkg.machine.Machine):
        def init(self, config):
            return {"n": 0, "ticks": 0, "timeouts": 0}

        def apply(self, meta, cmd, state):
            if isinstance(cmd, tuple) and cmd and cmd[0] == "timeout":
                state = dict(state, timeouts=state["timeouts"] + 1)
                return state, None, []
            state = dict(state, n=state["n"] + cmd)
            return state, state["n"], [pkg.fx.Timer("t1", 30)]

        def tick(self, time_ms, state):
            state["ticks"] += 1
            return []
    return TickMachine


def chain_machine(pkg):
    class ChainMachine(pkg.machine.Machine):
        def init(self, config):
            return {"seen": ()}

        def apply(self, meta, cmd, state):
            state = dict(state, seen=state["seen"] + (cmd,))
            if isinstance(cmd, tuple) and cmd[0] == "chain":
                return state, "ok", [pkg.fx.Append(("chained", cmd[1]))]
            if isinstance(cmd, tuple) and cmd[0] == "try_chain":
                return state, "ok", [pkg.fx.TryAppend(("chained2", cmd[1]))]
            return state, "ok", []
    return ChainMachine


def blob_machine(pkg):
    class BlobMachine(pkg.machine.Machine):
        def init(self, config):
            return b""

        def apply(self, meta, cmd, state):
            state = state + bytes(range(256)) * (cmd // 256)
            effs = []
            if meta["index"] % 5 == 0:
                effs.append(pkg.fx.ReleaseCursor(meta["index"], state))
            return state, len(state), effs
    return BlobMachine


# ---------------------------------------------------------------------------
# cases from test_batch_parity.py


def release_cursor(pkg, tmp):
    coords = mk_cluster(pkg, "rc", machine=snap_every(pkg))
    try:
        sid = ("rcg0", "rc0")
        replies = [pkg.api.process_command(sid, 1, timeout=20)[0]
                   for _ in range(12)]
        g = coords[0].by_name["rcg0"]
        await_(lambda: g.log.snapshot_index_term() is not None,
               what="snapshot installed")
        snap = g.log.snapshot_index_term()
        dev_floor = int(pkg.field(coords[0], "snapshot_index")[g.gid])
        return {"replies": replies, "snapshot": snap[0] >= 5,
                "device_floor": dev_floor == snap[0],
                "compacted": g.log.fetch(1) is None,
                "device": device_state(pkg, coords.values(), ["rcg0"])}
    finally:
        stop_all(coords)


def membership(pkg, tmp):
    coords = mk_cluster(pkg, "mb")
    c3 = pkg.coord("mb3", capacity=16, num_peers=4)
    c3.start()
    try:
        sid = ("mbg0", "mb0")
        api = pkg.api
        removed = api.remove_member(sid, ("mbg0", "mb2"))
        await_(lambda: coords[0].by_name["mbg0"].members.count(None) == 1,
               what="member removed")
        after_remove = [m for m in coords[0].by_name["mbg0"].members if m]
        r1 = api.process_command(sid, 5, timeout=20)[0]
        c3.add_group("mbg0", "mbcl0",
                     [("mbg0", "mb0"), ("mbg0", "mb1"), ("mbg0", "mb3")],
                     pkg.adder())
        added = api.add_member(sid, ("mbg0", "mb3"), voter=False)
        g0 = coords[0].by_name["mbg0"]
        slot = g0.slot_of(("mbg0", "mb3"))
        await_(lambda: g0.voter_status.get(slot) == "voter", what="promotion")
        g3 = c3.by_name["mbg0"]
        await_(lambda: g3.machine_state == 5, what="new member caught up")
        r2 = api.process_command(sid, 2, timeout=20)[0]
        live = [coords[0], coords[1], c3]
        await_(lambda: all(c.by_name["mbg0"].machine_state == 7 for c in live),
               what="replicas converge")
        return {"removed": removed[0], "after_remove": after_remove,
                "replies": [r1, r2], "added": added[0], "slot": slot,
                "members": g0.members,
                "device": device_state(pkg, live, ["mbg0"])}
    finally:
        c3.stop()
        stop_all(coords)


def consistent_query(pkg, tmp, lease):
    pfx = "cql" if lease else "cq"
    coords = mk_cluster(pkg, pfx, lease=lease)
    try:
        sid = (f"{pfx}g0", f"{pfx}0")
        api = pkg.api
        reply = api.process_command(sid, 9, timeout=20)[0]
        at_leader = api.consistent_query(sid, lambda s: s, timeout=20)
        via_follower = api.consistent_query((f"{pfx}g0", f"{pfx}1"),
                                            lambda s: s, timeout=20)
        return {"reply": reply, "reads": [at_leader[:2], via_follower[:2]],
                "device": device_state(pkg, coords.values(), [f"{pfx}g0"])}
    finally:
        stop_all(coords)


def tick_and_timer(pkg, tmp):
    coords = mk_cluster(pkg, "tk", machine=tick_machine(pkg),
                        tick_interval_s=0.1)
    try:
        reply = pkg.api.process_command(("tkg0", "tk0"), 1, timeout=20)[0]
        g = coords[0].by_name["tkg0"]
        await_(lambda: g.machine_state["ticks"] >= 2, what="ticks")
        await_(lambda: g.machine_state["timeouts"] >= 1, timeout=20,
               what="timer effect")
        # the timer's command is applied everywhere: state at rest
        return {"reply": reply, "n": g.machine_state["n"],
                "device": device_state(pkg, coords.values(), ["tkg0"])}
    finally:
        stop_all(coords)


def wal_backed_log(pkg, tmp):
    names = ["wb0", "wb1", "wb2"]
    storage, refs, coords = {}, {}, {}
    for n in names:
        refs[n] = {}
        storage[n] = wal_storage(pkg, tmp, n, refs[n])
        coords[n] = refs[n]["c"] = pkg.coord(n, capacity=8, num_peers=3)
        coords[n].start()
    members = [("wbg0", n) for n in names]
    try:
        for n in names:
            coords[n].add_group("wbg0", "wbcl0", members, pkg.adder(),
                                log=wal_log(pkg, storage[n], "wbg0"))
        coords["wb0"].deliver(("wbg0", "wb0"), pkg.election(), None)
        await_(lambda: coords["wb0"].by_name["wbg0"].role == pkg.C.R_LEADER,
               what="election over WAL-backed logs")
        replies = [pkg.api.process_command(("wbg0", "wb0"), i, timeout=30)[0]
                   for i in range(1, 6)]
        for n in names:
            g = coords[n].by_name["wbg0"]
            await_(lambda g=g: g.log.last_written()[0] >= 6,
                   what=f"durability on {n}")
        # restart one follower coordinator from disk
        coords["wb2"].stop()
        close_storage([storage["wb2"]])
        refs["wb2"] = {}
        storage["wb2"] = wal_storage(pkg, tmp, "wb2", refs["wb2"])
        c2 = coords["wb2"] = refs["wb2"]["c"] = pkg.coord("wb2", capacity=8,
                                                          num_peers=3)
        c2.start()
        c2.add_group("wbg0", "wbcl0", members, pkg.adder(),
                     log=wal_log(pkg, storage["wb2"], "wbg0"))
        recovered = c2.by_name["wbg0"].log.last_index_term()[0] >= 6
        replies.append(pkg.api.process_command(("wbg0", "wb0"), 100, timeout=30)[0])
        await_(lambda: c2.by_name["wbg0"].machine_state == 115, timeout=30,
               what="restarted member re-applies")
        return {"replies": replies, "recovered": recovered,
                "device": device_state(pkg, coords.values(), ["wbg0"])}
    finally:
        stop_all(coords)
        close_storage(storage.values())


def aux_machine(pkg, tmp):
    coords = mk_cluster(pkg, "ax", machine=pkg.kv.KvMachine)
    try:
        api = pkg.api
        sid = ("axg0", "ax0")
        api.process_command(sid, ("put", "k1", {"v": 42}), timeout=20)
        api.process_command(sid, ("put", "k2", "second"), timeout=20)
        gets = [pkg.kv.kv_get(api, sid, k) for k in ("k1", "k2", "nope")]

        class AuxProbe(pkg.machine.SimpleMachine):
            def __init__(self):
                super().__init__(lambda c, s: s + c, 0)

            def handle_aux(self, role, kind, cmd, aux_state, ctx):
                if cmd == "probe":
                    return {"role": role, "term": ctx.current_term(),
                            "members": len(ctx.members()),
                            "applied": ctx.last_applied()}, aux_state
                return None, aux_state

        c0 = coords[0]
        c0.add_group("axp", "axpcl", [("axp", "ax0")], AuxProbe())
        c0.deliver(("axp", "ax0"), pkg.election(), None)
        await_(lambda: c0.by_name["axp"].role == pkg.C.R_LEADER,
               what="probe leader")
        api.process_command(("axp", "ax0"), 1, timeout=20)
        probe = api.aux_command(("axp", "ax0"), "probe", timeout=20)
        return {"gets": gets, "probe": probe[:2],
                "device": device_state(pkg, coords.values(), ["axg0", "axp"])}
    finally:
        stop_all(coords)


def append_effects(pkg, tmp):
    coords = mk_cluster(pkg, "ap", machine=chain_machine(pkg))
    try:
        sid = ("apg0", "ap0")
        replies = [pkg.api.process_command(sid, ("chain", 7), timeout=20)[0],
                   pkg.api.process_command(sid, ("try_chain", 9), timeout=20)[0]]
        want = (("chain", 7), ("chained", 7), ("try_chain", 9), ("chained2", 9))

        def seen():
            return [coords[k].by_name["apg0"].machine_state["seen"]
                    for k in range(3)]

        await_(lambda: all(sorted(map(repr, s)) == sorted(map(repr, want))
                           for s in seen()), what="effects applied everywhere")
        time.sleep(0.3)  # an effect applied twice would show by now
        # whether an effect's command lands before the client's next one
        # is a race: the replicas agree on one order, the packages on
        # the set
        orders = seen()
        return {"replies": replies, "agreed": len(set(orders)) == 1,
                "seen": sorted(map(repr, orders[0])),
                "device": device_state(pkg, coords.values(), ["apg0"])}
    finally:
        stop_all(coords)


def transfer_leadership(pkg, tmp):
    coords = mk_cluster(pkg, "tl")
    try:
        gname = "tlg0"
        old = coords[0].by_name[gname]
        fut = pkg.api.Future()
        coords[0].deliver((gname, "tl0"), pkg.command(1, fut), None)
        first = fut.result(30)[:2]
        fut = pkg.api.Future()
        coords[0].deliver((gname, "tl0"),
                          ("transfer_leadership", (gname, "nope"), fut), None)
        unknown = fut.result(10)
        target = (gname, "tl1")
        slot = old.slot_of(target)
        # the gate reads the device-confirmed match
        await_(lambda: int(pkg.field(coords[0], "match_index")[old.gid, slot])
               == old.log.last_index_term()[0], what="target caught up")
        fut = pkg.api.Future()
        coords[0].deliver((gname, "tl0"), ("transfer_leadership", target, fut),
                          None)
        moved = fut.result(10)
        await_(lambda: coords[1].by_name[gname].role == pkg.C.R_LEADER,
               what="target took over")
        await_(lambda: coords[0].by_name[gname].role != pkg.C.R_LEADER,
               what="old leader stepped down")
        reply = pkg.api.process_command(target, 10, timeout=30)[0]
        return {"first": first, "unknown": unknown, "moved": moved,
                "reply": reply,
                "device": device_state(pkg, coords.values(), [gname])}
    finally:
        stop_all(coords)


def api_reads(pkg, tmp):
    """Where the API reads a coordinator-hosted group: members,
    local_query, cluster_commit_rates (the coordinator-aggregate gauge),
    key_metrics and leader_query (unserved by both packages), and a
    transfer through ``api.transfer_leadership``."""
    coords = mk_cluster(pkg, "ar")
    try:
        api = pkg.api
        sid, follower = ("arg0", "ar0"), ("arg0", "ar1")
        reply = api.process_command(follower, 4, timeout=20)[0]
        mem, leader = api.members(follower)
        # neither package's coordinator serves these two: key_metrics'
        # state query needs a leader_id the GroupHost lacks (the handler
        # fails on the step thread), and leader_query is not a message
        # it handles; the caller times out on both packages alike
        unserved = []
        for call in (api.key_metrics, api.leader_query):
            try:
                call(sid, *([lambda s: s] if call is api.leader_query else []),
                     timeout=0.5)
                unserved.append(None)
            except TimeoutError as e:
                unserved.append(type(e).__name__)
        rates = api.cluster_commit_rates()["arcl0"]
        target = ("arg0", "ar2")
        g0 = coords[0].by_name["arg0"]
        slot = g0.slot_of(target)
        await_(lambda: int(pkg.field(coords[0], "match_index")[g0.gid, slot])
               == g0.log.last_index_term()[0], what="target caught up")
        moved = api.transfer_leadership(sid, target, timeout=10)
        await_(lambda: pkg.leaderboard.lookup_leader("arcl0") == target,
               what="the transfer")
        after = api.process_command(sid, 5, timeout=20)[0]
        return {
            "reply": reply, "members": mem, "leader": leader,
            "unserved": unserved,
            "local": await_(lambda: all(
                api.local_query(("arg0", f"ar{i}"), lambda s: s)[:2]
                == ("ok", after) for i in range(3)), what="replicas apply"),
            "rates": (rates["leader"], sorted(rates["members"]),
                      rates["commit_rate_scope"]),
            "moved": moved, "after": after,
            "device": device_state(pkg, coords.values(), ["arg0"]),
        }
    finally:
        stop_all(coords)


# ---------------------------------------------------------------------------
# test_lease_runtime.py, test_snapshot_streaming.py, test_active_set.py


def lease_reads(pkg, tmp):
    coords = mk_cluster(pkg, "bl", lease=True)
    try:
        api = pkg.api
        sid = ("blg0", "bl0")
        replies = [api.process_command(sid, i + 1, timeout=20)[0]
                   for i in range(5)]
        total = replies[-1]
        reads = set()
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            reads.add(api.consistent_query(sid, lambda s: s, timeout=20)[1])
            if coords[0].counters.get("read_lease_served") > 0:
                break
        served = coords[0].counters.get("read_lease_served") > 0

        def bounded_ok():
            try:
                out = api.local_query(("blg0", "bl1"), lambda s: s,
                                      max_staleness_s=30.0)
            except api.StaleReadError:
                return False
            return out[1] == total

        await_(bounded_ok, timeout=10, what="bounded follower read")
        with pytest.raises(api.StaleReadError):
            api.local_query(("blg0", "bl1"), lambda s: s, max_staleness_s=0.0)
        return {"replies": replies, "reads": sorted(reads),
                "lease_served": served,
                "device": device_state(pkg, coords.values(), ["blg0"])}
    finally:
        stop_all(coords)


class _Spy:
    """Counts streaming on both ends of a live snapshot transfer."""

    def __init__(self, pkg, monkeypatch):
        self.accept_sizes, self.sender_streamed = [], []
        accept = pkg.snapshot.ChunkAccept.accept_chunk
        run = pkg.proc.SnapshotSender._run
        spy = self

        def spy_accept(self_, data):
            spy.accept_sizes.append(len(data))
            return accept(self_, data)

        # the transfer's body, whichever thread runs it (the reference
        # starts a thread a transfer, the port runs it on a bounded pool)
        def spy_run(self_):
            spy.sender_streamed.append(self_.chunk_iter is not None)
            return run(self_)

        monkeypatch.setattr(pkg.snapshot.ChunkAccept, "accept_chunk", spy_accept)
        monkeypatch.setattr(pkg.proc.SnapshotSender, "_run", spy_run)


def streamed_snapshot(pkg, tmp, monkeypatch):
    spy = _Spy(pkg, monkeypatch)
    names = ["sb0", "sb1", "sb2"]
    storage, refs, coords = {}, {}, {}
    for n in names:
        refs[n] = {}
        storage[n] = wal_storage(pkg, tmp, n, refs[n])
        coords[n] = refs[n]["c"] = pkg.coord(n, capacity=8, num_peers=3)
        coords[n].start()
    members = [("sbg", n) for n in names]
    blob = blob_machine(pkg)
    try:
        for n in names:
            coords[n].add_group("sbg", "sbcl", members, blob(),
                                log=wal_log(pkg, storage[n], "sbg",
                                            min_snapshot_interval=1))
        coords["sb0"].deliver(("sbg", "sb0"), pkg.election(), None)
        await_(lambda: coords["sb0"].by_name["sbg"].role == pkg.C.R_LEADER,
               what="election")
        replies = [pkg.api.process_command(("sbg", "sb0"), 200_192, timeout=30)[0]
                   for _ in range(12)]
        g0 = coords["sb0"].by_name["sbg"]
        await_(lambda: g0.log.snapshot_index_term() is not None,
               what="leader snapshot")
        # wipe member sb2: a fresh coordinator over a fresh disk
        coords["sb2"].stop()
        close_storage([storage["sb2"]])
        shutil.rmtree(str(tmp / "sb2"), ignore_errors=True)
        refs["sb2"] = {}
        storage["sb2"] = wal_storage(pkg, tmp, "sb2", refs["sb2"])
        c2 = coords["sb2"] = refs["sb2"]["c"] = pkg.coord("sb2", capacity=8,
                                                          num_peers=3)
        c2.start()
        c2.add_group("sbg", "sbcl", members, blob(),
                     log=wal_log(pkg, storage["sb2"], "sbg",
                                 min_snapshot_interval=1))
        replies.append(pkg.api.process_command(("sbg", "sb0"), 512, timeout=30)[0])
        await_(lambda: len(c2.by_name["sbg"].machine_state) >= replies[-2],
               timeout=60, what="streamed snapshot catch-up")
        await_(lambda: len(set(len(c.by_name["sbg"].machine_state)
                               for c in coords.values())) == 1,
               what="replicas converge")
        return {"replies": replies, "streamed": any(spy.sender_streamed),
                "chunks": len(spy.accept_sizes) >= 2,
                "durable": c2.by_name["sbg"].log.snapshot_index_term() is not None,
                "state": len(c2.by_name["sbg"].machine_state),
                "device": device_state(pkg, coords.values(), ["sbg"],
                                       fields=LEADER_AGNOSTIC)}
    finally:
        stop_all(coords)
        close_storage(storage.values())


def step_mode_cluster(pkg, tmp, mode, groups=6, cmds=17):
    prefix = f"as_{mode[:2]}"
    coords = [pkg.coord(f"{prefix}{i}", capacity=64, num_peers=3,
                        active_set=mode, election_timeout_s=0.05,
                        detector_poll_s=0.02) for i in range(3)]
    names = [f"g{g}" for g in range(groups)]
    try:
        for c in coords:
            c.start()
        members = lambda g: [(f"g{g}", f"{prefix}{i}") for i in range(3)]  # noqa: E731
        for c in coords:
            c.add_groups([(f"g{g}", f"cl{g}", members(g), pkg.adder())
                          for g in range(groups)])
        for n in names:
            coords[0].deliver((n, f"{prefix}0"), pkg.election(), None)
        await_(lambda: all(coords[0].by_name[n].role == pkg.C.R_LEADER
                           for n in names), what=f"leaders ({mode})")
        futs = []
        for k in range(cmds):
            for n in names:
                fut = pkg.api.Future()
                coords[0].deliver((n, f"{prefix}0"), pkg.command(k + 1, fut), None)
                futs.append(fut)
        replies = [fut.result(timeout=30)[:2] for fut in futs]
        total = sum(range(1, cmds + 1))
        await_(lambda: all(c.by_name[n].machine_state == total
                           for c in coords for n in names), what="applied")
        before = device_state(pkg, coords, names)
        # failover: stop the leader's coordinator; a survivor takes over
        coords[0].stop()

        def leader_elsewhere():
            return next((c for c in coords[1:]
                         if c.by_name["g0"].role == pkg.C.R_LEADER), None)

        c = await_(leader_elsewhere, what=f"failover leader ({mode})")
        fut = pkg.api.Future()
        c.deliver(("g0", c.name), pkg.command(100, fut), None)
        after = fut.result(timeout=30)[:2]
        await_(lambda: all(s.by_name["g0"].machine_state == total + 100
                           for s in coords[1:]), what="survivors apply")
        return {"replies": replies, "after": after, "before": before,
                "survivors": device_state(pkg, coords[1:], ["g0"],
                                          fields=LEADER_AGNOSTIC)}
    finally:
        for c in coords:
            c.stop()


# ---------------------------------------------------------------------------
# tests


def test_release_cursor_snapshots_with_the_device_floor(tmp_path):
    out = on_both(release_cursor, tmp_path)
    assert out["snapshot"] and out["device_floor"] and out["compacted"]


def test_membership_add_remove_and_promote(tmp_path):
    out = on_both(membership, tmp_path)
    assert out["replies"] == [5, 7] and out["added"] == "ok"


@pytest.mark.parametrize("lease", [False, True], ids=["lease-off", "lease-on"])
def test_consistent_query(tmp_path, lease):
    out = on_both(consistent_query, tmp_path, lease=lease)
    assert out["reads"] == [("ok", 9), ("ok", 9)]


def test_machine_tick_and_timer(tmp_path):
    assert on_both(tick_and_timer, tmp_path)["reply"] == 1


def test_group_on_wal_backed_log(tmp_path):
    out = on_both(wal_backed_log, tmp_path)
    assert out["replies"] == [1, 3, 6, 10, 15, 115] and out["recovered"]


def test_aux_machine_and_kv_model(tmp_path):
    out = on_both(aux_machine, tmp_path)
    assert out["gets"] == [{"v": 42}, "second", None]
    assert out["probe"][1]["role"] == "leader"


def test_append_and_try_append_effects(tmp_path):
    assert on_both(append_effects, tmp_path)["replies"] == ["ok", "ok"]


def test_transfer_leadership(tmp_path):
    out = on_both(transfer_leadership, tmp_path)
    assert out["moved"] == ("ok", None) and out["reply"] == 11


def test_api_reads_and_transfers_a_coordinator_group(tmp_path):
    out = on_both(api_reads, tmp_path)
    assert out["reply"] == 4 and out["after"] == 9
    assert out["unserved"] == ["TimeoutError", "TimeoutError"]
    assert out["rates"][2] == "node" and out["moved"] == ("ok", None)


def test_lease_serves_reads_locally(tmp_path):
    out = on_both(lease_reads, tmp_path)
    assert out["lease_served"] and out["reads"] == [15]


def test_streams_large_snapshot(tmp_path, monkeypatch):
    out = on_both(streamed_snapshot, tmp_path, monkeypatch=monkeypatch)
    assert out["streamed"] and out["chunks"] and out["durable"]


@pytest.mark.parametrize("mode", ["always", "never", "auto"])
def test_cluster_parity_across_step_modes(tmp_path, mode):
    out = on_both(step_mode_cluster, tmp_path, mode=mode)
    assert out["after"] == ("ok", sum(range(1, 18)) + 100)
