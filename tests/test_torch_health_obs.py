"""The batch-backend cases of ``tests/test_health.py`` and
``tests/test_obs.py`` on both packages, the port's coordinators on the
CPU: trace spans from the step loop, nemesis stuck-then-quiet and
flapping classification, the live ``system_overview`` of a
3-coordinator cluster and the admission-reject event.

They run on started coordinators (each with its own step thread and
detector), as the originals do, so each package makes the original's
assertions; no timing is compared. The overview's shape (its keys, the
histogram names, each coordinator counter's name, kind and help) and the
counters the flow fixes (nothing shed, rejected or wedged) must be equal
across the packages.
"""

import importlib
import json
import time

import pytest

import torch_parity  # noqa: F401  (bounds torch's threads)
from torch_batch import PACKAGES, Pkg, await_, clear_both


class HPkg(Pkg):
    """A package with its health and obs modules."""

    def __init__(self, name):
        super().__init__(name)
        self.health = importlib.import_module(f"{name}.health")
        self.obs = importlib.import_module(f"{name}.obs")


def on_each(flow, *args):
    got = {}
    for name in PACKAGES:
        clear_both()
        try:
            got[name] = flow(HPkg(name), *args)
        except Exception as e:
            raise AssertionError(f"{flow.__name__} on {name}: {e!r}") from e
        finally:
            clear_both()
    return got


def started(pkg, names, **kw):
    coords = [pkg.coord(n, **kw) for n in names]
    for c in coords:
        c.start()
    return coords


def elect_until_leader(pkg, coord, sid, what, timeout=30.0, retry_s=1.0):
    """Deliver ``ElectionTimeout`` to ``sid`` on ``coord``, again every
    ``retry_s`` while it has not taken the lead, until it leads."""
    g = coord.by_name[sid[0]]
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        coord.deliver(sid, pkg.election(), None)
        try:
            await_(lambda: g.role == pkg.C.R_LEADER, retry_s, what)
            return
        except AssertionError:
            continue
    raise AssertionError(f"timeout waiting for {what}")


def close(coords):
    for c in coords:
        c.transport.unblock_all()
        c.stop()


# -- tests/test_health.py ---------------------------------------------------------


def trace_spans(pkg, tmp):
    """test_coordinator_step_loop_emits_trace_spans."""
    tb = pkg.obs.trace_buffer()
    tb.clear()
    tb.enable()
    coords = started(pkg, ["htr0"], capacity=4, num_peers=3)
    c = coords[0]
    try:
        sid = ("tg", "htr0")
        c.add_group("tg", "trcl", [sid], pkg.adder())
        c.deliver(sid, pkg.election(), None)
        await_(lambda: c.by_name["tg"].role == pkg.C.R_LEADER, what="leader")
        pkg.api.process_command(sid, 1)
        path = str(tmp / f"wave_{pkg.name}.json")
        assert pkg.api.dump_trace(path) > 0
        with open(path) as f:
            doc = json.load(f)
        assert pkg.obs.validate_chrome_trace(doc) == []
        spans = {e["name"] for e in doc["traceEvents"] if e["ph"] == "B"}
        want = {"ingress_drain", "device_step", "host_egress", "aer_fanout"}
        assert want <= spans, spans
        return want & spans
    finally:
        tb.disable()
        tb.clear()
        close(coords)


def state_of(pkg, node, group):
    sc = pkg.health.scanners().get(node)
    if sc is None:
        return None
    for r in sc.rows():
        if r["group"] == group:
            return r["state"]
    return None


def health_cluster(pkg):
    return started(pkg, [f"hn{i}" for i in range(3)], capacity=8,
                   num_peers=3, election_timeout_s=0.1,
                   detector_poll_s=0.05, tick_interval_s=0.1)


def nemesis_stuck(pkg):
    """test_batch_nemesis_stuck_group_detected_and_clears: an isolated
    leader with uncommittable commands classifies stuck, and quiet again
    once healed."""
    coords = health_cluster(pkg)
    try:
        members = [("sg", c.name) for c in coords]
        for c in coords:
            c.add_group("sg", "sgcl", members, pkg.adder())
        coords[0].deliver(members[0], pkg.election(), None)
        await_(lambda: coords[0].by_name["sg"].role == pkg.C.R_LEADER,
               what="hn0 leader")
        pkg.api.process_command(members[0], 1)
        for other in coords[1:]:
            coords[0].transport.block("hn0", other.name)
            other.transport.block(other.name, "hn0")
        mark = pkg.obs.flight_recorder().events(last=1)
        seq0 = mark[0]["seq"] if mark else -1
        for _ in range(4):
            coords[0].deliver(members[0], pkg.command(1, reply_mode="noreply"),
                              None)
        await_(lambda: state_of(pkg, "hn0", "sg") == "stuck", timeout=15,
               what="stuck classification on the isolated leader")
        assert any(
            e["kind"] == "health_transition" and e["group"] == "sg"
            and e["node"] == "hn0" and "->stuck" in str(e["detail"])
            and e["seq"] > seq0
            for e in pkg.obs.flight_recorder().events()
        )
        sc = pkg.health.scanners()["hn0"]
        scans = sc.counters.get("health_scans")
        fetches = sc.counters.get("health_fetches")
        assert scans > 0 and 0 <= fetches - scans <= 1, (scans, fetches)
        for c in coords:
            c.transport.unblock_all()
        await_(lambda: state_of(pkg, "hn0", "sg") == "quiet", timeout=30,
               what="stuck group cleared after heal")
        return "stuck", "quiet"
    finally:
        close(coords)


def nemesis_flapping(pkg):
    """test_batch_nemesis_flapping_group_detected: terms bumping scan
    after scan classify flapping, then decay back to quiet."""
    coords = health_cluster(pkg)
    try:
        members = [("fg", c.name) for c in coords]
        for c in coords:
            c.add_group("fg", "fgcl", members, pkg.adder())
        coords[0].deliver(members[0], pkg.election(), None)
        await_(lambda: any(c.by_name["fg"].role == pkg.C.R_LEADER
                           for c in coords), what="initial leader")
        deadline = time.monotonic() + 20
        k = 0
        while time.monotonic() < deadline:
            if state_of(pkg, "hn0", "fg") == "flapping":
                break
            coords[k % 3].deliver(members[k % 3], pkg.election(), None)
            k += 1
            time.sleep(0.08)  # the original's election cadence
        assert state_of(pkg, "hn0", "fg") == "flapping", (
            state_of(pkg, "hn0", "fg"), coords[0].by_name["fg"].term)
        assert any(
            e["kind"] == "health_transition" and e["group"] == "fg"
            and "->flapping" in str(e["detail"])
            for e in pkg.obs.flight_recorder().events()
        )
        await_(lambda: state_of(pkg, "hn0", "fg") == "quiet", timeout=30,
               what="flapping group settled")
        return "flapping", "quiet"
    finally:
        close(coords)


# -- tests/test_obs.py --------------------------------------------------------------


def overview(pkg):
    """test_system_overview_live_batch_cluster. Returns the overview's
    shape and the counters the flow fixes."""
    C, api, obs = pkg.C, pkg.api, pkg.obs
    coords = started(pkg, [f"ot{i}" for i in range(3)], capacity=8,
                     num_peers=3, election_timeout_s=0.1,
                     detector_poll_s=0.05)
    try:
        members = [("og", c.name) for c in coords]
        for c in coords:
            c.add_group("og", "ocl", members, pkg.adder())
        mark = next(iter(obs.flight_recorder().events(last=1)), None)
        seq0 = mark["seq"] if mark else -1
        coords[0].deliver(members[0], pkg.election(), None)
        await_(lambda: coords[0].by_name["og"].role == C.R_LEADER,
               what="ot0 leader")
        for k in range(4):
            out, _leader = api.process_command(members[0], 1, timeout=10.0)
            assert out == k + 1
        ov = api.system_overview("ot0")
        assert ov["overview"]["backend"] == "tpu_batch"
        wave = {k[2]: v for k, v in ov["histograms"].items()
                if isinstance(k, tuple) and k[0] == "wave" and k[1] == "ot0"}
        for ph in ("ingress_drain", "host_pack", "device_step",
                   "host_egress", "aer_fanout", "apply"):
            assert wave.get(ph, {}).get("count", 0) > 0, (ph, wave.keys())
            assert wave[ph]["sum_ms"] > 0, ph
        com = {k[2]: v for k, v in ov["histograms"].items()
               if isinstance(k, tuple) and k[0] == "commit" and k[1] == "ot0"}
        for st, _ in obs.COMMIT_STAGES:
            assert com.get(st, {}).get("count", 0) > 0, (st, com.keys())
        coord_rows = ov["counters"][("coordinator", "ot0")]
        assert all({"name", "kind", "help", "value"} <= set(r)
                   for r in coord_rows)
        assert ov["clusters"]["ocl"]["leader"] == ("og", "ot0")
        assert ov["clusters"]["ocl"]["commit_rate_scope"] == "node"
        # a pre-vote round that meets the live leader's AER ends at
        # follower, and nothing retries it: induce the election again
        # until ot1 leads
        elect_until_leader(pkg, coords[1], members[1],
                           "ot1 leader after induced election")
        evts = [e for e in obs.flight_recorder().events()
                if e["seq"] > seq0 and e["group"] in ("og",)]
        kinds = [e["kind"] for e in evts]
        assert "election" in kinds and "role_change" in kinds
        el = next(i for i, e in enumerate(evts)
                  if e["kind"] == "election" and e["node"] == "ot1")
        rc = next(i for i, e in enumerate(evts)
                  if e["kind"] == "role_change" and e["node"] == "ot1"
                  and str(e["detail"]).endswith("->leader"))
        assert el < rc
        seqs = [e["seq"] for e in evts]
        assert seqs == sorted(seqs)
        values = {r["name"]: r["value"] for r in coord_rows}
        return {
            "keys": sorted(ov),
            "overview": sorted(ov["overview"]),
            "histograms": sorted(k[2] for k in ov["histograms"]
                                 if isinstance(k, tuple) and k[1] == "ot0"),
            "counters": sorted((r["name"], r["kind"], r["help"])
                               for r in coord_rows),
            # no command was shed, rejected or wedged in this flow
            "fixed": {k: values[k] for k in (
                "commands_rejected", "commands_dropped_overload",
                "lane_wedges", "read_lease_served")},
            "cluster": sorted(ov["clusters"]["ocl"]),
        }
    finally:
        close(coords)


def admission_event(pkg):
    """test_admission_reject_records_event: an overloaded batch leader
    leaves an admission_reject trace."""
    coords = started(pkg, ["oadm"], capacity=4, num_peers=3,
                     max_command_backlog=2)
    c = coords[0]
    try:
        sid = ("ag", "oadm")
        c.add_group("ag", "agcl", [sid], pkg.adder())
        c.deliver(sid, pkg.election(), None)
        await_(lambda: c.by_name["ag"].role == pkg.C.R_LEADER, what="leader")
        cmds = [pkg.protocol.Command(kind=pkg.protocol.USR, data=1)
                for _ in range(64)]
        c.deliver_many([(sid, m, None) for m in cmds])
        await_(lambda: c.counters.get("commands_dropped_overload") > 0,
               what="overload drop")
        assert any(e["kind"] == "admission_reject" and e["node"] == "oadm"
                   for e in pkg.obs.flight_recorder().events())
        return "admission_reject"
    finally:
        close(coords)


def test_step_loop_emits_trace_spans_on_both_packages(tmp_path):
    got = on_each(trace_spans, tmp_path)
    assert got["ra_tpu_torch"] == got["ra_tpu"]


@pytest.mark.parametrize("flow", [nemesis_stuck, nemesis_flapping])
def test_nemesis_classification_on_both_packages(flow):
    got = on_each(flow)
    assert got["ra_tpu_torch"] == got["ra_tpu"]


def test_system_overview_live_batch_cluster_on_both_packages():
    got = on_each(overview)
    assert got["ra_tpu_torch"] == got["ra_tpu"]


def test_admission_reject_records_event_on_both_packages():
    got = on_each(admission_event)
    assert got["ra_tpu_torch"] == got["ra_tpu"]
