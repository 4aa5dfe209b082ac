"""The started wave loops of the batch backend, three wall-clock
scenarios of the JAX package's tests, written once for any package with
the reference's module layout (``ra_tpu`` or ``ra_tpu_torch``) and any
device:

- ``flip_soak``: ``tests/test_active_set.py::
  test_auto_mode_flip_soak_crosses_saturation_boundary``, an "auto"
  cluster whose hot set crosses capacity/4 in both directions;
- ``idle_parking``: ``tests/test_command_plane.py::
  test_idle_step_loop_blocks_with_zero_spurious_wakeups``, an idle
  started coordinator parked on its wake event;
- ``threaded_pipeline``: ``tests/test_pipeline.py::
  test_threaded_pipelined_loop_commits_and_overlaps``, the step thread
  and the egress thread committing with staging overlap.

``tests/test_torch_started_loops.py`` runs them on both packages on the
CPU; ``chip_smoke.py`` (phase loop) runs them on the card at the
originals' shapes and the flip soak and the idle case at full width. So
this module imports no package statically: it takes a
``lane_cases.Lane`` (a package imported by name, and a device). It uses
the standard library only.

Each scenario keeps the original's parameters as its defaults and makes
the original's assertions. The coordinators run on the wall clock, so a
record holds what the original asserts on and what two packages must
end with alike (machine states); it also holds each coordinator's
``steps`` and ``sub_steps``, read after it stopped, and the wall time. A
``probe`` (a callable, e.g. the card's launch counts) is read around the
phases a caller asks about. Waits are on state, apart from the idle
case's settle probe and idle second, as in the original.
"""

import os
import time

# the original flip soak's hot sets, 5 commands per group in each burst
FLIP_BURSTS = (range(24), range(3), range(24), range(4, 7), range(24))
# the coordinator threads whose CPU time an idle second must not move
LOOP_THREADS = ("_step_thread", "_egress_thread", "_sender_thread")


def await_(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {what}")


def thread_cpu_s(thread) -> float:
    """A live thread's CPU time, utime + stime, from
    ``/proc/self/task/<native_id>/stat`` (clock ticks, so a resolution
    of 1/``SC_CLK_TCK`` s)."""
    with open(f"/proc/self/task/{thread.native_id}/stat") as f:
        # fields after the parenthesised name: state is field 3, utime
        # and stime are 14 and 15
        rest = f.read().rsplit(")", 1)[1].split()
    return (int(rest[11]) + int(rest[12])) / os.sysconf("SC_CLK_TCK")


def thread_cpu_ns(thread) -> int:
    """A live thread's CPU time in ns, from its POSIX CPU-time clock."""
    return time.clock_gettime_ns(time.pthread_getcpuclockid(thread.ident))


def loop_threads(coord) -> dict:
    """The coordinator's started loop threads, by attribute name."""
    return {n: getattr(coord, n) for n in LOOP_THREADS
            if getattr(coord, n) is not None}


def send(lane, coord, sids, bulk=False):
    """One ``await_consensus`` command (data 1) to each server id, each
    through ``coord.deliver`` as the originals do, or (``bulk``) all
    through one ``deliver_many``, as a driver of a full fleet sends: one
    ring slot, paced by the gate when the lane is full, where 10240
    single deliveries could fill the lane and be rejected as overload.
    Returns the futures."""
    futs = [lane.api.Future() for _ in sids]
    msgs = [(sid, lane.command(1, fut), None) for sid, fut in zip(sids, futs)]
    if bulk:
        coord.deliver_many(msgs)
    else:
        for m in msgs:
            coord.deliver(*m)
    return futs


def elect(lane, coord, sids, bulk=False):
    """An ``ElectionTimeout`` to each server id, one by one or in one
    ``deliver_many``."""
    msgs = [(sid, lane.protocol.ElectionTimeout(), None) for sid in sids]
    if bulk:
        coord.deliver_many(msgs)
    else:
        for m in msgs:
            coord.deliver(*m)


def replies_ok(futs, timeout):
    for fut in futs:
        tag, _val, _ = fut.result(timeout=timeout)
        assert tag == "ok"


def steps_of(coords) -> dict:
    return {"steps": [c.steps for c in coords],
            "sub_steps": [c.sub_steps for c in coords]}


def flip_soak(lane, prefix="fs", groups=24, capacity=32, per_burst=5,
              bursts=FLIP_BURSTS, election_timeout_s=0.05,
              detector_poll_s=0.02, logs=None, probe=None, bulk=False,
              reply_timeout_s=30.0, settle_timeout_s=30.0):
    """test_auto_mode_flip_soak_crosses_saturation_boundary: three
    started "auto" coordinators; every group elected on ``prefix``0,
    then bursts of ``per_burst`` commands to each group of a hot set
    wider than capacity >> 2, narrower, wider, narrower, wider, every
    reply ``ok``; the leader's machine states must reach the totals and
    both step paths must have run on the leader coordinator.

    ``logs(coords, node_names)``, where given, returns each node's list
    of logs by group (e.g. WAL-backed), which the caller closes after
    this returns. ``probe()`` is read before the first burst and after
    each. ``bulk`` sends the election triggers and each burst round
    through one ``deliver_many`` (see ``send``). The record also waits
    for all three replicas' states."""
    names = [f"{prefix}{i}" for i in range(3)]
    coords = [
        lane.coord(n, capacity=capacity, num_peers=3, active_set="auto",
                   election_timeout_s=election_timeout_s,
                   detector_poll_s=detector_poll_s)
        for n in names
    ]
    rec = {"bursts": [], "probes": []}
    t0 = time.perf_counter()
    try:
        for c in coords:
            c.start()
        members = lambda g: [(f"g{g}", n) for n in names]  # noqa: E731
        per_node = (logs(coords, names) if logs is not None
                    else [[None] * groups for _ in coords])
        for c, node_logs in zip(coords, per_node):
            c.add_groups([(f"g{g}", f"cl{g}", members(g), lane.adder(),
                           node_logs[g]) for g in range(groups)])
        t = time.perf_counter()
        elect(lane, coords[0], [(f"g{g}", names[0]) for g in range(groups)],
              bulk)
        by0 = coords[0].by_name
        await_(lambda: all(by0[f"g{g}"].role == lane.C.R_LEADER
                           for g in range(groups)),
               timeout=settle_timeout_s, what="leaders (flip soak)")
        rec["election_s"] = time.perf_counter() - t

        expect = [0] * groups
        rec["probes"].append(probe() if probe else None)
        for gids in bursts:
            t = time.perf_counter()
            futs = []
            for _ in range(per_burst):
                futs += send(lane, coords[0],
                             [(f"g{g}", names[0]) for g in gids], bulk)
            replies_ok(futs, reply_timeout_s)
            for g in gids:
                expect[g] += per_burst
            rec["bursts"].append({"groups": len(gids), "cmds": len(futs),
                                  "s": time.perf_counter() - t,
                                  **steps_of(coords)})
            rec["probes"].append(probe() if probe else None)
        await_(lambda: all(by0[f"g{g}"].machine_state == expect[g]
                           for g in range(groups)),
               timeout=settle_timeout_s,
               what="all applied after mode flips")
        # both step paths actually ran on the leader coordinator
        assert coords[0].sub_steps > 0, "sub path never engaged"
        assert coords[0].steps > coords[0].sub_steps, \
            "full path never engaged"
        await_(lambda: all(c.by_name[f"g{g}"].machine_state == expect[g]
                           for c in coords for g in range(groups)),
               timeout=settle_timeout_s, what="every replica applied")
        rec["states"] = [[c.by_name[f"g{g}"].machine_state
                          for g in range(groups)] for c in coords]
        rec["expect"] = expect
        rec["leader_counters"] = {
            k: coords[0].counters.get(k)
            for k in ("pipeline_steps", "pipeline_overlap_ns")}
    finally:
        # followers first: a running coordinator that sees the leaders'
        # node stop arms an election timer thread per group it follows
        for c in reversed(coords):
            c.stop()
    rec.update(steps_of(coords))
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def idle_parking(lane, prefix="zw", groups=1, capacity=4, cmds=3,
                 probe=None, reply_timeout_s=10.0, settle_timeout_s=30.0):
    """test_idle_step_loop_blocks_with_zero_spurious_wakeups: a started
    pipelined single-replica coordinator (tick 30 s, detector poll 5 s)
    that has gone idle must park on the wake event: once ``step_wakeups``
    is unchanged across 0.25 s, a full idle second leaves it unchanged,
    ``step_spurious_wakeups`` stays 0, and a fresh command wakes it.

    With one group (the original) the ``cmds`` commands go through
    ``api.process_command``; with more, the election triggers and each
    round of one command per group go through one ``deliver_many``,
    every reply ``ok``. The record holds the CPU time of the step,
    egress and sender threads over the idle second (``/proc`` ticks and
    ns) and ``probe()`` around it."""
    node = f"{prefix}0"
    c = lane.coord(node, capacity=capacity, num_peers=1,
                   tick_interval_s=30.0, detector_poll_s=5.0)
    sids = [(f"zg{g}", node) for g in range(groups)]
    rec = {}
    t0 = time.perf_counter()
    try:
        c.add_groups([(f"zg{g}", f"zwcl{g}", [sid], lane.adder())
                      for g, sid in enumerate(sids)])
        c.start()
        elect(lane, c, sids, bulk=groups > 1)
        by = c.by_name
        await_(lambda: all(by[f"zg{g}"].role == lane.C.R_LEADER
                           for g in range(groups)),
               timeout=settle_timeout_s, what="leader")
        for _ in range(cmds):
            if groups == 1:
                lane.api.process_command(sids[0], 1, timeout=reply_timeout_s)
            else:
                replies_ok(send(lane, c, sids, bulk=True), reply_timeout_s)
        assert all(by[f"zg{g}"].machine_state == cmds for g in range(groups))
        await_(lambda: c.counters.get("step_wakeups") > 0,
               what="the traffic woke the idle loop at least once")

        # let the pipeline tail settle (the last command's realisation
        # wake + durable-watermark pass can land just after the ack)
        def _settled():
            n = c.counters.get("step_wakeups")
            time.sleep(0.25)
            return n if c.counters.get("step_wakeups") == n else None

        before = await_(_settled, timeout=settle_timeout_s,
                        what="wakeups quiesce")
        threads = loop_threads(c)
        cpu0 = {n: (thread_cpu_s(t), thread_cpu_ns(t))
                for n, t in threads.items()}
        det0 = thread_cpu_ns(c._detector)
        p0 = probe() if probe else None
        # now fully idle: the loop must be parked, consuming nothing
        time.sleep(1.0)
        p1 = probe() if probe else None
        cpu1 = {n: (thread_cpu_s(t), thread_cpu_ns(t))
                for n, t in threads.items()}
        rec["detector_cpu_ns"] = thread_cpu_ns(c._detector) - det0
        after = c.counters.get("step_wakeups")
        assert after == before, "idle coordinator woke without work arriving"
        assert c.counters.get("step_spurious_wakeups") == 0
        rec["idle_probes"] = [p0, p1]
        rec["idle_cpu_s"] = {n: cpu1[n][0] - cpu0[n][0] for n in threads}
        rec["idle_cpu_ns"] = {n: cpu1[n][1] - cpu0[n][1] for n in threads}
        rec["wakeups"] = after
        # a fresh command wakes it exactly as the protocol promises
        lane.api.process_command(sids[0], 1, timeout=reply_timeout_s)
        assert by["zg0"].machine_state == cmds + 1
        rec["woken_wakeups"] = c.counters.get("step_wakeups") - after
        rec["spurious"] = c.counters.get("step_spurious_wakeups")
        rec["states"] = [by[f"zg{g}"].machine_state for g in range(groups)]
    finally:
        c.stop()
    rec.update(steps_of([c]))
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def threaded_pipeline(lane, prefix="tp", cmds=50):
    """test_threaded_pipelined_loop_commits_and_overlaps: three started
    pipelined coordinators (capacity 8) commit ``cmds`` commands through
    ``api.process_command``; every replica reaches the total, and the
    cluster records pipeline steps and staging overlap."""
    names = [f"{prefix}{i}" for i in range(3)]
    coords = [
        lane.coord(n, capacity=8, num_peers=3, pipeline=True,
                   election_timeout_s=0.15, detector_poll_s=0.05,
                   tick_interval_s=0.2)
        for n in names
    ]
    ids = [("tg", n) for n in names]
    rec = {}
    t0 = time.perf_counter()
    try:
        for c in coords:
            c.add_group("tg", "tpcl", ids, lane.adder())
            c.start()
        coords[0].deliver(ids[0], lane.protocol.ElectionTimeout(), None)
        await_(lambda: any(c.by_name["tg"].role == lane.C.R_LEADER
                           for c in coords), what="leader")
        leader = next(ids[i] for i, c in enumerate(coords)
                      if c.by_name["tg"].role == lane.C.R_LEADER)
        for _ in range(cmds):
            total, _ = lane.api.process_command(leader, 1, timeout=10)
        assert total == cmds
        await_(lambda: all(c.by_name["tg"].machine_state == cmds
                           for c in coords), what="replicas converge")
        rec["counters"] = {
            k: [c.counters.get(k) for c in coords]
            for k in ("pipeline_steps", "pipeline_overlap_ns")}
        assert sum(rec["counters"]["pipeline_steps"]) > 0
        assert sum(rec["counters"]["pipeline_overlap_ns"]) > 0
        rec["states"] = [c.by_name["tg"].machine_state for c in coords]
    finally:
        for c in coords:
            c.stop()
    rec.update(steps_of(coords))
    rec["wall_s"] = time.perf_counter() - t0
    return rec


SCENARIOS = {
    "flip_soak": flip_soak,
    "idle_parking": idle_parking,
    "threaded_pipeline": threaded_pipeline,
}
