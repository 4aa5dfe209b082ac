"""Benchmark: multi-raft throughput of the port's batch coordinators.

    python -m ra_tpu_torch.bench [--device cuda:0] [--no-wal] [--reads]
                                 [--decisions] [--groups N] [--cmds N] ...

Headline (default): end-to-end DURABLE replicated commands/sec —
10,240 raft groups x 3 replicas spread over three batch coordinators in
this process, every replica on a real WAL-backed log (one shared WAL
per coordinator, batched fsync across all its groups — the amortized-
durability design the framework exists to prove, reference:
docs/internals/INTERNALS.md:16-19), no-op machine (the reference
ra_bench workload shape: src/ra_bench.erl), commands pipelined to every
group leader, measured until every group has applied everything.
Commit acks ride the written-event watermarks exactly as production
does. Alongside commands/sec the headline reports p50/p99 COMMIT
LATENCY (command delivery -> group apply at the leader), sampled over
a fixed subset of groups — the reference tracks the same gauge
(src/ra.hrl:424-425, src/ra_server.erl:3265-3277).

``--no-wal`` runs the same pipeline on auto-durable in-memory logs —
the host routing ceiling with storage out of the picture (secondary
artifact). ``--reads`` measures consistent-read throughput, lease on
against the lease-off control. ``--decisions`` measures the raw fused
decision-step throughput at 10k groups (the device ceiling, no host
routing).

The reference publishes no benchmark numbers (BASELINE.md: published={});
``vs_baseline`` compares against the reference harness's target load
rate of 100,000 ops/sec (src/ra_bench.erl:38), the only quantitative
throughput anchor it ships.

Output: ONE JSON line {metric, value, unit, vs_baseline, p50_ms, p99_ms,
...}.

This is the port of the JAX package's root-level ``bench.py``: the same
functions, flags, defaults, phases, state checks, histograms and JSON
keys, with these differences:

- No fallback hides the device. The JAX bench's backend probe, its
  dispatch-latency probe and its re-exec on the CPU are gone: where it
  retried on the CPU, this bench prints its message and exits 1.
- The device is explicit: ``--device`` and a ``device=`` argument on
  every bench function, passed to every ``BatchCoordinator``. ``None``
  means ``"cuda"`` and raises without a card; only an explicit
  ``"cpu"`` runs on the CPU. ``RA_BENCH_PLATFORM`` is gone.
- The metric text names the card as ``nvidia-smi`` gives its name and
  power limit (or ``cpu``), and a ``"device"`` key holds both.
- Added keys: ``"kernel_launches"`` (launches of each hand-written
  kernel during the run: ``step_full``, ``step_sub``, ``quorum_scan``)
  and, in the pipeline bench, ``"passes_completed"`` (a late pass that
  times out leaves the best completed pass as the value).
- ``bench_decisions`` runs its T steps as an eager loop of
  ``consensus_step_packed_scat`` calls over the packed mailbox (the
  step kernel of ``csrc/step.cu`` on CUDA tensors) instead of one
  jitted ``lax.scan`` of the torch-op step, with no CUDA graph; one
  warm run is timed with CUDA events after an untimed first run, and
  the card time per step of the step kernels' launches
  (``card_us_per_step``) and of the whole loop
  (``loop_card_us_per_step``) is reported beside it.
- The pipeline bench builds its WAL-backed logs on 8 threads before
  the coordinators take them (outside every timed window).
"""

import argparse
import json
import os
import subprocess
import sys
import time


def device_info(dev) -> dict:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them,
    or ``cpu``. On a card it raises when ``nvidia-smi`` gives no power
    limit: a card's numbers are not reported without it."""
    import torch

    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi gave no power limit: {e}") from e
    name, _, limit = out.partition("\n")[0].strip().rpartition(", ")
    if not name or not limit:
        raise RuntimeError(f"nvidia-smi gave no power limit: {out!r}")
    return {"name": name, "power_limit": limit}


def _device_text(info: dict) -> str:
    if info["power_limit"] is None:
        return info["name"]
    return f"{info['name']}, {info['power_limit']}"


def _launches() -> dict:
    """Launches of each hand-written kernel so far in this process."""
    from ra_tpu_torch.ops import quorum as Q
    from ra_tpu_torch.ops import step as S

    return {"step_full": S.LAUNCHES_FULL, "step_sub": S.LAUNCHES_SUB,
            "quorum_scan": Q.LAUNCHES}


def _launches_since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def wal_logs(nodes, groups: int, chunk: int = 512) -> list:
    """For each node, given as (tables, wal, dir), the WAL-backed ``Log``
    of groups g0..g{n-1} (uid ``g{g}``, under ``dir/data``), built by 8
    threads: a Log's directory fsyncs set the set-up's pace and release
    the GIL."""
    from concurrent.futures import ThreadPoolExecutor

    from ra_tpu_torch.log.log import Log

    def build(job):
        (tables, w, d), lo = job
        return [Log(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, w)
                for g in range(lo, min(lo + chunk, groups))]

    jobs = [(n, lo) for n in nodes for lo in range(0, groups, chunk)]
    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(build, jobs))
    per = len(range(0, groups, chunk))
    return [[log for part in parts[i * per:(i + 1) * per] for log in part]
            for i in range(len(nodes))]


def bench_pipeline(groups: int, cmds: int, wal: bool = True,
                   workdir: str = None, pipeline="on",
                   rings: str = "on", native: str = "auto",
                   device=None) -> dict:
    """Multi-raft pipeline bench. Modes (``pipeline``):

    - ``"on"`` (default): the pipelined wave loop in its cooperative
      stage/finish form — every round stages + DISPATCHES all three
      coordinators' fused device steps, then realises them, so each
      device step (and the WAL fsyncs behind the decoupled durable
      acks) overlaps the other coordinators' host staging. One driver
      thread: on a CPU host the wave is GIL-bound, and thread
      round-robin only adds handoff latency (measured: the threaded
      loop below).
    - ``"off"``: the sequential A/B control — step_once round-robin
      (the pre-pipelining methodology), ingress-routed durable acks.
    - ``"threaded"``: each coordinator's started two-stage loop (step
      thread + egress thread); the driver only delivers and polls.
      The production shape (kv_harness runs it) — recorded as the
      threaded-loop secondary artifact each perf round.

    ``device`` places the coordinators' state (``None``: ``"cuda"``,
    which raises without a card)."""
    if pipeline is True:
        pipeline = "on"
    elif pipeline is False:
        pipeline = "off"
    assert pipeline in ("on", "off", "threaded")
    # rings=off: the lock+deque control command plane (A/B is this one
    # flag; docs/INTERNALS.md §16)
    assert rings in ("on", "off")
    from ra_tpu_torch import native as _ra_native
    from ra_tpu_torch.models.bench_machine import BenchMachine
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.protocol import Command, ElectionTimeout, USR
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    dev = C.resolve_device(device)
    dev_info = device_info(dev)
    launches0 = _launches()
    coords = [
        BatchCoordinator(f"bench{i}", capacity=groups, num_peers=3,
                         idle_sleep_s=0, pipeline=pipeline != "off",
                         rings=rings == "on", native=native, device=dev)
        for i in range(3)
    ]
    storage = []
    if wal:
        # one shared WAL + segment writer per coordinator: every group's
        # appends ride the same file and the same batched fsync — the
        # reference's core durability amortization (one gen_batch_server
        # WAL per system, docs/internals/INTERNALS.md:16-19)
        import tempfile

        from ra_tpu_torch.log.segment_writer import SegmentWriter
        from ra_tpu_torch.log.tables import TableRegistry
        from ra_tpu_torch.log.wal import Wal

        base = workdir or tempfile.mkdtemp(prefix="ra_bench_wal_")
        for i, c in enumerate(coords):
            d = os.path.join(base, f"bench{i}")
            tables = TableRegistry()

            if pipeline != "off":
                # decoupled durable acks (docs/INTERNALS.md §15):
                # written events are handled on the WAL writer thread
                # itself — watermark advance, deferred AER ack out,
                # device scatter queued — instead of riding ingress to
                # the next step-loop pass
                notify = c.wal_notify
                notify_many = c.wal_notify_many
            else:
                # A/B control: the pre-pipelining ingress-routed events
                def notify(uid, evt, c=c, i=i):
                    c.deliver((uid, f"bench{i}"), ("log_event", evt), None)

                def notify_many(items, c=c, i=i):
                    c.deliver_many(
                        [((uid, f"bench{i}"), ("log_event", evt), None)
                         for uid, evt in items]
                    )
            sw = SegmentWriter(os.path.join(d, "data"), tables, notify)
            # big batches: fewer fsyncs AND fewer written-event rounds
            # per pipelined burst (one event per group per batch)
            w = Wal(os.path.join(d, "wal"), tables, notify,
                    segment_writer=sw, max_batch_size=65536)
            # bulk written-event channel: one lock round per fsync batch
            w.notify_many = notify_many
            storage.append((tables, w, sw, d, base))
    try:
        logs = (wal_logs([(t, w, d) for t, w, _sw, d, _b in storage], groups)
                if wal else None)
        members = lambda g: [(f"g{g}", f"bench{i}") for i in range(3)]  # noqa: E731
        for i, c in enumerate(coords):
            c.add_groups(
                [
                    (f"g{g}", f"cl{g}", members(g), BenchMachine(),
                     logs[i][g] if wal else None)
                    for g in range(groups)
                ]
            )
        coords[0].deliver_many(
            [((f"g{g}", "bench0"), ElectionTimeout(), None) for g in range(groups)]
        )

        if pipeline == "on":
            # cooperative PIPELINED stepping: each round stages +
            # dispatches EVERY coordinator's next device step, then
            # realises them all — each device step (and the WAL fsyncs
            # behind the decoupled acks) computes while the driver
            # stages the other coordinators' host work. One driver
            # thread, no GIL thrash (the threaded two-stage loop serves
            # the production path; kv_harness runs it pipelined).
            def step_all() -> bool:
                worked = False
                for c in coords:
                    worked = c.step_stage() or worked
                for c in coords:
                    worked = c.step_finish() or worked
                return worked
        elif pipeline == "threaded":
            for c in coords:
                c.start()

            def step_all() -> bool:
                time.sleep(0.0005)
                return False
        else:
            def step_all() -> bool:
                worked = False
                for c in coords:
                    worked = c.step_once() or worked
                return worked

        def settle() -> None:
            """Quiesce: cooperative modes step until nothing moves; the
            threaded mode waits for the apply floors to sit still."""
            if pipeline != "threaded":
                while step_all():
                    pass
                return
            last, last_t = None, time.time()
            while time.time() - last_t < 120:
                cur = tuple(
                    int(c._applied_np[:groups].sum()) for c in coords
                )
                if cur != last:
                    last, last_t = cur, time.time()
                elif time.time() - last_t >= 0.05:
                    return
                time.sleep(0.005)

        def all_leaders() -> bool:
            by = coords[0].by_name
            return all(by[f"g{g}"].role == C.R_LEADER for g in range(groups))

        deadline = time.time() + 600
        while time.time() < deadline and not all_leaders():
            if not step_all():
                time.sleep(0.001)
        if not all_leaders():
            print("bench error: leader election incomplete", file=sys.stderr)
            raise SystemExit(1)

        # settle all in-flight work (election noops) so the applied
        # floor below is exact
        settle()
        import numpy as np

        from ra_tpu_torch import obs

        # latency distributions live in log-bucketed histograms
        # (ra_tpu_torch.obs, ~3.1% bucket error) instead of ad-hoc sample
        # lists; the JSON percentiles below read straight off them
        h_unloaded = obs.histogram(
            ("bench", "unloaded_commit"),
            help="unloaded commit latency: delivery -> leader apply")
        h_loaded = obs.histogram(
            ("bench", "loaded_admitted"),
            help="loaded latency under client admission")
        h_unbounded = obs.histogram(
            ("bench", "loaded_unbounded"),
            help="pre-queued (unbounded pipeline) delivery -> apply")
        for _h in (h_unloaded, h_loaded, h_unbounded):
            _h.reset()  # bench may rerun in-process (obs_smoke)

        base = coords[0]._applied_np[:groups].copy()
        names = [f"g{g}" for g in range(groups)]
        # fixed sample of groups for the LOADED-latency distributions
        sample = np.arange(0, groups, max(1, groups // 256), dtype=np.int64)
        # unloaded-latency probe: 64-group waves rotating over the fleet
        # so every group is sampled (BENCH_r07's 256-wide fixed slice
        # both self-loaded the probe and collapsed the tail to 8
        # effective samples — a wave's groups commit together)
        lat_w = min(64, groups)
        lat_stride = max(1, groups // lat_w)
        lat_sample = np.arange(0, groups, lat_stride, dtype=np.int64)

        def run_wave(n_waves: int, loaded_hist=None) -> None:
            """Pre-queue ``n_waves`` full-fleet waves (the UNBOUNDED
            deep-pipelined shape — delivery->apply latency is dominated
            by queueing, recorded as unbounded_loaded_*)."""
            cmd = Command(kind=USR, data=1, reply_mode="noreply")
            wave_t: list = []
            base0 = base[sample].copy()
            # election noops (a re-election under host load, in any
            # pipeline mode) can advance the applied-index floor past
            # ``base`` before every user command of the wave has
            # applied, so the floor alone cannot terminate a pass: the
            # machine mirrors must agree too
            by = coords[0].by_name
            mstate0 = [by[n].machine_state for n in names]
            for w in range(n_waves):
                base.__iadd__(1)
                wave_t.append(time.perf_counter())
                # submit stamp on the FIRST wave only: commit-stage
                # sampling (obs.COMMIT_STAGES) wants a stamped command
                # under deep-pipeline load, but a distinct object per
                # wave would defeat the one-pickle-per-batch memo in
                # Log._bulk_insert when waves coalesce into one drain
                # (measured: 6x the encode_cmd calls, -45% throughput)
                coords[0].deliver_commands(
                    names,
                    cmd._replace(ts=time.monotonic_ns()) if w == 0 else cmd,
                )
            # per-sample pointer into wave_t: how many waves this sampled
            # group has fully applied (loaded-latency bookkeeping)
            done_w = np.zeros(len(sample), np.int64)
            while time.time() < deadline:
                step_all()
                if loaded_hist is not None:
                    now = time.perf_counter()
                    newly = np.minimum(
                        coords[0]._applied_np[sample] - base0, n_waves
                    )
                    for s in np.flatnonzero(newly > done_w):
                        for k in range(done_w[s], newly[s]):
                            loaded_hist.record_seconds(now - wave_t[k])
                        done_w[s] = newly[s]
                if all((c._applied_np[:groups] >= base).all() for c in coords):
                    if all(
                        by[names[g]].machine_state - mstate0[g] >= n_waves
                        for g in range(groups)
                    ):
                        return
            raise TimeoutError("wave did not complete")

        def run_wave_admitted(n_waves: int, window: int, hist) -> None:
            """Admission-paced load: the fleet's n_waves x groups
            commands are delivered as group SLICES (groups/16 lanes at a
            time), with at most ``window`` slices in flight past the
            LEADER apply floor — a client fleet respecting a bounded
            fleet-wide in-flight budget instead of pre-queueing
            everything (the r5 shape whose loaded p99 measured its own
            24.5 s queue). The slice width keeps the in-flight set
            inside the coordinator's active-set threshold (capacity/4),
            so the step cost scales with the admitted load — which is
            the whole point of admission. Latency = slice delivery ->
            leader apply. The floor reads leaders only: follower floors
            lag by a commit-sync round and would stall the window on
            the probe cadence whenever traffic pauses."""
            cmd = Command(kind=USR, data=1, reply_mode="noreply")
            start = base.copy()
            slice_w = max(1, groups // 16)
            n_sampled_cache: dict = {}
            slices = [
                np.arange(lo, min(lo + slice_w, groups))
                for lo in range(0, groups, slice_w)
            ]
            slice_names = [[names[g] for g in sl] for sl in slices]
            in_sample = set(int(g) for g in sample)
            queue = [(k, si) for k in range(n_waves)
                     for si in range(len(slices))]
            qi = 0
            from collections import deque as _deque
            pending = _deque()  # (slice_idx, t_delivered, target_waves)
            deliv = np.zeros(groups, np.int64)
            while time.time() < deadline:
                while qi < len(queue) and len(pending) < window:
                    _k, si = queue[qi]
                    qi += 1
                    deliv[slices[si]] += 1
                    pending.append(
                        (si, time.perf_counter(), int(deliv[slices[si][0]]))
                    )
                    coords[0].deliver_commands(
                        slice_names[si], cmd._replace(ts=time.monotonic_ns())
                    )
                step_all()
                while pending:
                    si, t0w, tgt = pending[0]
                    sl = slices[si]
                    if not (
                        coords[0]._applied_np[sl] - start[sl] >= tgt
                    ).all():
                        break
                    now = time.perf_counter()
                    n_s = n_sampled_cache.get(si)
                    if n_s is None:
                        n_s = n_sampled_cache[si] = sum(
                            1 for g in sl if int(g) in in_sample
                        )
                    if n_s:
                        hist.record_seconds(now - t0w, count=n_s)
                    pending.popleft()
                if qi >= len(queue) and not pending:
                    if all(
                        (c._applied_np[:groups] - start >= n_waves).all()
                        for c in coords
                    ):
                        base[:] = start + n_waves
                        return
            raise TimeoutError("admitted wave did not complete")

        def drain_storage(timeout_s: float = 120.0) -> None:
            """Wait for the WALs/segment writers to digest any backlog so
            the unloaded-latency phase measures commit latency, not
            competition with the bench's own earlier traffic."""
            end = time.time() + timeout_s
            while time.time() < end:
                settle()
                if all(
                    not w._queue and sw.wait_idle(timeout=0.0)
                    for _t, w, sw, _d, _b in storage
                ):
                    return
                time.sleep(0.01)

        # the cooperative spin loop shares ONE core with the WAL fsync
        # threads; the default 5 ms GIL switch interval would dominate
        # every commit round trip (each fsync handoff pays it). Restored
        # in the finally below — leaking 0.2 ms process-wide would tax
        # every later caller in this interpreter
        prev_switch_interval = sys.getswitchinterval()
        sys.setswitchinterval(0.0002)

        def latency_phase(n_waves: int):
            """p50/p99 commit latency: each wave issues ONE command to a
            ``lat_w``-group slice while the rest of the fleet sits
            idle; latency = delivery -> leader apply per sampled group.
            The slice ROTATES across waves so over the full phase every
            group of the fleet is sampled (BENCH_r07's p90==p99==p99.9
            collapse came from 8 waves over one fixed 256-group slice:
            a wave's groups commit together, so the effective tail
            sample was 8, not 2048 — and the wide slice self-loaded
            the probe). This is the unloaded commit round trip (append,
            replicate, fsync on three logs, quorum, apply) — the
            reference's commit-latency gauge measures the same thing
            per entry. It runs BEFORE the saturation passes (after a
            storage drain): measuring it after them would time the
            segment writers digesting the passes' backlog, not commit
            latency. The passes report their own LOADED latency
            distribution."""
            cmd = Command(kind=USR, data=1, reply_mode="noreply")
            stride = lat_stride
            by0 = coords[0].by_name
            for k in range(n_waves):
                rot = (lat_sample + (k % stride)) % groups
                rot_names = [f"g{g}" for g in rot]
                base[rot] += 1
                done = np.zeros(len(rot), bool)
                # completion must read the MACHINE mirrors, not the
                # applied-index floor — re-elections (live threads, or a
                # host stall in the cooperative modes) append noops that
                # advance the floor without advancing ``base``, so the
                # floor check reads complete one command early per churn
                # event and the wave's commands drift past the phase
                # boundary (they then land inside a throughput pass and
                # read as a duplicated command in its +cmds state check;
                # the same inflation is why run_wave checks mirrors)
                ms0 = [by0[n].machine_state for n in rot_names]
                t0 = time.perf_counter()
                coords[0].deliver_commands(
                    rot_names, cmd._replace(ts=time.monotonic_ns())
                )
                # measured loop: leader applies only (the latency
                # definition stops at leader apply; the fleet-wide
                # settle below is bookkeeping, not measurement)
                while time.time() < deadline:
                    if not step_all():
                        # idle: the round trip is waiting on a WAL
                        # fsync thread — hand it the core immediately
                        time.sleep(0)
                    now = time.perf_counter()
                    newly = ~done & np.array([
                        by0[rot_names[j]].machine_state - ms0[j] >= 1
                        for j in range(len(rot))
                    ])
                    if newly.any():
                        h_unloaded.record_seconds(now - t0, count=int(newly.sum()))
                        done |= newly
                        if done.all():
                            break
                else:
                    raise TimeoutError("latency wave did not complete")
                # settle followers (commit-sync round) before next wave
                while not all(
                    (c._applied_np[:groups] >= base).all() for c in coords
                ):
                    if time.time() >= deadline:
                        raise TimeoutError("latency wave did not settle")
                    if not step_all():
                        time.sleep(0)

        try:
            run_wave(1)  # warmup: first calls of the scatter/step shapes
            latency_phase(1)  # warm the active-set sub-batch shapes
        except TimeoutError:
            print("bench error: warmup wave incomplete", file=sys.stderr)
            raise SystemExit(1)

        # unloaded commit latency FIRST (quiesced storage, idle fleet)
        if wal:
            drain_storage()
        # discard the warmup latency_phase(1) samples (cold-path time);
        # the throughput warmup run_wave(1) records nothing here
        h_unloaded.reset()
        # enough rotating waves to sample EVERY group once at 10k
        # groups (160 x 64), floor 8 for small fleets
        lat_waves = max(8, min(160, lat_stride))
        try:
            latency_phase(lat_waves)
        except TimeoutError:
            print("bench error: latency phase incomplete", file=sys.stderr)
            raise SystemExit(1)
        p50, p90, p99, p999 = (
            v / 1e6 for v in h_unloaded.percentiles((50, 90, 99, 99.9))
        )

        # best-of-3 measured passes: the rate measures framework
        # capability, and a single pass on a shared host is at the
        # mercy of transient load spikes (every pass still verifies
        # every group's full end-to-end state). The throughput passes
        # stay deep-pipelined (the reference's own methodology:
        # PIPE_SIZE=500 in-flight per client, src/ra_bench.erl:18-19;
        # per-group depth stays inside the server admission window) —
        # their delivery->apply latency is queueing-dominated by
        # construction and recorded as unbounded_loaded_*. The LOADED
        # LATENCY number comes from a separate admission-paced pass
        # below (at most ADMIT_WINDOW waves in flight past the slowest
        # apply floor): the former pre-queued loaded p99 (24.5 s at r5)
        # measured the queue, not the system.
        # window depth trades latency for nothing in steady state (the
        # drip rate is window-independent; depth only sets how long a
        # slice queues behind its predecessors), so keep it at 1:
        # strictly sequential slices — still groups/16 concurrent
        # commands in flight across as many raft lanes
        ADMIT_WINDOW = 1
        total = groups * cmds

        def settle_mirrors() -> None:
            """Threaded mode: the applied-index floors the settle/wave
            checks compare against ``base`` are noop-inflatable — a
            mid-phase re-election (detector suspicion under GIL load)
            appends a noop that advances the floor without advancing
            ``base`` or the machine, so a floor-based settle can pass
            while a latency-phase command is still in flight. That
            straggler then applies AFTER the pass baseline is captured
            and reads as a duplicated command in the +cmds state check
            (seen as advance==cmds+1 across the fleet at 2048x24).
            Wait for the leader-side machine MIRRORS to go still before
            taking baselines; cooperative modes settle exactly via
            step_all and never need this."""
            if pipeline != "threaded":
                return
            by = coords[0].by_name
            last = None
            last_t = time.time()
            while time.time() - last_t < 15:
                cur = [by[f"g{g}"].machine_state for g in range(groups)]
                if cur != last:
                    last, last_t = cur, time.time()
                elif time.time() - last_t >= 0.25:
                    return
                time.sleep(0.01)

        best = 0.0
        passes_completed = 0
        for _pass in range(3):
            if os.environ.get("RA_BENCH_DEBUG"):
                _ms0 = sum(coords[0].by_name[f"g{g}"].machine_state
                           for g in range(groups))
                _t_s = time.time()
            settle_mirrors()
            if os.environ.get("RA_BENCH_DEBUG"):
                _ms1 = sum(coords[0].by_name[f"g{g}"].machine_state
                           for g in range(groups))
                print(f"DBG pass{_pass}: settle {time.time()-_t_s:.2f}s "
                      f"mirror_sum {_ms0}->{_ms1} "
                      f"floor_sum {int(coords[0]._applied_np[:groups].sum())} "
                      f"base_sum {int(base.sum())}", file=sys.stderr)
            # per-group baselines: the latency warmup advances only the
            # sampled groups, so states are not uniform across groups
            state0 = [
                coords[0].by_name[f"g{g}"].machine_state for g in range(groups)
            ]
            t0 = time.perf_counter()
            try:
                run_wave(cmds, loaded_hist=h_unbounded)
            except TimeoutError:
                if best > 0:
                    # a fully verified earlier pass already produced a
                    # number; report it rather than hard-failing on a
                    # late-pass load spike
                    print("bench: late pass timed out; reporting best "
                          "completed pass", file=sys.stderr)
                    break
                done = sum(
                    coords[0].by_name[f"g{g}"].machine_state - state0[g] == cmds
                    for g in range(groups)
                )
                print(
                    f"bench error: only {done}/{groups} groups completed",
                    file=sys.stderr,
                )
                raise SystemExit(1)
            dt = time.perf_counter() - t0
            bad = sum(
                coords[0].by_name[f"g{g}"].machine_state - state0[g] != cmds
                for g in range(groups)
            )
            if bad:
                adv = [
                    coords[0].by_name[f"g{g}"].machine_state - state0[g]
                    for g in range(groups)
                ]
                print(f"bench error: {bad}/{groups} groups wrong state "
                      f"(expected +{cmds}; advance min={min(adv)} "
                      f"max={max(adv)})",
                      file=sys.stderr)
                raise SystemExit(1)
            best = max(best, total / dt)
            passes_completed += 1

        # the admission-paced loaded pass: the client keeps at most
        # ADMIT_WINDOW waves in flight past the slowest group's apply
        # floor, so delivery->apply measures commit latency UNDER load
        # instead of time-in-queue. Its rate is reported too — the
        # throughput cost of bounding latency is part of the story.
        admitted_rate = None
        deadline = time.time() + 600  # fresh budget for this phase
        # steady-state latency needs rounds, not the full 96-wave
        # throughput workload: a quarter of the waves keeps the pass
        # inside its budget at 10k groups
        adm_waves = max(1, min(cmds, 24))
        t0 = time.perf_counter()
        try:
            run_wave_admitted(adm_waves, ADMIT_WINDOW, h_loaded)
            admitted_rate = round(
                groups * adm_waves / (time.perf_counter() - t0), 1)
        except TimeoutError:
            print("bench: admission-paced pass timed out; loaded_* "
                  "reported from partial data", file=sys.stderr)

        return {
            "metric": (
                f"durable replicated commands/sec ({groups} groups x 3 "
                f"replicas, {'shared-WAL fsync-gated logs' if wal else 'in-memory logs (routing ceiling)'}, "
                f"tpu_batch coordinators, "
                + {
                    "on": "pipelined wave loop (coop stage/finish) + "
                          "decoupled durable acks",
                    "threaded": "pipelined wave loop (started two-stage "
                                "threads) + decoupled durable acks",
                    "off": "sequential cooperative loop (control)",
                }[pipeline] + ", "
                + ("lock-free ingress rings" if rings == "on"
                   else "lock+deque control plane") + ", "
                f"device {_device_text(dev_info)}, "
                f"best of 3 passes; p50/p99 = unloaded commit latency "
                f"over {lat_waves} rotating {lat_w}-group waves "
                f"({lat_waves * lat_w} samples, every group sampled at "
                f"full fleet), "
                f"loaded_p50/p99 = delivery->apply with client admission "
                f"({ADMIT_WINDOW} slice of groups/16 lanes in flight), "
                f"unbounded_loaded_* = the pre-queued comparison shape)"
            ),
            "pipeline": pipeline,
            "rings": rings,
            # native hot-loop runtime (docs/INTERNALS.md §18): what was
            # requested, what actually loaded, and per-path activity —
            # the artifact is self-describing about which native entry
            # points the number was measured with
            "native": native,
            "native_entry_points": _ra_native.entry_points(),
            "native_counters": {
                k: int(sum(c.counters.get(k) for c in coords))
                for k in (
                    "native_classify_batches", "native_classify_items",
                    "native_pack_batches", "native_pack_msgs",
                    "native_egress_batches", "native_egress_frames",
                    "native_fallbacks",
                )
            },
            "ring_counters": {
                k: int(sum(c.counters.get(k) for c in coords))
                for k in (
                    "ingress_ring_msgs", "ingress_ring_drains",
                    "ingress_ring_full", "staging_passes",
                    "staging_prezeroed", "egress_thread_batches",
                    "egress_thread_msgs", "step_wakeups",
                    "step_spurious_wakeups", "pipeline_overlap_ns",
                )
            },
            "value": round(best, 1),
            "unit": "commands/sec",
            "vs_baseline": round(best / 100_000.0, 3),
            "latency_source": (
                "log-bucketed histograms (ra_tpu_torch.obs.LogHistogram, "
                "power-of-two buckets x 32 linear sub-buckets, <=3.1% "
                "quantile error)"
            ),
            "p50_ms": round(p50, 2),
            "p90_ms": round(p90, 2),
            "p99_ms": round(p99, 2),
            "p99_9_ms": round(p999, 2),
            "admission_inflight_slices": ADMIT_WINDOW,
            "admitted_cmds_per_sec": admitted_rate,
            "loaded_p50_ms": (
                round(h_loaded.percentile(50) / 1e6, 2) if h_loaded.n else None
            ),
            "loaded_p90_ms": (
                round(h_loaded.percentile(90) / 1e6, 2) if h_loaded.n else None
            ),
            "loaded_p99_ms": (
                round(h_loaded.percentile(99) / 1e6, 2) if h_loaded.n else None
            ),
            "loaded_p99_9_ms": (
                round(h_loaded.percentile(99.9) / 1e6, 2)
                if h_loaded.n else None
            ),
            "unbounded_loaded_p50_ms": (
                round(h_unbounded.percentile(50) / 1e6, 2)
                if h_unbounded.n else None
            ),
            "unbounded_loaded_p99_ms": (
                round(h_unbounded.percentile(99) / 1e6, 2)
                if h_unbounded.n else None
            ),
            "secondary_artifacts": (
                "record --no-wal, --decisions, --reads and one "
                "--pipeline threaded run beside every headline run, "
                "each in its own process, so the trajectory stays "
                "trackable"
            ),
            "device": dev_info,
            "kernel_launches": _launches_since(launches0),
            "passes_completed": passes_completed,
        }
    finally:
        if "prev_switch_interval" in locals():
            sys.setswitchinterval(prev_switch_interval)
        for c in coords:
            c.stop()
        for tables, w, sw, d, _b in storage:
            try:
                w.close()
                sw.close()
            except Exception:  # noqa: BLE001
                pass
        if storage and workdir is None:
            import shutil

            shutil.rmtree(storage[0][4], ignore_errors=True)


def bench_reads(groups: int, rounds: int, write_waves: int = 30,
                device=None) -> dict:
    """Consistent-read throughput, lease on vs the lease-off control
    (docs/INTERNALS.md §20). Same cluster shape as the pipeline
    headline (3 batch coordinators, cooperative stage/finish stepping,
    in-memory logs — reads never touch storage), same methodology for
    both arms; the ONLY difference is ``lease=True``:

    - lease on: within the quorum-earned window every consistent read
      serves locally at read_index = commit with ZERO quorum traffic
      (demand-driven renewal amortizes to one heartbeat round per
      window);
    - lease off: every consistent read pays a voter heartbeat quorum
      round (the Raft read-index protocol) — 2 heartbeats out + 2 acks
      back per read on a 3-replica group, all through the same step
      loop.

    Reads go in waves of one query per group; per-read latency is
    deliver -> reply. A write phase (one command per group per wave)
    runs first in BOTH arms so the read path has committed state and
    the write-throughput cost of lease bookkeeping (send-basis stamps,
    quorum-basis credit per AER ack) is part of the artifact — the
    claim is local reads for free, not local reads instead of writes.
    ``device`` places the coordinators' state (``None``: ``"cuda"``)."""
    from ra_tpu_torch import obs
    from ra_tpu_torch.models.bench_machine import BenchMachine
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.protocol import Command, ElectionTimeout, USR
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    dev = C.resolve_device(device)
    dev_info = device_info(dev)
    launches0 = _launches()

    def one_arm(tag: str, lease: bool) -> dict:
        coords = [
            BatchCoordinator(f"{tag}{i}", capacity=groups, num_peers=3,
                             idle_sleep_s=0, pipeline=True, lease=lease,
                             device=dev)
            for i in range(3)
        ]
        names = [f"g{g}" for g in range(groups)]
        try:
            members = lambda g: [(g, f"{tag}{i}") for i in range(3)]  # noqa: E731
            for c in coords:
                c.add_groups([(g, f"cl_{g}", members(g), BenchMachine(), None)
                              for g in names])
            coords[0].deliver_many(
                [((g, f"{tag}0"), ElectionTimeout(), None) for g in names]
            )

            def step_all() -> bool:
                worked = False
                for c in coords:
                    worked = c.step_stage() or worked
                for c in coords:
                    worked = c.step_finish() or worked
                return worked

            by = coords[0].by_name
            deadline = time.time() + 300
            while time.time() < deadline and not all(
                by[g].role == C.R_LEADER for g in names
            ):
                if not step_all():
                    time.sleep(0.001)
            if not all(by[g].role == C.R_LEADER for g in names):
                raise TimeoutError("read bench: election incomplete")
            while step_all():
                pass

            # write phase: lease bookkeeping rides the AER path, so the
            # write rate is the "within noise" control across arms —
            # best of 3 passes, same hedge as the headline bench (a
            # single short pass on a shared host measures load spikes
            # as often as the framework)
            cmd = Command(kind=USR, data=1, reply_mode="noreply")
            base = coords[0]._applied_np[:groups].copy()
            writes_per_sec = 0.0
            for _ in range(3):
                t0 = time.perf_counter()
                for _w in range(write_waves):
                    base += 1
                    coords[0].deliver_commands(names, cmd)
                    while not all(
                        (c._applied_np[:groups] >= base).all()
                        for c in coords
                    ):
                        if not step_all():
                            time.sleep(0)
                writes_per_sec = max(
                    writes_per_sec,
                    groups * write_waves / (time.perf_counter() - t0),
                )

            h = obs.histogram(
                (tag, "read_latency"),
                help="consistent read latency: deliver -> reply")
            h.reset()
            got = [0]
            bad = [0]

            def probe(s):
                return s

            def on_reply(out, _h=h):
                if out[0] != "ok":
                    bad[0] += 1
                got[0] += 1

            t0 = time.perf_counter()
            for r in range(rounds):
                n0 = got[0]
                tw = time.perf_counter()
                coords[0].deliver_many(
                    [((g, f"{tag}0"), ("consistent_query", probe, on_reply),
                      None) for g in names]
                )
                want = (r + 1) * groups
                while got[0] < want:
                    if time.time() > deadline:
                        raise TimeoutError("read bench: wave incomplete")
                    if not step_all():
                        time.sleep(0)
                    now = time.perf_counter()
                    if got[0] > n0:
                        h.record_seconds(now - tw, count=got[0] - n0)
                        n0 = got[0]
            dt = time.perf_counter() - t0
            if bad[0]:
                raise RuntimeError(f"read bench: {bad[0]} non-ok replies")
            ctr = lambda k: int(sum(c.counters.get(k) for c in coords))  # noqa: E731
            return {
                "lease": lease,
                "reads": got[0],
                "reads_per_sec": round(got[0] / dt, 1),
                "read_p50_ms": round(h.percentile(50) / 1e6, 3),
                "read_p90_ms": round(h.percentile(90) / 1e6, 3),
                "read_p99_ms": round(h.percentile(99) / 1e6, 3),
                "writes_per_sec": round(writes_per_sec, 1),
                "read_lease_served": ctr("read_lease_served"),
                "read_quorum_fallback": ctr("read_quorum_fallback"),
                "lease_expirations": ctr("read_lease_expirations"),
            }
        finally:
            for c in coords:
                c.stop()

    on = one_arm("rdl", True)
    off = one_arm("rdq", False)
    return {
        "metric": (
            f"linearizable consistent-read throughput ({groups} groups x 3 "
            f"replicas, tpu_batch coordinators, cooperative pipelined "
            f"stepping, {rounds} waves of one read per group; "
            f"lease arm serves at read_index = commit under a "
            f"quorum-earned clock-bound lease, control arm pays a voter "
            f"heartbeat quorum round per read; write phase "
            f"({write_waves} waves) is the bookkeeping-cost control; "
            f"p50/p99 = deliver -> reply; device {_device_text(dev_info)})"
        ),
        "value": on["reads_per_sec"],
        "unit": "reads/sec",
        "lease_on": on,
        "lease_off": off,
        "read_speedup": round(on["reads_per_sec"] / off["reads_per_sec"], 2),
        "write_ratio": round(on["writes_per_sec"] / off["writes_per_sec"], 3),
        "vs_baseline": round(on["reads_per_sec"] / 100_000.0, 3),
        "device": dev_info,
        "kernel_launches": _launches_since(launches0),
    }


def decisions_mailbox(groups: int, dev):
    """The decision bench's mailbox, packed as the main-path step takes
    it: (len(MBOX_FIELDS) + 6, G) int32, one AER per group at term 1
    carrying one entry of term 1, no host term override, and every
    scatter row padded with gid G (so the scatters drop)."""
    import torch

    from ra_tpu_torch.ops import consensus as C

    rows = C.MBOX_FIELDS + C.MBOX_SCAT_FIELDS
    packed = torch.zeros((len(rows), groups), dtype=torch.int32, device=dev)
    for name, val in (("msg_type", C.MSG_AER), ("term", 1),
                      ("num_entries", 1), ("entries_last_term", 1),
                      ("host_term_idx", -1), ("host_term_val", -1),
                      ("a_gid", groups), ("w_gid", groups)):
        packed[rows.index(name)] = val
    return packed


def decisions_loop(groups: int, steps: int, device=None, step=None):
    """``steps`` decision steps over ``groups`` fresh groups x 3 peers:
    before each step the mailbox's ``prev_idx``/``prev_term`` rows take
    the state's ``last_index``/``last_term``, so every AER extends the
    log. Returns (final state, per-step sums of the egress ``success``
    row as an int64 tensor of length ``steps``). ``step`` defaults to
    ``consensus_step_packed_scat`` (the step kernel on CUDA tensors,
    the plain torch-op step on CPU tensors)."""
    import torch

    from ra_tpu_torch.ops import consensus as C

    dev = C.resolve_device(device)
    step = step or C.consensus_step_packed_scat
    st = C.make_group_state(groups, 3, device=dev)
    packed = decisions_mailbox(groups, dev)
    p_idx = C.MBOX_FIELDS.index("prev_idx")
    if C.MBOX_FIELDS[p_idx + 1] != "prev_term":
        raise ValueError("prev_term must follow prev_idx in MBOX_FIELDS")
    ok_row = C.EGRESS_FIELDS.index("success")
    sums = []
    for _ in range(steps):
        # a fresh mailbox each step: the step may keep views of its rows
        mb = torch.cat([packed[:p_idx], st.last_index[None],
                        st.last_term[None], packed[p_idx + 2:]])
        st, eg = step(st, mb)
        sums.append(eg[ok_row].sum())
    return st, torch.stack(sums)


# the profiler's names of the launches of one step of csrc/step.cu: its
# one cooperative kernel (no other launch of the decision loop has it)
STEP_CU_LAUNCHES = ("step_kernel",)


def bench_decisions(groups: int, steps: int, device=None) -> dict:
    """Raw decision-step throughput: ``steps`` steps over ``groups``
    groups x 3 replicas, each group taking one AER per step. One first
    run goes untimed; a second is timed (CUDA events on a card, the
    host clock on the CPU); on a card a third runs under
    ``torch.profiler`` for the card time per step: ``card_us_per_step``
    of the step's own launches (``STEP_CU_LAUNCHES``), and
    ``loop_card_us_per_step`` of every launch of the loop, the mailbox
    copy, the success sums and the state's set-up included.
    ``kernel_launches`` counts the launches of all the runs."""
    import torch

    from ra_tpu_torch.ops import consensus as C

    dev = C.resolve_device(device)
    dev_info = device_info(dev)
    G, T = groups, steps
    launches0 = _launches()
    st, sums = decisions_loop(G, T, dev)  # first run, untimed
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        st, sums = decisions_loop(G, T, dev)
        b.record()
        b.synchronize()
        dt = a.elapsed_time(b) / 1e3
        timing = ("one warm eager run of T step calls (no CUDA graph), "
                  "timed by CUDA events after an untimed first run")
    else:
        t0 = time.perf_counter()
        st, sums = decisions_loop(G, T, dev)
        dt = time.perf_counter() - t0
        timing = ("one warm eager run of T step calls, timed by the host "
                  "clock after an untimed first run")
    card_us = loop_us = None
    if dev.type == "cuda":
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            decisions_loop(G, T, dev)
            torch.cuda.synchronize(dev)
        dev_us = {
            e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        }
        card_us = sum(us for k, us in dev_us.items()
                      if any(n in k for n in STEP_CU_LAUNCHES)) / T
        loop_us = sum(dev_us.values()) / T
    return {
        "metric": (
            f"consensus decisions/sec (fused device step, {G} groups x 3 "
            f"replicas, device {_device_text(dev_info)})"
        ),
        "value": round(G * T / dt, 1),
        "unit": "decisions/sec",
        "vs_baseline": round(G * T / dt / 100_000.0, 2),
        "groups": G,
        "steps": T,
        "timing": timing,
        "card_us_per_step": card_us,
        "loop_card_us_per_step": loop_us,
        "success_total": int(sums.sum().item()),
        "device": dev_info,
        "kernel_launches": _launches_since(launches0),
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="small/fast run")
    ap.add_argument("--decisions", action="store_true",
                    help="raw decision-kernel throughput instead of pipeline")
    ap.add_argument("--reads", action="store_true",
                    help="consistent-read throughput, lease on vs the "
                         "lease-off quorum-round control "
                         "(docs/INTERNALS.md §20)")
    ap.add_argument("--no-wal", action="store_true",
                    help="in-memory logs: host routing ceiling (the "
                         "headline default is WAL-backed/durable)")
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--cmds", type=int, default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--workdir", default=None,
                    help="WAL/segment directory (default: temp dir)")
    ap.add_argument("--pipeline", choices=("on", "off", "threaded"),
                    default="on",
                    help="on (default): cooperative pipelined stage/"
                         "finish stepping + decoupled durable acks; "
                         "off: the sequential cooperative control (A/B "
                         "is this one flag); threaded: started "
                         "two-stage loops (the production shape, "
                         "recorded as a secondary artifact)")
    ap.add_argument("--rings", choices=("on", "off"), default="on",
                    help="on (default): lock-free per-producer ingress "
                         "rings + event-driven wakeups; off: the "
                         "lock+deque control command plane (same-box "
                         "A/B is this one flag)")
    ap.add_argument("--native", default="auto",
                    help="native hot-loop runtime paths: auto/on/all "
                         "(default), off/none, or a comma list of "
                         "pack,classify,egress (per-entry-point "
                         "ablation; docs/INTERNALS.md §18)")
    ap.add_argument("--device", default=None,
                    help="torch device of the coordinators and the "
                         "step (default: cuda, which fails without a "
                         "card; cpu runs the plain torch-op step)")
    args = ap.parse_args()

    if args.decisions:
        g = args.groups or (1024 if args.smoke else 10240)
        out = bench_decisions(g, args.steps or (10 if args.smoke else 200),
                              device=args.device)
    elif args.reads:
        g = args.groups or (64 if args.smoke else 256)
        out = bench_reads(g, args.cmds or (10 if args.smoke else 60),
                          device=args.device)
    else:
        # 96 commands in flight per group — deep pipelining is the
        # reference harness's own methodology (PIPE_SIZE=500 in-flight
        # per client x 5 clients, src/ra_bench.erl:18-19); the AER
        # batch cap (128) still bounds every RPC
        g = args.groups or (128 if args.smoke else 10240)
        out = bench_pipeline(g, args.cmds or (3 if args.smoke else 96),
                             wal=not args.no_wal, workdir=args.workdir,
                             pipeline=args.pipeline, rings=args.rings,
                             native=args.native, device=args.device)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
