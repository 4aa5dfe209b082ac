#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ra_tpu_torch``) on one GPU and check it.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ra_tpu_torch/csrc/`` (one
``nvcc`` per source, all at once), holds each against its plain PyTorch
version on the card: the quorum scan (``quorum.cu``) and the fused step
kernels (``step.cu``, full width and active set) over edge inputs at
P = 1..16 and 33 (the register instances and the runtime-width one),
against the plain torch-op step on the card and on the CPU. Then it
runs the main path, the durable replicated write of the batch backend:
three ``BatchCoordinator``s hosting 10240 raft groups x 3 replicas over
WAL-backed logs, cooperative pipelined stepping, through the step
kernels, and checks that every command was committed and applied on all
three replicas. The same main path runs once more with the plain
torch-op step, for comparison within the run. Last, phase api drives the
same 10240 groups x 3 replicas on three started coordinators (each with
its own step thread) through the client API, ``ra_tpu_torch.api``: one
command and one consistent read per group from 32 client threads, every
reply and read checked, the replicas of a sample of groups compared.
Phase harness then runs the fault-injection harnesses on the card:
``kv_harness.run`` on the batch backend (partitions and membership
churn; every nemesis dimension at once, with coordinator crash-restarts
from the WAL and live active-set mode flips, once with the native host
paths off; lease reads under one-way
partitions; ENOSPC storms), the live linearizability workload, and the
planted stale-read bug, which the checker must catch in each active-set
mode.

Options (the defaults are the smoke run):

    --rounds N             run the main-path comparison N times, the
                           order alternating (kernels then plain, plain
                           then kernels, ...), and report every run
    --switch-interval S    set the interpreter's thread switch interval
                           (sys.setswitchinterval) to S seconds for the
                           main-path runs

Phases print one line each (and their elapsed time). The line before
the last is a JSON object ``{"kernels": [...]}`` with each kernel's
launches on the main path (and in each phase), its parity result and
its times; the last line is ``{"ok": true, "device": {...}}``. Any
failed phase exits non-zero without that last line. Without CUDA it exits non-zero at once.
It imports nothing of JAX and nothing of the ``ra_tpu`` package.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# the main path's shape (bench.py's headline: 10240 groups x 3 replicas)
GROUPS = 10240
PEERS = 3
SUFFIX_K = 32
WAVES = 4  # full-fleet command waves on the main path
TIMED_CALLS = 200  # per timed function (median reported)
# the active-set step's shape: the coordinator's power-of-two pad over
# 1500 hot groups
SUB_REAL = 1500
SUB_CAP = 2048
# peer widths of phase step: the step kernel's register instances (1..8)
# and its runtime-width instance (9..16, 33)
STEP_WIDTHS = tuple(range(1, 17)) + (33,)

# phase api: client threads, groups whose replicas are compared, and the
# coordinators' election timeout (at full fleet an election round trip
# takes about a second of host time, so the default 0.15 s would re-arm
# elections that are merely slow; the lease window is 0.8 of it)
API_CLIENTS = 32
API_SAMPLE = 256
API_ELECTION_TIMEOUT_S = 2.0
# a consistent read whose heartbeat round lost its replies stays pending
# until a later read of the same group comes, so a client gives up on an
# attempt after this long and reads again (reads are idempotent); the
# retries are counted and printed
API_READ_TIMEOUT_S = 10.0
API_READ_ATTEMPTS = 5

# H100 SXM published peaks (NVIDIA data sheet), for the bound
HBM_BYTES_PER_S = 3.35e12
# non-tensor-core rate (fp32 FMA pipe), used for int32 ALU work too
ALU_OPS_PER_S = 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out[0].strip()


def median_ms(fn, n: int = TIMED_CALLS, warmup: int = 20) -> float:
    """Median over ``n`` calls of ``fn()``, each timed with a pair of
    CUDA events on the current stream."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


# ---------------------------------------------------------------------------
# phase 2: the quorum kernel against its plain version


def quorum_inputs(rng, g: int, p: int):
    """Random match vectors and voter masks, with the edge rows of the
    JAX package's kernel tests: all voters present, a single voter, and
    no voter at all."""
    match = rng.integers(0, 1 << 20, (g, p)).astype(np.int32)
    voting = rng.random((g, p)) < 0.7
    voting[0::7] = True  # every member votes
    voting[1::7] = False
    voting[1::7, 0] = True  # single voter
    voting[2::7] = False  # no voter
    nvoters = voting.sum(axis=1).astype(np.int32)
    return match, voting, nvoters


def phase_kernel(torch, quorum, dev) -> dict:
    rng = np.random.default_rng(1)
    max_err = 0
    shapes = 0
    for g in (10240, 10237):
        for p in (1, 3, 5, 7, 8):
            m, v, nv = quorum_inputs(rng, g, p)
            tm = torch.from_numpy(m).to(dev)
            tv = torch.from_numpy(v).to(dev)
            tn = torch.from_numpy(nv).to(dev)
            got = quorum.agreed_commit(tm, tv, tn)
            ref = quorum.agreed_commit_plain(tm, tv, tn)
            torch.cuda.synchronize()
            err = int((got.long() - ref.long()).abs().max().item())
            if not torch.equal(got, ref):
                raise AssertionError(
                    f"quorum kernel != plain at G={g}, P={p} (max err {err})"
                )
            max_err = max(max_err, err)
            shapes += 1
    # times at the main path's shape
    m, v, nv = quorum_inputs(rng, GROUPS, PEERS)
    tm = torch.from_numpy(m).to(dev)
    tv = torch.from_numpy(v).to(dev)
    tn = torch.from_numpy(nv).to(dev)
    kernel_ms = median_ms(lambda: quorum.agreed_commit(tm, tv, tn))
    plain_ms = median_ms(lambda: quorum.agreed_commit_plain(tm, tv, tn))
    # library yardstick: torch.sort + gather over the masked matrix, with
    # the mask and the picked positions prepared outside the timed call
    eff = torch.where(tv, tm, -1)
    pos = torch.clamp(PEERS - 1 - torch.div(tn, 2, rounding_mode="floor"),
                      0, PEERS - 1).long()[:, None]
    library_ms = median_ms(
        lambda: torch.sort(eff, dim=-1).values.gather(-1, pos)
    )
    g, p = GROUPS, PEERS
    nbytes = g * p * 4 + g * p * 1 + g * 4 + g * 4  # G*(5P+8)
    # per group: P masks, P passes of ~P/2 compare-exchanges (2 ops
    # each), the clamp and a P-way select
    nops = g * (p + p * (p // 2) * 2 + 6 + p)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ALU_OPS_PER_S * 1e3
    return {
        "shapes": shapes, "max_abs_err": max_err, "ms": kernel_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bytes": nbytes,
    }


# ---------------------------------------------------------------------------
# phase 3: the step kernels against the plain step, on the card and the CPU


def step_cases():
    """The edge-input generators shared with the card tests
    (``tests/torch_step_cases.py``, numpy only)."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import torch_step_cases

    return torch_step_cases


def step_max_err(torch, C, a, b) -> int:
    """Largest absolute difference over every state field and egress row
    of two step results (state, egress), wherever they lie."""
    (sa, ea), (sb, eb) = a, b
    err = (ea.cpu().long() - eb.cpu().long()).abs().max().item()
    for fa, fb in zip(sa, sb):
        d = (fa.cpu().long() - fb.cpu().long()).abs()
        err = max(err, d.max().item() if d.numel() else 0)
    return int(err)


def step_bound(C, S, state, packed, gidx, out) -> tuple:
    """(bytes, operations) a step must spend: every state field it reads
    (all but last_applied) and the packed mailbox (and gidx) read once,
    every changed field and the egress written once; integer operations
    counted per column (decisions, P-wide rows, K ring slots) and, on
    the active set, per group for the scattered copy."""
    new_state, egress = out
    nbytes = sum(t.nbytes for f, t in zip(C.GroupState._fields, state)
                 if f != "last_applied")
    nbytes += packed.nbytes + (gidx.nbytes if gidx is not None else 0)
    nbytes += sum(getattr(new_state, f).nbytes for f in S.OUT_FIELDS)
    nbytes += egress.nbytes
    g, p = state.match_index.shape
    k = state.term_suffix.shape[1]
    cols = packed.shape[1]
    ops = cols * (150 + 20 * p + 12 * k)
    if gidx is not None:
        ops += g * (30 + 4 * p + 12 * k)
    return nbytes, ops


def phase_step(torch, C, S, dev) -> dict:
    cases = step_cases()
    g = GROUPS
    err = {"full": 0, "sub": 0}
    steps = {"full": 0, "sub": 0}
    launches0 = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
    advanced = False
    for p in STEP_WIDTHS:
        for near_max in (False, True):
            rng = np.random.default_rng(100 * p + near_max)
            fields = cases.state_fields(rng, g, p, SUFFIX_K, near_max=near_max)
            s_dev = C.state_from_numpy(fields, dev)
            s_cpu = C.state_from_numpy(fields, "cpu")
            for i in range(6 if (p, near_max) == (PEERS, False) else 2):
                host = C.state_to_numpy(s_cpu)
                if i % 2 == 0:
                    kind = "full"
                    args = (cases.packed(rng, host, np.arange(g), g),)
                    kern = C.consensus_step_packed_scat
                    plain = C.consensus_step_packed_scat_plain
                else:
                    kind = "sub"
                    gidx = cases.active_set(rng, g, SUB_REAL, SUB_CAP)
                    args = (cases.packed(rng, host, gidx, SUB_CAP), gidx)
                    kern = C.consensus_step_packed_sub_scat
                    plain = C.consensus_step_packed_sub_scat_plain
                on_cpu = [torch.from_numpy(a) for a in args]
                on_dev = [a.to(dev) for a in on_cpu]
                got = kern(s_dev, *on_dev)
                torch.cuda.synchronize()
                want_cpu = plain(s_cpu, *on_cpu)
                e = max(step_max_err(torch, C, got, plain(s_dev, *on_dev)),
                        step_max_err(torch, C, got, want_cpu))
                if e:
                    raise AssertionError(
                        f"{kind} step kernel != plain step at P={p}, "
                        f"near_max={near_max}, step {i} (max err {e})")
                err[kind] = max(err[kind], e)
                steps[kind] += 1
                advanced |= bool(
                    (want_cpu[0].commit_index > s_cpu.commit_index).any())
                s_dev, s_cpu = got[0], want_cpu[0]
    if (S.LAUNCHES_FULL - launches0[0], S.LAUNCHES_SUB - launches0[1]) != (
            steps["full"], steps["sub"]):
        raise AssertionError("the CUDA steps did not run the step kernels")
    if not advanced:
        raise AssertionError("no commit advanced: the inputs exercise nothing")

    # times, bound and device time at the main path's shape
    rng = np.random.default_rng(3)
    fields = cases.state_fields(rng, g, PEERS, SUFFIX_K)
    st = C.state_from_numpy(fields, dev)
    full = torch.from_numpy(cases.packed(rng, fields, np.arange(g), g)).to(dev)
    gidx = cases.active_set(rng, g, SUB_REAL, SUB_CAP)
    sub = torch.from_numpy(cases.packed(rng, fields, gidx, SUB_CAP)).to(dev)
    gidx = torch.from_numpy(gidx).to(dev)
    calls = {
        "full": (lambda: C.consensus_step_packed_scat(st, full),
                 lambda: C.consensus_step_packed_scat_plain(st, full),
                 full, None),
        "sub": (lambda: C.consensus_step_packed_sub_scat(st, sub, gidx),
                lambda: C.consensus_step_packed_sub_scat_plain(st, sub, gidx),
                sub, gidx),
    }
    out = {"steps": steps}
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for kind, (kern, plain, packed, gi) in calls.items():
        nbytes, ops = step_bound(C, S, st, packed, gi, kern())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        # the card's own time for the step's launches (memset, pre-pass,
        # scattered copy, step), without the host's gaps between calls
        n_prof = 50
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n_prof):
                kern()
            torch.cuda.synchronize()
        dev_us = {
            e.key: getattr(e, "self_device_time_total",
                           getattr(e, "self_cuda_time_total", 0)) / n_prof
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        }
        out[kind] = {
            "max_abs_err": err[kind], "ms": median_ms(kern),
            "plain_ms": median_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "device_us_per_step": {k: round(v, 3) for k, v in dev_us.items()},
        }
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path


def open_storage(coords, node_names, workdir: str, storage: list) -> None:
    """Give each coordinator its node's shared WAL and segment writer
    under ``workdir/<node>``, appended to ``storage`` as (tables, wal,
    segment writer, dir), so that the caller closes what was opened."""
    from ra_tpu_torch.log.segment_writer import SegmentWriter
    from ra_tpu_torch.log.tables import TableRegistry
    from ra_tpu_torch.log.wal import Wal

    for n, c in zip(node_names, coords):
        d = os.path.join(workdir, n)
        tables = TableRegistry()
        sw = SegmentWriter(os.path.join(d, "data"), tables, c.wal_notify)
        w = Wal(os.path.join(d, "wal"), tables, c.wal_notify,
                segment_writer=sw, max_batch_size=65536)
        w.notify_many = c.wal_notify_many
        storage.append((tables, w, sw, d))


def wal_logs(storage, g_n: int, chunk: int = 512) -> list:
    """Per coordinator, the WAL-backed ``Log`` of groups g0..g{n-1} (uid
    ``g{g}``), built by 8 threads: a Log's directory fsyncs set the
    set-up's pace and release the GIL, so the fleet's 30720 logs are
    made in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from ra_tpu_torch.log.log import Log

    def build(job):
        (tables, w, _sw, d), lo = job
        return [Log(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, w)
                for g in range(lo, min(lo + chunk, g_n))]

    jobs = [(st, lo) for st in storage for lo in range(0, g_n, chunk)]
    with ThreadPoolExecutor(8) as pool:
        parts = list(pool.map(build, jobs))
    per = len(range(0, g_n, chunk))
    return [[log for part in parts[i * per:(i + 1) * per] for log in part]
            for i in range(len(storage))]


def phase_main(torch, C, S, dev, workdir: str, tag: str,
               use_kernels: bool = True) -> dict:
    """The main path with coordinators named ``tag``0..2: through the
    step kernels, or (``use_kernels=False``) through the plain torch-op
    step for comparison."""
    from ra_tpu_torch import obs
    from ra_tpu_torch.models.bench_machine import BenchMachine
    from ra_tpu_torch.protocol import Command, ElectionTimeout, USR
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = GROUPS
    # each fused step's span on the card's timeline, bracketed with CUDA
    # events, and the host's wall and thread CPU time for the call (the
    # coordinator looks the step functions up on the module per call;
    # wall time well above CPU time means the thread waited, for the GIL
    # or the OS): (stage, kind) -> (events a, b, wall s, cpu s), stage
    # "election", "waves" or "profiled", kind "full" or "sub"
    step_events = {}
    stage = ["election"]
    orig = {}

    def timed(kind, fn):
        def run(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            w0, c0 = time.perf_counter(), time.thread_time()
            a.record()
            out = fn(*args)
            b.record()
            w1, c1 = time.perf_counter(), time.thread_time()
            step_events.setdefault((stage[0], kind), []).append(
                (a, b, w1 - w0, c1 - c0))
            return out
        return run

    for kind, name in (("full", "consensus_step_packed_scat"),
                       ("sub", "consensus_step_packed_sub_scat")):
        orig[name] = getattr(C, name)
        fn = orig[name] if use_kernels else getattr(C, f"{name}_plain")
        setattr(C, name, timed(kind, fn))

    node_names = [f"{tag}{i}" for i in range(3)]
    coords = [
        BatchCoordinator(n, capacity=g_n, num_peers=PEERS,
                         suffix_k=SUFFIX_K, idle_sleep_s=0, device=dev)
        for n in node_names
    ]
    storage = []
    try:
        open_storage(coords, node_names, workdir, storage)
        logs = wal_logs(storage, g_n)
        members = lambda g: [(f"g{g}", n) for n in node_names]  # noqa: E731
        for i, c in enumerate(coords):
            c.add_groups([
                (f"g{g}", f"cl{g}", members(g), BenchMachine(), logs[i][g])
                for g in range(g_n)
            ])
        for c in coords:
            for f in c.state:
                if f.device.type != "cuda":
                    raise AssertionError("coordinator state is not on cuda")

        def step_all() -> bool:
            worked = False
            for c in coords:
                worked = c.step_stage() or worked
            for c in coords:
                worked = c.step_finish() or worked
            return worked

        def settle() -> None:
            while step_all():
                pass

        names = [f"g{g}" for g in range(g_n)]
        by0 = coords[0].by_name
        # the counts cover this run of the main path only
        S.LAUNCHES_FULL = S.LAUNCHES_SUB = C.quorum.LAUNCHES = 0
        wide0 = C.WIDE_SORT_STEPS
        counted0 = (sum(c.steps for c in coords),
                    sum(c.sub_steps for c in coords))
        deadline = time.time() + 600
        t0 = time.perf_counter()
        coords[0].deliver_many(
            [((n, node_names[0]), ElectionTimeout(), None) for n in names]
        )
        while not all(by0[n].role == C.R_LEADER for n in names):
            if time.time() > deadline:
                raise TimeoutError("leader election incomplete")
            if not step_all():
                time.sleep(0.001)
        settle()
        t_elect = time.perf_counter() - t0
        base = [c._applied_np[:g_n].copy() for c in coords]
        steps0 = sum(c.steps for c in coords)
        sub0 = sum(c.sub_steps for c in coords)
        cmd = Command(kind=USR, data=1, reply_mode="noreply")
        done = [0]

        def run_waves(n: int) -> float:
            t1 = time.perf_counter()
            for _ in range(n):
                coords[0].deliver_commands(names, cmd)
            done[0] += n
            while not all((c._applied_np[:g_n] >= b + done[0]).all()
                          for c, b in zip(coords, base)):
                if time.time() > deadline:
                    raise TimeoutError("command waves did not complete")
                if not step_all():
                    time.sleep(0.0005)
            return time.perf_counter() - t1

        # the wave-phase split of the measured waves (obs histograms)
        hists = {ph: [obs.histograms().fetch(("wave", n, ph))
                      for n in node_names]
                 for ph, _ in obs.WAVE_STEP_PHASES}
        for hs in hists.values():
            for h in hs:
                h.reset()
        stage[0] = "waves"
        t_waves = run_waves(WAVES)
        wave_split_ms = {ph: sum(h.total for h in hs) / 1e6
                         for ph, hs in hists.items()}
        settle()
        wave_steps = sum(c.steps for c in coords) - steps0
        wave_sub = sum(c.sub_steps for c in coords) - sub0
        stage[0] = "profiled"
        # one more wave under the profiler: how busy the card is while
        # the main path runs (the profiler's overhead slows the host, so
        # this wave's wall time is not the throughput measurement)
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t_prof = run_waves(1)
            torch.cuda.synchronize()
        settle()
        kern = [
            (getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0)), e.key)
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA
        ]
        busy_us = sum(t for t, _ in kern)
        top = sorted(kern, reverse=True)[:3]
        launches = {"full": S.LAUNCHES_FULL, "sub": S.LAUNCHES_SUB,
                    "quorum": C.quorum.LAUNCHES}
        wide = C.WIDE_SORT_STEPS - wide0
        torch.cuda.synchronize()

        # every replica applied exactly the delivered commands
        for i, c in enumerate(coords):
            applied = c._applied_np[:g_n]
            if not np.array_equal(base[i], base[0]):
                raise AssertionError(f"coordinator {i}: election floor off")
            if not np.array_equal(applied, base[0] + done[0]):
                raise AssertionError(f"coordinator {i}: applied index off")
            ms = np.array([c.by_name[n].machine_state for n in names])
            if not (ms == done[0]).all():
                raise AssertionError(
                    f"coordinator {i}: machine state off "
                    f"(min {ms.min()}, max {ms.max()}, want {done[0]})")
            dev_commit = c.state.commit_index[:g_n].cpu().numpy()
            if not (dev_commit >= applied).all():
                raise AssertionError(f"coordinator {i}: commit below apply")
            for f in c.state:
                if f.device.type != "cuda":
                    raise AssertionError("coordinator state left cuda")
        steps = sum(c.steps for c in coords) - counted0[0]
        sub_steps = sum(c.sub_steps for c in coords) - counted0[1]
        if use_kernels:
            # every step launched its kernel, and no step took the plain
            # route (whose quorum scan would launch quorum.cu)
            if (launches["full"], launches["sub"]) != (steps - sub_steps,
                                                       sub_steps):
                raise AssertionError(
                    f"step kernel launches {launches} != steps "
                    f"{steps - sub_steps} full, {sub_steps} sub")
            if launches["quorum"]:
                raise AssertionError("the kernel path launched quorum.cu")
        elif launches["full"] or launches["sub"]:
            raise AssertionError("the plain run launched the step kernels")
        if wide:
            raise AssertionError(f"{wide} steps ran the quorum scan's P > 8 route")
        step_ms = {
            f"{st}_{kind}": (
                len(ev),
                sum(a.elapsed_time(b) for a, b, _, _ in ev) / len(ev),
                sum(w for _, _, w, _ in ev) * 1e3 / len(ev),
                sum(c for _, _, _, c in ev) * 1e3 / len(ev))
            for (st, kind), ev in sorted(step_events.items())
        }
        return {
            "election_s": t_elect,
            "waves_s": t_waves,
            "cmds": WAVES * g_n,
            "durable_cmds_per_s": WAVES * g_n / t_waves,
            "steps": steps,
            "sub_steps": sub_steps,
            "wave_split_ms": wave_split_ms,
            "wave_steps": wave_steps,
            "wave_sub_steps": wave_sub,
            "launches": launches,
            "profiled_wave_s": t_prof,
            "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e6 / t_prof,
            "top_kernels": [(k, us / 1e3) for us, k in top],
            "step_ms": step_ms,
            "native": {p: getattr(coords[0], f"_nat_{p}")
                       for p in ("pack", "classify", "egress")},
        }
    finally:
        for name, fn in orig.items():
            setattr(C, name, fn)
        for c in coords:
            c.stop()
        for _tables, w, sw, _d in storage:
            w.close()
            sw.close()


# ---------------------------------------------------------------------------
# phase 5: the client API over started coordinators


def percentiles_ms(xs) -> tuple:
    """(p50, p99) of durations in seconds, in ms."""
    a = np.asarray(xs, np.float64) * 1e3
    return float(np.percentile(a, 50)), float(np.percentile(a, 99))


def phase_api(torch, C, S, dev, workdir: str) -> dict:
    """10240 groups x 3 replicas on three started coordinators (each
    stepped by its own thread), WAL-backed, leases on, driven only
    through ``ra_tpu_torch.api``: one command and one consistent read
    per group from a pool of ``API_CLIENTS`` client threads, every reply
    and read checked against the group's expected sum, then the replica
    states of a sample of groups compared through ``api.local_query``."""
    from concurrent.futures import ThreadPoolExecutor

    from ra_tpu_torch import api, leaderboard
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = GROUPS
    node_names = [f"api{i}" for i in range(3)]
    leaderboard.clear()
    coords = [
        BatchCoordinator(n, capacity=g_n, num_peers=PEERS, suffix_k=SUFFIX_K,
                         device=dev, lease=True,
                         election_timeout_s=API_ELECTION_TIMEOUT_S)
        for n in node_names
    ]
    storage = []
    try:
        open_storage(coords, node_names, workdir, storage)
        logs = wal_logs(storage, g_n)
        members = lambda g: [(f"g{g}", n) for n in node_names]  # noqa: E731
        for i, c in enumerate(coords):
            c.add_groups([
                (f"g{g}", f"cl{g}", members(g),
                 SimpleMachine(lambda cmd, s: s + cmd, 0), logs[i][g])
                for g in range(g_n)
            ])
        names = [f"g{g}" for g in range(g_n)]
        rng = np.random.default_rng(5)
        values = rng.integers(1, 1 << 20, g_n).tolist()

        # the counts cover this phase only
        S.LAUNCHES_FULL = S.LAUNCHES_SUB = C.quorum.LAUNCHES = 0
        counted0 = (sum(c.steps for c in coords),
                    sum(c.sub_steps for c in coords))
        t0 = time.perf_counter()
        for c in coords:
            c.start()
        coords[0].deliver_many(
            [((n, node_names[0]), ElectionTimeout(), None) for n in names])
        by = [c.by_name for c in coords]
        deadline = time.time() + 600

        def leader_of(n):
            for i in range(3):
                if by[i][n].role == C.R_LEADER:
                    return i
            return None

        while any(leader_of(n) is None for n in names):
            if time.time() > deadline:
                raise TimeoutError("api phase: leader election incomplete")
            time.sleep(0.05)
        t_elect = time.perf_counter() - t0

        def command(g):
            t = time.perf_counter()
            reply, _leader = api.process_command(
                (f"g{g}", node_names[0]), values[g], timeout=120)
            dt = time.perf_counter() - t
            if reply != values[g]:
                raise AssertionError(
                    f"group g{g}: command replied {reply}, want {values[g]}")
            return dt

        # every 4th read enters at a follower with no leader hint, so
        # that the follower's redirect carries the client to the leader
        def read(g):
            """(latency, attempts that timed out) of one checked read."""
            name, follow = f"g{g}", g % 4 == 0
            if follow:
                lead = leader_of(name)
                sid = (name, node_names[(lead + 1) % 3])
                leaderboard.clear(f"cl{g}")
            else:
                sid = (name, node_names[g % 3])
            t = time.perf_counter()
            for timed_out in range(API_READ_ATTEMPTS):
                try:
                    out = api.consistent_query(sid, lambda s: s,
                                               timeout=API_READ_TIMEOUT_S)
                    break
                except TimeoutError:
                    if timed_out == API_READ_ATTEMPTS - 1:
                        raise
            dt = time.perf_counter() - t
            if out[0] != "ok" or out[1] != values[g]:
                raise AssertionError(
                    f"group {name}: consistent read {out[:2]}, want {values[g]}")
            return dt, timed_out

        def replicas(g):
            return [api.local_query((f"g{g}", n), lambda s: s, timeout=60)[1]
                    for n in node_names]

        sample = np.random.default_rng(6).choice(
            g_n, API_SAMPLE, replace=False).tolist()
        with ThreadPoolExecutor(API_CLIENTS) as pool:
            t1 = time.perf_counter()
            cmd_lat = list(pool.map(command, range(g_n)))
            t_cmds = time.perf_counter() - t1
            t1 = time.perf_counter()
            reads = list(pool.map(read, range(g_n)))
            t_reads = time.perf_counter() - t1
            read_lat = [dt for dt, _ in reads]
            # the replicas of a sample of groups hold the same state (a
            # follower applies once a later AER or probe brings it the
            # commit index)
            lagging = sample
            while lagging:
                if time.time() > deadline:
                    raise AssertionError(
                        f"api phase: replicas differ in {len(lagging)} of "
                        f"{len(sample)} sampled groups, e.g. g{lagging[0]}")
                states = dict(zip(lagging, pool.map(replicas, lagging)))
                lagging = [g for g, s in states.items()
                           if s != [values[g]] * 3]
                if lagging:
                    time.sleep(0.2)
        read_counts = {k: sum(c.counters.get(k) for c in coords)
                       for k in ("read_lease_served", "read_quorum_fallback")}
        read_counts["reads_retried"] = sum(n for _, n in reads)
        dropped = [c.transport.dropped for c in coords]
    finally:
        # followers first: a running coordinator that sees the leaders'
        # node stop arms one election timer thread per group it follows
        for c in reversed(coords):
            c.stop()
        for _tables, w, sw, _d in storage:
            w.close()
            sw.close()
        leaderboard.clear()
    torch.cuda.synchronize()
    launches = {"full": S.LAUNCHES_FULL, "sub": S.LAUNCHES_SUB,
                "quorum": C.quorum.LAUNCHES}
    steps = sum(c.steps for c in coords) - counted0[0]
    sub_steps = sum(c.sub_steps for c in coords) - counted0[1]
    if launches["full"] + launches["sub"] == 0:
        raise AssertionError("the api phase launched no step kernel")
    if (launches["full"], launches["sub"]) != (steps - sub_steps, sub_steps):
        raise AssertionError(
            f"step kernel launches {launches} != steps {steps - sub_steps} "
            f"full, {sub_steps} sub")
    if launches["quorum"]:
        raise AssertionError("the api phase launched quorum.cu")
    for c in coords:
        for f in c.state:
            if f.device.type != dev.type:
                raise AssertionError(f"coordinator state left {dev.type}")
    cp50, cp99 = percentiles_ms(cmd_lat)
    rp50, rp99 = percentiles_ms(read_lat)
    return {
        "election_s": t_elect, "cmds_per_s": g_n / t_cmds,
        "cmd_p50_ms": cp50, "cmd_p99_ms": cp99,
        "reads_per_s": g_n / t_reads, "read_p50_ms": rp50,
        "read_p99_ms": rp99, "reads": read_counts, "dropped": dropped,
        "launches": launches,
        "steps": steps, "sub_steps": sub_steps, "sample": len(sample),
    }


def api_line(ka: dict, card: str) -> str:
    return (
        f"{GROUPS} groups x 3 replicas on 3 started coordinators, WAL-backed, "
        f"lease on, {API_CLIENTS} client threads: election {ka['election_s']:.3f} s; "
        f"{GROUPS} commands through api.process_command at "
        f"{ka['cmds_per_s']:.1f} cmds/s, latency p50 {ka['cmd_p50_ms']:.3f} ms "
        f"p99 {ka['cmd_p99_ms']:.3f} ms (call to return), every reply checked; "
        f"{GROUPS} api.consistent_query reads (every 4th entering at a "
        f"follower with no leader hint) at {ka['reads_per_s']:.1f} reads/s, "
        f"latency p50 {ka['read_p50_ms']:.3f} ms p99 {ka['read_p99_ms']:.3f} ms, "
        f"every read checked; counters {ka['reads']} (reads_retried: "
        f"attempts that timed out after {API_READ_TIMEOUT_S} s); messages "
        f"shed by each coordinator's transport {ka['dropped']}; replicas equal in "
        f"{ka['sample']} sampled groups (api.local_query); steps "
        f"{ka['steps']} (sub {ka['sub_steps']}); launches {ka['launches']} "
        f"| {card}")


def main_line(km: dict, card: str) -> str:
    return (
        f"election {km['election_s']:.3f} s; {km['cmds']} cmds in "
        f"{km['waves_s']:.3f} s = {km['durable_cmds_per_s']:.1f} durable "
        f"cmds/s, applied on all 3 replicas; steps {km['steps']} (sub "
        f"{km['sub_steps']}; waves {km['wave_steps']}, sub "
        f"{km['wave_sub_steps']}); launches {km['launches']}; step calls "
        f"by stage and kind, (steps, mean span on the card's timeline ms, "
        f"mean host wall ms, mean host thread CPU ms): "
        f"{km['step_ms']}; wave-phase split of the measured waves (ms "
        f"summed over the 3 coordinators): {km['wave_split_ms']}; native "
        f"host paths {km['native']}; profiled extra wave: {GROUPS} cmds in "
        f"{km['profiled_wave_s']:.3f} s, device busy "
        f"{km['device_busy_ms']:.3f} ms = {km['device_busy_share']:.6f} of "
        f"its wall time, top kernels (ms) {km['top_kernels']} | {card}")


# ---------------------------------------------------------------------------
# phase 6: the fault-injection harnesses on the card


# The runs of phase harness: the JAX package's tier-1 batch-backend seeds
# at the harness's own published sizes (capacity 8, 3 nodes + 1 spare;
# ``kv_harness._run_batch``), each with the assertions of the reference
# test that runs it. ``kv_harness.run`` keyword arguments, then the op
# counts and the nemesis counters that must be positive, and the step
# kernels that must each launch within the run.
HARNESS_RUNS = (
    # tests/test_kv_harness.py: partitions + membership churn
    ("partitions", dict(seed=21, n_ops=100, rescue=False), ("put",), (),
     ("sub",)),
    # tests/test_soak.py: every dimension, crash-restarts from WAL and
    # live active-set mode flips included (seed 2 flips between auto and
    # always)
    ("combined", dict(seed=2, n_ops=60, combined=True),
     ("coord_restart",), ("nemesis_modeflip_injected",), ("sub",)),
    # tests/test_soak.py's native-off smoke: seed 3's schedule flips to
    # never at its first op and back to auto at op 22, so the full-width
    # and the active-set kernels both run within the one run, across two
    # crash-restarts
    ("combined_native_off", dict(seed=3, n_ops=60, combined=True,
                                 native="off"),
     ("coord_restart",), ("nemesis_modeflip_injected",), ("full", "sub")),
    # tests/test_kv_harness.py: lease reads under one-way partitions
    # with forced depositions
    ("lease", dict(seed=61, n_ops=80, lease=True), ("get", "transfer"), (),
     ("sub",)),
    # tests/test_kv_harness.py: ENOSPC storms, degrade and resume
    ("disk_full", dict(seed=11, n_ops=100, partitions=False,
                       membership=False, restarts=False, disk_full=True,
                       op_timeout=3.0),
     ("disk_full", "batch_degraded", "batch_resumed"), (), ("sub",)),
)
STALE_READ_MODES = ("auto", "always", "never")


def stale_read_scenario(active_set: str, dev) -> list:
    """The planted stale-read bug of the JAX package's linearizability
    tests, on the port: consistent queries answered from local state
    without the leadership-confirmation quorum. A deposed leader then
    serves a stale read, and the checker must reject the history.
    Returns the checker's violations; raises if the bug escaped. The
    class is patched inside ``try/finally``."""
    from ra_tpu_torch import api, leaderboard
    from ra_tpu_torch.kv_harness import DictKv
    from ra_tpu_torch.linearize import HistoryRecorder, Op, check_history
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.protocol import ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    def broken_consistent_query(self, g, fn, fut):
        # the planted bug: a deposed leader answers from its own state
        if g.role == C.R_LEADER or g.leader_slot == g.self_slot:
            self._reply(fut, ("ok", fn(g.machine_state), (g.name, self.name)))
        else:
            self._reply(fut, ("redirect", g.sid_of(g.leader_slot)))

    def await_(cond, what):
        deadline = time.monotonic() + 30
        while not cond():
            if time.monotonic() > deadline:
                raise AssertionError(f"stale-read scenario: timeout: {what}")
            time.sleep(0.02)

    orig_query = BatchCoordinator._handle_consistent_query
    BatchCoordinator._handle_consistent_query = broken_consistent_query
    leaderboard.clear()
    names = ["sr0", "sr1", "sr2"]
    coords = {n: BatchCoordinator(n, capacity=8, num_peers=3,
                                  election_timeout_s=0.1,
                                  detector_poll_s=0.05,
                                  active_set=active_set, device=dev)
              for n in names}
    ids = [("srg", n) for n in names]
    rec = HistoryRecorder()
    try:
        for c in coords.values():
            c.start()
        for n in names:
            coords[n].add_group("srg", "src", ids, DictKv())
        coords["sr0"].deliver(ids[0], ElectionTimeout(), None)
        await_(lambda: coords["sr0"].by_name["srg"].role == C.R_LEADER,
               "sr0 leads")

        def write(value, target):
            inv = rec.now()
            api.process_command(target, ("put", "k", value), timeout=10)
            rec.record("k", Op(0, "write", value, inv, rec.now()))

        def read_at(target, cid):
            inv = rec.now()
            fut = api.Future()
            coords[target[1]].deliver(
                target, ("consistent_query", lambda s: s.get("k"), fut), None)
            out = fut.result(10)
            if out[0] != "ok":
                raise AssertionError(f"stale-read scenario: read {out}")
            rec.record("k", Op(cid, "read", out[1], inv, rec.now()))

        write((0, 1), ids[0])
        # the leader is cut off; either majority member may take over
        for o in ("sr1", "sr2"):
            coords["sr0"].transport.block("sr0", o)
            coords[o].transport.block(o, "sr0")
        coords["sr1"].deliver(ids[1], ElectionTimeout(), None)
        await_(lambda: any(coords[n].by_name["srg"].role == C.R_LEADER
                           for n in ("sr1", "sr2")), "majority side takes over")
        write((0, 2), ids[1])
        new_leader = next(n for n in ("sr1", "sr2")
                          if coords[n].by_name["srg"].role == C.R_LEADER)
        read_at(ids[0], cid=1)  # the deposed leader answers stale
        read_at(("srg", new_leader), cid=2)
        res = check_history(rec.history())
    finally:
        BatchCoordinator._handle_consistent_query = orig_query
        for c in coords.values():
            c.transport.unblock_all()
            c.stop()
        leaderboard.clear()
    if res.ok or not any("not linearizable" in v for v in res.violations):
        raise AssertionError(
            f"planted stale-read bug escaped the checker (active_set="
            f"{active_set}): {res.violations}")
    return res.violations


class CheckedCoordinators:
    """Checks held on every ``BatchCoordinator`` of phase harness (the
    class is patched inside the ``with`` block and restored after it):
    when ``stop()`` returns, none of the coordinator's threads (step,
    egress, sender, detector) is alive, so nothing touches its pinned
    mailbox buffers or egress events again once a crash-restart builds
    its successor; and after ``add_group`` (a restarted coordinator's
    rebuild from the WAL included) every state tensor is on ``dev``."""

    def __init__(self, dev):
        from ra_tpu_torch.runtime.coordinator import BatchCoordinator

        self.cls = BatchCoordinator
        self.dev = dev
        self.stops = self.add_groups = 0

    def __enter__(self):
        cls, orig_stop, orig_add = self.cls, self.cls.stop, self.cls.add_group
        self.orig = (orig_stop, orig_add)
        check = self

        def stop(c):
            orig_stop(c)
            alive = [t.name for t in (c._step_thread, c._egress_thread,
                                      c._sender_thread, c._detector)
                     if t is not None and t.is_alive()]
            if alive:
                raise AssertionError(
                    f"coordinator {c.name}: threads alive after stop: {alive}")
            check.stops += 1

        def add_group(c, *args, **kw):
            out = orig_add(c, *args, **kw)
            for f in c.state:
                if f.device.type != check.dev.type:
                    raise AssertionError(
                        f"coordinator {c.name}: state on {f.device} after "
                        f"add_group")
            check.add_groups += 1
            return out

        cls.stop, cls.add_group = stop, add_group
        return self

    def __exit__(self, *exc):
        self.cls.stop, self.cls.add_group = self.orig
        return False


def phase_harness(torch, C, S, dev) -> dict:
    """``kv_harness.run`` on the batch backend with its coordinators on
    ``dev`` for each of ``HARNESS_RUNS``, then the live linearizability
    workload, then the planted stale-read bug in each active-set mode.
    Every run must hold; both step kernels must launch during the phase
    and quorum.cu must not; every coordinator is held to
    ``CheckedCoordinators``."""
    with CheckedCoordinators(dev) as checked:
        out = _harness_runs(C, S, dev)
    out["stops_checked"] = checked.stops
    out["add_groups_checked"] = checked.add_groups
    return out


def _harness_runs(C, S, dev) -> dict:
    from ra_tpu_torch import kv_harness, linearize

    def launches():
        return {"full": S.LAUNCHES_FULL, "sub": S.LAUNCHES_SUB,
                "quorum": C.quorum.LAUNCHES}

    def delta(before):
        return {k: v - before[k] for k, v in launches().items()}

    # the counts cover this phase only
    S.LAUNCHES_FULL = S.LAUNCHES_SUB = C.quorum.LAUNCHES = 0
    runs = {}
    for label, kw, want_ops, want_nemesis, want_kernels in HARNESS_RUNS:
        before, t = launches(), time.perf_counter()
        res = kv_harness.run(backend="tpu_batch", device=dev, **kw)
        elapsed = time.perf_counter() - t
        if not res.consistent:
            raise AssertionError(f"harness run {label}: {res.failures}")
        for k in want_ops:
            if res.ops.get(k, 0) <= 0:
                raise AssertionError(f"harness run {label}: no {k} ({res.ops})")
        for k in want_nemesis:
            if res.nemesis.get(k, 0) <= 0:
                raise AssertionError(
                    f"harness run {label}: {k} never fired ({res.nemesis})")
        ran = delta(before)
        for k in want_kernels:
            if ran[k] <= 0:
                raise AssertionError(
                    f"harness run {label}: no {k} step kernel launch ({ran})")
        runs[label] = {
            "ops": dict(res.ops), "failures": len(res.failures),
            "s": elapsed,
            "nemesis": {k: v for k, v in res.nemesis.items() if v},
            "launches": ran,
        }

    before, t = launches(), time.perf_counter()
    lin = linearize.run_workload(seed=9, backend="tpu_batch", n_clients=4,
                                 ops_per_client=30, device=dev)
    if not lin.ok or sum(lin.per_key_ops.values()) <= 30:
        raise AssertionError(
            f"linearize run: {lin.violations} ({lin.per_key_ops})")
    runs["linearize"] = {"ops": dict(lin.per_key_ops), "failures": 0,
                         "s": time.perf_counter() - t,
                         "launches": delta(before)}

    for mode in STALE_READ_MODES:
        before, t = launches(), time.perf_counter()
        caught = stale_read_scenario(mode, dev)
        runs[f"stale_read_{mode}"] = {
            "caught": len(caught), "s": time.perf_counter() - t,
            "launches": delta(before)}

    total = launches()
    if total["full"] <= 0 or total["sub"] <= 0:
        raise AssertionError(
            f"harness phase: a step kernel never launched {total}")
    if total["quorum"]:
        raise AssertionError("the harness phase launched quorum.cu")
    return {"runs": runs, "launches": total,
            "restarts": sum(runs[label]["ops"].get("coord_restart", 0)
                            for label, *_ in HARNESS_RUNS)}


def harness_line(kh: dict, card: str) -> str:
    parts = []
    for label, r in kh["runs"].items():
        if "caught" in r:
            what = f"bug caught ({r['caught']} violation)"
        else:
            what = f"ops {r['ops']}, failures {r['failures']}"
            if r.get("nemesis"):
                what += f", nemesis {r['nemesis']}"
        parts.append(f"{label}: {what}, launches {r['launches']}, "
                     f"{r['s']:.2f} s")
    return (f"batch backend on the card (capacity 8, 3 nodes + 1 spare): "
            f"{'; '.join(parts)}; coordinator restarts {kh['restarts']}; "
            f"coordinators stopped with no thread left {kh['stops_checked']}, "
            f"add_group calls leaving the state on the device "
            f"{kh['add_groups_checked']}; "
            f"step kernel launches in the phase {kh['launches']} | {card}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--switch-interval", type=float, default=None)
    args = ap.parse_args(argv)
    if args.rounds < 1:
        ap.error("--rounds must be at least 1")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import ra_tpu_torch
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.ops import kernels, quorum
    from ra_tpu_torch.ops import step as S

    pkg = os.path.dirname(os.path.abspath(ra_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        raise RuntimeError(f"ra_tpu_torch imported from {pkg}, not this checkout")
    if "jax" in sys.modules or any(
        m == "ra_tpu" or m.startswith("ra_tpu.") for m in sys.modules
    ):
        raise RuntimeError("JAX or the ra_tpu package was imported")
    dev = torch.device("cuda", 0)
    card = nvidia_smi_line()
    t_all = time.perf_counter()

    # phase 1: device and build (one nvcc per source, all at once)
    t = time.perf_counter()
    names = ("quorum", "step")
    kernels.build_many(names)
    log(card)
    log(f"phase device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | cuda {torch.version.cuda} | kernel builds "
        f"{ {n: round(kernels.BUILD_SECONDS[n], 2) for n in names} } s | "
        f"{time.perf_counter() - t:.2f} s")
    for n in names:
        for line in kernels.BUILD_LOG.get(n, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {n}: {line.strip()}")

    # phase 2: the quorum kernel against its plain version
    t = time.perf_counter()
    kq = phase_kernel(torch, quorum, dev)
    log(f"phase kernel: quorum_scan == plain on {kq['shapes']} shapes "
        f"(max_abs_err {kq['max_abs_err']}); at G={GROUPS} P={PEERS}: "
        f"kernel {kq['ms']:.6f} ms, plain {kq['plain_ms']:.6f} ms, "
        f"sort+gather {kq['library_ms']:.6f} ms, bound {kq['bound_ms']:.6f} ms "
        f"({kq['bound_by']}, {kq['bytes']} B) | {card} | "
        f"{time.perf_counter() - t:.2f} s")

    # phase 3: the step kernels against the plain step, card and CPU
    t = time.perf_counter()
    ks = phase_step(torch, C, S, dev)
    log(f"phase step: step kernels == plain step (on cuda and on cpu) in "
        f"every state field and egress row over {ks['steps']} packed steps "
        f"with edge inputs at G={GROUPS}, P={STEP_WIDTHS}, K={SUFFIX_K} "
        f"(max_abs_err full {ks['full']['max_abs_err']}, sub "
        f"{ks['sub']['max_abs_err']}) | {time.perf_counter() - t:.2f} s")
    for kind in ("full", "sub"):
        r = ks[kind]
        log(f"phase step, {kind} at G={GROUPS} P={PEERS} K={SUFFIX_K}"
            f"{'' if kind == 'full' else f' S={SUB_CAP} ({SUB_REAL} real)'}: "
            f"kernel {r['ms']:.6f} ms, plain {r['plain_ms']:.6f} ms (medians "
            f"of {TIMED_CALLS} event-bracketed calls), bound "
            f"{r['bound_ms']:.6f} ms ({r['bound_by']}, {r['bytes']} B, "
            f"{r['ops']} ops); card time per step by kernel (us): "
            f"{r['device_us_per_step']} | {card}")

    # phase 4: the main path through the step kernels, then the same
    # path through the plain torch-op step for comparison; with --rounds
    # the order alternates from round to round
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    log(f"phase main: interpreter switch interval {sys.getswitchinterval()} s")
    runs = []
    for rnd in range(args.rounds):
        order = (True, False) if rnd % 2 == 0 else (False, True)
        for use_kernels in order:
            tag = f"{'kern' if use_kernels else 'plain'}{rnd}_"
            t = time.perf_counter()
            workdir = tempfile.mkdtemp(prefix="ra_smoke_")
            try:
                r = phase_main(torch, C, S, dev, workdir, tag, use_kernels)
            finally:
                shutil.rmtree(workdir, ignore_errors=True)
            runs.append((use_kernels, r))
            log(f"phase main, round {rnd + 1} of {args.rounds} "
                f"({'step kernels' if use_kernels else 'plain step, for comparison'}): "
                f"{GROUPS} groups x 3 replicas, WAL-backed: "
                f"{main_line(r, card)} | {time.perf_counter() - t:.2f} s")
    if args.rounds > 1:
        for use_kernels in (True, False):
            log(f"phase main, durable cmds/s of every "
                f"{'kernel' if use_kernels else 'plain'} run in order: "
                f"{[r['durable_cmds_per_s'] for u, r in runs if u == use_kernels]}")
    km = next(r for u, r in runs if u)

    # phase 5: the client API over started coordinators, through the
    # step kernels
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="ra_smoke_api_")
    try:
        ka = phase_api(torch, C, S, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase api: {api_line(ka, card)} | {time.perf_counter() - t:.2f} s")

    # phase 6: the fault-injection harnesses and the linearizability
    # checker over the port's coordinators on the card
    t = time.perf_counter()
    kh = phase_harness(torch, C, S, dev)
    log(f"phase harness: {harness_line(kh, card)} | "
        f"{time.perf_counter() - t:.2f} s")
    log(f"total {time.perf_counter() - t_all:.2f} s")

    replaces = {"full": "ra_tpu/ops/consensus.py:693",
                "sub": "ra_tpu/ops/consensus.py:703"}

    def by_phase(kind):
        return {"main": km["launches"][kind], "api": ka["launches"][kind],
                "harness": kh["launches"][kind]}

    log(json.dumps({"kernels": [{
        "name": "quorum_scan",
        "route": "cuda",
        "source": "ra_tpu_torch/csrc/quorum.cu",
        "replaces": "ra_tpu/ops/pallas_quorum.py:38",
        "launches": km["launches"]["quorum"],
        "max_abs_err": kq["max_abs_err"],
        "ms": kq["ms"],
        "plain_ms": kq["plain_ms"],
        "bound_ms": kq["bound_ms"],
        "bound_by": kq["bound_by"],
        "library_ms": kq["library_ms"],
        "launches_by_phase": by_phase("quorum"),
    }] + [{
        "name": f"step_{kind}",
        "route": "cuda",
        "source": "ra_tpu_torch/csrc/step.cu",
        "replaces": replaces[kind],
        "launches": km["launches"][kind],
        "max_abs_err": ks[kind]["max_abs_err"],
        "ms": ks[kind]["ms"],
        "plain_ms": ks[kind]["plain_ms"],
        "bound_ms": ks[kind]["bound_ms"],
        "bound_by": ks[kind]["bound_by"],
        "library_ms": None,
        "launches_by_phase": by_phase(kind),
    } for kind in ("full", "sub")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
