#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ra_tpu_torch``) on one GPU and check it.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ra_tpu_torch/csrc/`` (one
``nvcc`` per source, all at once; the quorum library's SASS must hold no
local-memory instruction), holds each against its plain PyTorch
version on the card: the quorum scan (``quorum.cu``) bit for bit at
P = 1..8 over ragged G, unaligned views and the rows an nvcc miscompile
once got wrong, then timed at 10240 groups with P = 3, 5 and 7 (a call,
its host part, card time, bound, plain version, sort + gather) beside
the card's empty-launch floor and a scaling row of 4,194,304 groups (not
a deployment); and the fused step
kernels (``step.cu``, full width and active set) over edge inputs at
P = 1..16 and 33 (the register instances and the runtime-width one),
and at an odd G from an unaligned ring, against the plain torch-op step
on the card and on the CPU; a profile of 50 steps must show each step as
one launch of ``step_kernel`` and nothing else (no memset), and gives
the card time a step, beside the host part of a call (the launch
replaced by a no-op). Then it
runs the main path, the durable replicated write of the batch backend:
three ``BatchCoordinator``s hosting 10240 raft groups x 3 replicas over
WAL-backed logs, cooperative pipelined stepping, through the step
kernels, and checks that every command was committed and applied on all
three replicas. The same main path runs once more with the plain
torch-op step, for comparison within the run. Then phase api drives the
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
mode. Phase bench last runs the port's bench, ``python -m
ra_tpu_torch.bench``, each bench in a process of its own: the decision
bench (10240 groups x 200 steps through the step kernel), the durable
headline at the full 10240 groups x 3 replicas, WAL-backed, pipelined,
with its depth cut to ``BENCH_CMDS`` commands per group (the bench's
default is 96), and the read bench (lease on against the lease-off
control) at its defaults; every state check of the bench must hold, and
each bench's JSON line is printed. Then the operator tools run on the
card (``profile_wave`` at 2048 x 4, ``obs_smoke``, ``ra_top --demo``),
and the decision bench's loop on the step kernel is held against the
same loop on the plain step at 10240 groups. Phase mesh then drives the
multi-device path and the graft entry: ``graft_entry.entry()`` on the
card (its quorum scan through ``quorum.cu``) against the same on the
CPU; the step over four slices of the group axis on ``cuda:0`` against
the unsharded step kernel and the plain step at 10240 groups, chained,
with scatter rows at every slice edge and pads; ``graft_entry.dryrun_multichip(4)`` (its four
phases over a four-slice mesh on ``cuda:0``); and the main path's 10240
groups x 3 replicas, WAL-backed, through coordinators over a four-slice
mesh (four measured waves, as phase main), every command checked on all
three replicas, one step-kernel launch a slice a step and no active set.
One card makes a mesh slices of that card: this checks the path, not
scaling. Phase lane last runs the hand-stepped command-lane scenarios of
the JAX package's tests (a deposed leader's and a truncated command's
redirect in each active-set mode, the admission reject, the pipeline
window; ``tests/lane_cases.py``) on coordinators on the card, each
record equal to the port's CPU record of the same interleaving, the
active set launching the active-set kernel and ``never`` the full-width
one; the command-lane watchdog on the card in each mode; and the native
mailbox pack into the pinned buffers the coordinator uploads from,
byte for byte against the Python stores.

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
import re
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

# phase bench: the headline's commands per group (the bench's default
# is 96, about a quarter hour on the card: cut for the smoke's time),
# the steps of the decision loop held against the plain step's loop,
# and the shape of profile_wave
BENCH_CMDS = 4
DECISIONS_CHECK_STEPS = 10
PROFILE_WAVE = (2048, 4)
READS = (256, 60)  # the read bench's default groups and rounds

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


def sass_local_memory(so: str) -> dict:
    """Local-memory instructions (STL, LDL) of each kernel in the SASS of
    the built library ``so`` (``cuobjdump -sass``, beside ``nvcc``), by
    kernel (its mangled name)."""
    from ra_tpu_torch.ops import kernels

    tool = os.path.join(os.path.dirname(kernels.nvcc_path()), "cuobjdump")
    text = subprocess.run([tool, "-sass", so], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and re.search(r"\b(STL|LDL)(\.|\s)", line):
            counts[name] += 1
    return counts


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


# the shapes phase kernel holds bit for bit against the plain version at
# every P = 1..8: G around one tile of the kernel (64 groups), a large
# ragged G, the main path's G and G = 1
KERNEL_GS = (1, 63, 64, 65, 1001, 10237, 10240)
# input views at these element offsets into larger buffers (bases that are
# 4-byte or byte aligned, not 16-byte)
KERNEL_OFFSETS = ((1, 1, 1), (3, 5, 2))
# the timed rows: the main path's G at Ra's 3-, 5- and 7-replica groups
KERNEL_TIMED_PS = (3, 5, 7)
# the scaling row (not a deployment): G*(5P+8) = 96.5 MB, above the 50 MB L2
SCALING = (4194304, 3)


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


def miscompile_rows(p: int):
    """Rows whose largest entry sits last, each asking for an ascending
    position below P - 1: the case nvcc 12.8 got wrong at -O3 for a
    register select chain over the sorted row (it returned the last
    entry). Every position 0..P-2, entries in slot order and reversed."""
    rows, counts = [], []
    for pos in range(p - 1):
        for head in (np.arange(1, p), np.arange(p - 1, 0, -1)):
            rows.append(list(10 * head) + [10 * p])
            counts.append(2 * (p - 1 - pos))
    match = np.asarray(rows, np.int32).reshape(-1, p)
    return match, np.ones_like(match, bool), np.asarray(counts, np.int32)


def at_offset(torch, a, off: int, dev):
    """``a`` on ``dev`` as a view ``off`` elements into a larger buffer."""
    t = torch.from_numpy(a).to(dev)
    buf = torch.zeros(t.numel() + off, dtype=t.dtype, device=dev)
    view = buf[off:].view(t.shape)
    view.copy_(t)
    return view


def quorum_bound(g: int, p: int) -> tuple:
    """(bound ms, bound by, bytes, ops) of the scan over G groups of P:
    each input read once, the output written once, against the integer
    work of the rank pick."""
    nbytes = g * p * 4 + g * p * 1 + g * 4 + g * 4  # G*(5P+8)
    # per group: P masks, the clamp (4 ops), P*P pairs of two compares
    # and two adds, P tests (3 ops) and selects, P - 1 maxima
    nops = g * (p + 4 + 4 * p * p + 4 * p + p - 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / ALU_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, nops)


def host_part_quorum_ms(quorum, call, n: int = TIMED_CALLS,
                        warmup: int = 20) -> float:
    """The host part of an ``agreed_commit`` call: the median host-clock
    time of ``call()`` with the C entry called at G = 0, where it returns
    before launching (through a Python shim that then reports success)."""
    name = "ra_quorum_launch"
    real = quorum._kernel(name)

    def no_launch(m, v, nv, out, g, p, stream):
        return real(m, v, nv, out, 0, p, stream) and 0

    quorum._fns[name] = no_launch
    try:
        for _ in range(warmup):
            call()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            call()
            times.append(time.perf_counter() - t0)
    finally:
        quorum._fns[name] = real
    return statistics.median(times) * 1e3


def quorum_row(torch, quorum, rng, g: int, p: int, dev) -> dict:
    """Times of the scan over G groups of P: a call (median of event-
    bracketed calls), its host part, its card time (profiler, 50 calls),
    the bound and its share, the plain version and the library call
    (``torch.sort`` + ``gather`` over the masked matrix, the mask and
    positions prepared outside the timed call)."""
    m, v, nv = quorum_inputs(rng, g, p)
    tm, tv, tn = (torch.from_numpy(a).to(dev) for a in (m, v, nv))

    def call():
        return quorum.agreed_commit(tm, tv, tn)

    if not torch.equal(call(), quorum.agreed_commit_plain(tm, tv, tn)):
        raise AssertionError(f"quorum kernel != plain at G={g}, P={p}")
    bound_ms, bound_by, nbytes, nops = quorum_bound(g, p)
    _, dev_us = profile_kernels(torch, call, 50, ("quorum_kernel",))
    card_us = sum(dev_us.values())
    eff = torch.where(tv, tm, -1)
    pos = torch.clamp(p - 1 - torch.div(tn, 2, rounding_mode="floor"),
                      0, p - 1).long()[:, None]
    return {"g": g, "p": p, "ms": median_ms(call),
            "host_ms": host_part_quorum_ms(quorum, call), "card_us": card_us,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": nops, "bound_share": bound_ms * 1e3 / card_us,
            "plain_ms": median_ms(lambda: quorum.agreed_commit_plain(tm, tv, tn)),
            "library_ms": median_ms(
                lambda: torch.sort(eff, dim=-1).values.gather(-1, pos))}


def launch_floor(torch, quorum, g: int, dev) -> dict:
    """The card's empty-launch floor beside the scan: an empty kernel at
    the scan's grid for G, timed as a call is (events) and by the
    profiler."""
    fn = quorum._kernel("ra_quorum_empty_launch")
    stream = torch._C._cuda_getCurrentRawStream(dev.index)

    def call():
        if fn(g, stream) != 0:
            raise RuntimeError("empty kernel launch failed")

    _, dev_us = profile_kernels(torch, call, 50, ("empty_kernel",))
    return {"g": g, "ms": median_ms(call), "card_us": sum(dev_us.values())}


def phase_kernel(torch, quorum, dev) -> dict:
    """The quorum kernel against its plain version, bit for bit, at every
    P = 1..8 over ``KERNEL_GS`` (the miscompile rows appended at each G
    of 1001 and more), and at ``KERNEL_OFFSETS`` views; then its rows at
    the main path's G, the empty-launch floor and the scaling row."""
    rng = np.random.default_rng(1)
    max_err = 0
    shapes = 0
    for p in range(1, 9):
        for g in KERNEL_GS:
            m, v, nv = quorum_inputs(rng, g, p)
            if g >= 1001:
                bad = miscompile_rows(p)
                m, v, nv = (np.concatenate([x[:g - len(y)], y])
                            for x, y in zip((m, v, nv), bad))
            offsets = ((0, 0, 0),) + (KERNEL_OFFSETS if g in (1001, 10237) else ())
            for off in offsets:
                tm, tv, tn = (at_offset(torch, a, o, dev)
                              for a, o in zip((m, v, nv), off))
                launches = quorum.LAUNCHES
                got = quorum.agreed_commit(tm, tv, tn)
                ref = quorum.agreed_commit_plain(tm, tv, tn)
                torch.cuda.synchronize()
                if quorum.LAUNCHES != launches + 1:
                    raise AssertionError("agreed_commit did not count one launch")
                err = int((got.long() - ref.long()).abs().max().item())
                if not torch.equal(got, ref):
                    raise AssertionError(
                        f"quorum kernel != plain at G={g}, P={p}, offsets "
                        f"{off} (max err {err})")
                max_err = max(max_err, err)
                shapes += 1
    rows = {p: quorum_row(torch, quorum, rng, GROUPS, p, dev)
            for p in KERNEL_TIMED_PS}
    floor = launch_floor(torch, quorum, GROUPS, dev)
    scaling = quorum_row(torch, quorum, rng, *SCALING, dev)
    main = rows[PEERS]
    return {"shapes": shapes, "max_abs_err": max_err, "rows": rows,
            "floor": floor, "scaling": scaling,
            **{k: main[k] for k in ("ms", "host_ms", "plain_ms", "library_ms",
                                    "card_us", "bound_ms", "bound_by",
                                    "bytes")}}


def kernel_row_line(r: dict) -> str:
    return (f"G={r['g']} P={r['p']}: kernel {r['ms']:.6f} ms a call, host "
            f"part {r['host_ms']:.6f} ms (median host clock, C entry at "
            f"G = 0), card time {r['card_us']:.3f} us (profiler, 50 calls), "
            f"bound {r['bound_ms']:.9f} ms ({r['bound_by']}, {r['bytes']} B, "
            f"{r['ops']} ops), share of bound {r['bound_share']:.4f}, plain "
            f"{r['plain_ms']:.6f} ms, sort+gather {r['library_ms']:.6f} ms")


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
    the active set, per group passed through."""
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
    err = {"full": 0, "sub": 0}
    steps = {"full": 0, "sub": 0}
    launches0 = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
    advanced = False
    # (G, K, P, near_max, steps): every width at the main path's G and K,
    # then an odd G with K = 7 and an offset ring (unaligned tiles: the
    # kernel's plain staging path)
    runs = [(GROUPS, SUFFIX_K, p, near_max,
             6 if (p, near_max) == (PEERS, False) else 2)
            for p in STEP_WIDTHS for near_max in (False, True)]
    runs.append((GROUPS - 3, 7, PEERS, False, 4))
    for g, k, p, near_max, n_steps in runs:
        rng = np.random.default_rng(100 * p + near_max if g == GROUPS else g)
        fields = cases.state_fields(rng, g, p, k, near_max=near_max)
        s_dev = C.state_from_numpy(fields, dev)
        s_cpu = C.state_from_numpy(fields, "cpu")
        if k != SUFFIX_K:
            ring = torch.empty(g * k + 1, dtype=torch.int32, device=dev)
            ring = ring[1:].view(g, k)
            ring.copy_(s_dev.term_suffix)
            s_dev = s_dev._replace(term_suffix=ring)
        for i in range(n_steps):
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
                    f"{kind} step kernel != plain step at G={g}, K={k}, "
                    f"P={p}, near_max={near_max}, step {i} (max err {e})")
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
    g = GROUPS
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
    for kind, (kern, plain, packed, gi) in calls.items():
        nbytes, ops = step_bound(C, S, st, packed, gi, kern())
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / ALU_OPS_PER_S * 1e3
        # the card's own time for a step, without the host's gaps between
        # calls; a step must be one launch of step_kernel and nothing
        # else (no memset)
        launched, dev_us = profile_kernels(torch, kern, 50, ("step_kernel",))
        out[kind] = {
            "max_abs_err": err[kind], "ms": median_ms(kern),
            "host_ms": host_part_ms(S, kind, kern),
            "card_us": sum(dev_us.values()),
            "plain_ms": median_ms(plain),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops,
            "launched": launched,
        }
    return out


def profile_kernels(torch, fn, n: int, names: tuple) -> tuple:
    """Run ``fn()`` ``n`` times under ``torch.profiler`` after a warm-up
    cycle, and return (launches by kernel name, card microseconds per
    call by kernel name). Every kernel must carry one of ``names`` (a
    memset or any other launch fails at once), and each of ``names`` is
    launched ``n`` times. The profiler on the H100 now and then drops
    kernel records (49 of 50, or all), so a profile that is short of
    launches is taken again, up to three times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule

    for _ in range(3):
        seen = []
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     on_trace_ready=lambda p: seen.extend(p.key_averages())
                     ) as prof:
            for cycle in range(2):
                for _ in range(n if cycle else 5):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in seen if e.device_type == DeviceType.CUDA
                  and not e.key.startswith("ProfilerStep")]
        launched = {e.key: e.count for e in events}
        foreign = [k for k in launched if not any(m in k for m in names)]
        if foreign:
            raise AssertionError(
                f"{n} calls launched {launched}: {foreign} is not one of {names}")
        if all(sum(c for k, c in launched.items() if m in k) == n
               for m in names):
            return launched, {
                e.key: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / n
                for e in events}
    raise AssertionError(
        f"{n} calls: three profiles short of {n} launches of each of "
        f"{names} (last {launched})")


def host_part_ms(S, kind: str, kern, n: int = TIMED_CALLS,
                 warmup: int = 20) -> float:
    """The host part of a step call: the median host-clock time of
    ``kern()`` with the C launcher swapped for its twin that builds the
    same arguments and launches nothing."""
    name = f"ra_step_{kind}_launch"
    real = S._kernel(name)
    S._fns[name] = S._kernel(f"ra_step_{kind}_host_only")
    try:
        for _ in range(warmup):
            kern()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            kern()
            times.append(time.perf_counter() - t0)
    finally:
        S._fns[name] = real
    return statistics.median(times) * 1e3


# ---------------------------------------------------------------------------
# phase 4: the main path


def open_storage(coords, node_names, workdir: str, storage: list) -> None:
    """Give each coordinator its node's shared WAL and segment writer
    under ``workdir/<node>``, appended to ``storage`` as (tables, wal,
    dir), the form ``bench.wal_logs`` takes, so that the caller closes
    what was opened (the segment writer is the WAL's)."""
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
        storage.append((tables, w, d))


def state_tensors(C, state) -> list:
    """Every tensor of a coordinator's state, of each slice when the
    state is cut over a mesh."""
    shards = state.shards if isinstance(state, C.ShardedState) else (state,)
    return [f for st in shards for f in st]


def phase_main(torch, C, S, dev, workdir: str, tag: str,
               use_kernels: bool = True, mesh=None) -> dict:
    """The main path with coordinators named ``tag``0..2: through the
    step kernels, or (``use_kernels=False``) through the plain torch-op
    step for comparison; with ``mesh`` (a device list) each
    coordinator's groups are cut into that many slices, each stepped at
    full width (one step-kernel launch a slice a step, no active set)."""
    from ra_tpu_torch import bench, obs
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
    where = {"mesh": mesh} if mesh else {"device": dev}
    slices = len(mesh) if mesh else 1
    t_setup = time.perf_counter()
    coords = [
        BatchCoordinator(n, capacity=g_n, num_peers=PEERS,
                         suffix_k=SUFFIX_K, idle_sleep_s=0, **where)
        for n in node_names
    ]
    storage = []
    try:
        open_storage(coords, node_names, workdir, storage)
        logs = bench.wal_logs(storage, g_n)
        members = lambda g: [(f"g{g}", n) for n in node_names]  # noqa: E731
        for i, c in enumerate(coords):
            c.add_groups([
                (f"g{g}", f"cl{g}", members(g), BenchMachine(), logs[i][g])
                for g in range(g_n)
            ])
        for c in coords:
            for f in state_tensors(C, c.state):
                if f.device != dev:
                    raise AssertionError(f"coordinator state is not on {dev}")
        t_setup = time.perf_counter() - t_setup

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
        # the floor below is exact once every replica has applied its
        # leader's election noop (index 1 of the fresh logs): a settle
        # can end while a noop's WAL write is still in flight
        while not all((c._applied_np[:g_n] >= 1).all() for c in coords):
            if time.time() > deadline:
                raise TimeoutError("election noops not applied")
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
                off = np.flatnonzero(applied != base[0] + done[0])
                st = C.state_to_numpy(c.state)
                raise AssertionError(
                    f"coordinator {i}: applied index off in {len(off)} "
                    f"groups (first {off[:8].tolist()}): applied - floor "
                    f"{(applied[off] - base[0][off]).tolist()[:8]}, want "
                    f"{done[0]}; term {st['current_term'][off].tolist()[:8]}, "
                    f"commit {st['commit_index'][off].tolist()[:8]}, machine "
                    f"{[c.by_name[names[g]].machine_state for g in off[:8]]}")
            ms = np.array([c.by_name[n].machine_state for n in names])
            if not (ms == done[0]).all():
                raise AssertionError(
                    f"coordinator {i}: machine state off "
                    f"(min {ms.min()}, max {ms.max()}, want {done[0]})")
            dev_commit = C.state_to_numpy(c.state)["commit_index"][:g_n]
            if not (dev_commit >= applied).all():
                raise AssertionError(f"coordinator {i}: commit below apply")
            for f in state_tensors(C, c.state):
                if f.device != dev:
                    raise AssertionError(f"coordinator state left {dev}")
        steps = sum(c.steps for c in coords) - counted0[0]
        sub_steps = sum(c.sub_steps for c in coords) - counted0[1]
        if mesh and sub_steps:
            raise AssertionError(f"{sub_steps} active-set steps over a mesh")
        if use_kernels:
            # every step launched its kernel (once a slice), and no step
            # took the plain route (whose quorum scan would launch
            # quorum.cu)
            if (launches["full"], launches["sub"]) != (
                    slices * (steps - sub_steps), sub_steps):
                raise AssertionError(
                    f"step kernel launches {launches} != {slices} x steps "
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
            "setup_s": t_setup,
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
        for _tables, w, _d in storage:
            w.close()
            w.segment_writer.close()


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

    from ra_tpu_torch import api, bench, leaderboard
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
        logs = bench.wal_logs(storage, g_n)
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
        for _tables, w, _d in storage:
            w.close()
            w.segment_writer.close()
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

    def host(n):
        return coords[n].by_name["srg"]

    def leads(n, followers):
        # n leads in its own view and every one of `followers` has taken
        # its lead: same term, leader slot n (the members are listed in
        # one order on every node, so slot i is sr<i> everywhere)
        h = host(n)
        return h.role == C.R_LEADER and all(
            host(f).term == h.term and host(f).leader_slot == h.self_slot
            for f in followers)

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
        await_(lambda: host("sr0").role == C.R_LEADER, "sr0 leads")

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
        # the stale read needs sr0 to hold the lead with (0, 1) applied
        # when it is cut off, and no election in flight: wait until
        # sr1 and sr2 follow it in its term
        await_(lambda: leads("sr0", ("sr1", "sr2"))
               and host("sr0").machine_state.get("k") == (0, 1),
               "sr0 leads, followed by sr1 and sr2, with (0, 1) applied")
        # the leader is cut off; either majority member may take over
        for o in ("sr1", "sr2"):
            coords["sr0"].transport.block("sr0", o)
            coords[o].transport.block(o, "sr0")
        coords["sr1"].deliver(ids[1], ElectionTimeout(), None)
        # wait until the other majority member follows the new leader:
        # a member that still names sr0 would redirect a write to the
        # cut-off node, where it cannot commit
        majority = {"sr1": ("sr2",), "sr2": ("sr1",)}
        await_(lambda: any(leads(n, f) for n, f in majority.items()),
               "majority side takes over, followed by its other member")
        new_leader = next(n for n, f in majority.items() if leads(n, f))
        write((0, 2), ("srg", new_leader))
        # sr0 cannot hear of the new term: it still leads in its own view
        await_(lambda: host("sr0").role == C.R_LEADER, "sr0 still leads")
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


# ---------------------------------------------------------------------------
# phase 7: the port's bench and operator tools, each in its own process


def run_module(args, timeout: float) -> subprocess.CompletedProcess:
    """``python -m <args>`` from this checkout; raises unless it exits 0
    within ``timeout`` seconds (the child is killed at the timeout)."""
    proc = subprocess.run([sys.executable, "-m", *args], cwd=HERE,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise AssertionError(
            f"python -m {' '.join(args)} exited {proc.returncode}:\n"
            f"{proc.stderr[-4000:]}")
    return proc


def last_json(proc) -> dict:
    """The JSON object a bench prints as its last line."""
    return json.loads(proc.stdout.strip().splitlines()[-1])


# (label, arguments of ra_tpu_torch.bench, timeout s)
BENCH_RUNS = (
    ("decisions", ["--decisions"], 300),
    ("headline", ["--cmds", str(BENCH_CMDS)], 600),
    ("reads", ["--reads", "--groups", str(READS[0]), "--cmds", str(READS[1])],
     300),
)


def phase_bench(torch, C, S, dev) -> dict:
    """The three benches and the three tools, each a fresh process on
    ``dev``, with their checks; then the decision loop on the step
    kernel against the same loop on the plain step, here."""
    from ra_tpu_torch import bench

    name = f"{dev.type}:{dev.index or 0}" if dev.type == "cuda" else dev.type
    out = {"benches": {}, "tools": {}}
    for label, args, timeout in BENCH_RUNS:
        t = time.perf_counter()
        res = last_json(run_module(
            ["ra_tpu_torch.bench", *args, "--device", name], timeout))
        out["benches"][label] = res
        out.setdefault("seconds", {})[label] = time.perf_counter() - t
    dec, head, reads = (out["benches"][k]
                        for k in ("decisions", "headline", "reads"))
    if dec["kernel_launches"] != {"step_full": 3 * dec["steps"],
                                  "step_sub": 0, "quorum_scan": 0}:
        raise AssertionError(
            f"decision bench launches {dec['kernel_launches']}: want one "
            f"step kernel launch per step in each of its 3 runs")
    if head["passes_completed"] != 3:
        raise AssertionError(
            f"headline completed {head['passes_completed']} of 3 passes")
    if head["admitted_cmds_per_sec"] is None:
        raise AssertionError("headline: the admission-paced pass timed out")
    hl = head["kernel_launches"]
    if hl["step_full"] <= 0 or hl["step_sub"] <= 0 or hl["quorum_scan"]:
        raise AssertionError(f"headline launches {hl}: want both step "
                             f"kernels and no quorum.cu")
    if reads["kernel_launches"]["quorum_scan"]:
        raise AssertionError("read bench launched quorum.cu")
    if reads["lease_off"]["read_lease_served"]:
        raise AssertionError("the lease-off arm served reads by lease")
    for arm in ("lease_on", "lease_off"):
        if reads[arm]["reads"] != READS[0] * READS[1]:
            raise AssertionError(f"read bench {arm}: {reads[arm]['reads']} reads")

    # the operator tools
    from ra_tpu_torch import obs

    t = time.perf_counter()
    g, n = PROFILE_WAVE
    proc = run_module(["ra_tpu_torch.profile_wave", str(g), str(n),
                       "--top", str(len(obs.WAVE_PHASES)), "--device", name],
                      600)
    table = proc.stdout.split("### Wave-phase cost attribution")[1]
    rows = [ln for ln in table.split("###")[0].splitlines()
            if ln.startswith("| ") and ln[2].isdigit()]
    missing = [ph for ph, _ in obs.WAVE_STEP_PHASES
               if not any(f"| {ph} |" in r for r in rows)]
    if missing:
        raise AssertionError(f"profile_wave table lacks {missing}:\n{table}")
    out["tools"]["profile_wave"] = {
        "s": time.perf_counter() - t, "rows": rows,
        "summary": [ln for ln in proc.stderr.splitlines()
                    if ln.startswith("total wall")]}
    t = time.perf_counter()
    proc = run_module(["ra_tpu_torch.obs_smoke", "--device", name], 600)
    if "obs_smoke: PASS" not in proc.stderr:
        raise AssertionError(f"obs_smoke did not pass:\n{proc.stderr[-4000:]}")
    out["tools"]["obs_smoke"] = {
        "s": time.perf_counter() - t,
        "summary": [ln for ln in proc.stderr.splitlines()
                    if ln.startswith("obs_smoke:")]}
    t = time.perf_counter()
    proc = run_module(["ra_tpu_torch.ra_top", "--demo", "--device", name,
                       "-n", "2"], 300)
    panels = [ln for ln in proc.stdout.splitlines()
              if ln.startswith("== ra_top · ")]
    if len(panels) != 2:
        raise AssertionError(f"ra_top --demo printed {len(panels)} panels")
    out["tools"]["ra_top"] = {"s": time.perf_counter() - t, "panels": panels}

    # the decision loop on the step kernel against the plain step's loop
    steps = DECISIONS_CHECK_STEPS
    n0 = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
    st_k, sums_k = bench.decisions_loop(GROUPS, steps, dev)
    if (S.LAUNCHES_FULL - n0[0], S.LAUNCHES_SUB - n0[1]) != (steps, 0):
        raise AssertionError("the decision loop did not run the step kernel")
    st_p, sums_p = bench.decisions_loop(
        GROUPS, steps, dev, step=C.consensus_step_packed_scat_plain)
    torch.cuda.synchronize()
    err = int((sums_k - sums_p).abs().max().item())
    for f, a, b in zip(C.GroupState._fields, st_k, st_p):
        e = int((a.long() - b.long()).abs().max().item()) if a.numel() else 0
        if not torch.equal(a, b):
            raise AssertionError(
                f"decision loop: kernel != plain step in {f} (max err {e})")
        err = max(err, e)
    if err or not torch.equal(sums_k, sums_p):
        raise AssertionError("decision loop: success sums differ")
    out["decisions_check"] = {"steps": steps, "max_abs_err": err,
                              "success": sums_k.tolist()}
    return out


def bench_launches(kb: dict, kind: str) -> int:
    """Launches of kernel ``kind`` summed over the three bench processes."""
    key = {"full": "step_full", "sub": "step_sub", "quorum": "quorum_scan"}[kind]
    return sum(b["kernel_launches"][key] for b in kb["benches"].values())


# ---------------------------------------------------------------------------
# phase 8: the multi-device path and the graft entry

MESH_SLICES = 4  # slices of a coordinator's group axis, all on cuda:0
MESH_STEPS = 6  # chained sharded steps held against the unsharded kernel


def step_fields(C, state, egress) -> dict:
    """A step result on the host: every state field and egress row (a
    packed (17, G) array or an ``Egress``), by name."""
    out = {f"state.{k}": v for k, v in C.state_to_numpy(state).items()}
    if isinstance(egress, C.Egress):
        out.update({f"egress.{k}": v.cpu().numpy()
                    for k, v in egress._asdict().items()})
    else:
        out["egress"] = egress
    return out


def fields_max_err(a: dict, b: dict) -> int:
    if a.keys() != b.keys():
        raise AssertionError(f"fields differ: {sorted(a.keys() ^ b.keys())}")
    return int(max(np.abs(a[k].astype(np.int64) - b[k].astype(np.int64)).max()
                   if a[k].size else 0 for k in a))


def seam_round_trip_ms(torch, C, dev, whole, sharded, packed,
                       n: int = TIMED_CALLS) -> dict:
    """Median host milliseconds of one full-width step through each
    device seam, from the host mailbox to the egress on the host (upload
    or split and upload, the step, the egress fetch, its realisation),
    unsharded and over the mesh's slices, and of ``split_mailbox``
    alone; the same state and mailbox every call."""
    from ra_tpu_torch.runtime.device import DeviceSeam, ShardedSeam

    one = DeviceSeam(dev)
    buf = one.mbox_buffer(*packed.shape)
    buf[:] = packed
    mesh = ShardedSeam([dev] * len(sharded.shards))
    g, p = whole.match_index.shape
    mesh.init_state(g, p, whole.term_suffix.shape[1])  # sets the slice width

    def trip(seam, state, mbox):
        def run():
            seam.realise(seam.start_fetch(seam.step_full(state, mbox)[1]))
        return run

    def host_median(fn):
        for _ in range(20):
            fn()
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    stage = np.empty((len(sharded.shards),) + (packed.shape[0],
                                               sharded.shard_groups), np.int32)
    return {"one": host_median(trip(one, whole, buf)),
            "sharded": host_median(trip(mesh, sharded, packed)),
            "split": host_median(
                lambda: C.split_mailbox(packed, len(sharded.shards), stage))}


def phase_mesh(torch, C, S, dev, workdir: str) -> dict:
    """(a) ``graft_entry.entry()`` on the card against the CPU, its
    quorum scan through ``quorum.cu``; (b) the step over ``MESH_SLICES``
    slices on the card against the unsharded step kernel, chained over
    edge inputs with scatter rows at every slice edge and pads; (c)
    ``graft_entry.dryrun_multichip(MESH_SLICES)`` on the card; (d) the
    main path's shape through coordinators over a mesh of
    ``MESH_SLICES`` slices. Launches of (a), (c) and (d) are the phase's
    (their entry points drive the path); (b)'s are a comparison."""
    import contextlib
    import io

    from ra_tpu_torch import graft_entry

    cases = step_cases()
    Q = C.quorum

    def zero():
        S.LAUNCHES_FULL = S.LAUNCHES_SUB = Q.LAUNCHES = 0

    def counts():
        return {"full": S.LAUNCHES_FULL, "sub": S.LAUNCHES_SUB,
                "quorum": Q.LAUNCHES}

    out = {"launches": {}, "device": str(dev)}
    # (a) the graft entry: one step on the card, one on the CPU
    zero()
    fn, args = graft_entry.entry()
    if args[0].role.device != dev:
        raise AssertionError(f"entry() placed its state on {args[0].role.device}")
    got = step_fields(C, *fn(*args))
    torch.cuda.synchronize()
    out["launches"]["entry"] = counts()
    fn, args = graft_entry.entry("cpu")
    want = step_fields(C, *fn(*args))
    out["entry_max_abs_err"] = fields_max_err(got, want)
    if out["entry_max_abs_err"]:
        raise AssertionError(
            f"entry() on the card != on the CPU (max err "
            f"{out['entry_max_abs_err']})")
    if out["launches"]["entry"] != {"full": 0, "sub": 0, "quorum": 1}:
        raise AssertionError(
            f"entry() launches {out['launches']['entry']}: want quorum.cu once")

    # (b) the sharded step against the unsharded step kernel and the
    # plain step (on the card and on the CPU), all from one state
    g, n = GROUPS, MESH_SLICES
    rng = np.random.default_rng(8)
    fields = cases.state_fields(rng, g, PEERS, SUFFIX_K)
    whole = C.state_from_numpy(fields, dev)
    sharded = C.split_state(whole, [dev] * n)
    zero()
    err = 0
    for i in range(MESH_STEPS):
        host = C.state_to_numpy(whole)
        packed = cases.shard_edges(
            rng, host, cases.packed(rng, host, np.arange(g), g), n)
        on_dev = torch.from_numpy(packed).to(dev)
        plain_dev = C.consensus_step_packed_scat_plain(whole, on_dev)
        plain_cpu = C.consensus_step_packed_scat_plain(
            C.state_from_numpy(host, "cpu"), torch.from_numpy(packed))
        whole, eg = C.consensus_step_packed_scat(whole, on_dev)
        sharded, egs = C.consensus_step_packed_scat_sharded(
            sharded, [torch.from_numpy(p).to(dev)
                      for p in C.split_mailbox(packed, n)])
        got = step_fields(C, sharded,
                          C.join_egress([x.cpu().numpy() for x in egs]))
        for name, ref in (("the unsharded step kernel", (whole, eg)),
                          ("the plain step on the card", plain_dev),
                          ("the plain step on the CPU", plain_cpu)):
            e = fields_max_err(step_fields(C, ref[0], ref[1].cpu().numpy()),
                               got)
            if e:
                raise AssertionError(
                    f"sharded step != {name} at step {i} (max err {e})")
            err = max(err, e)
    # the plain step on the card scans its quorum through quorum.cu
    if counts() != {"full": MESH_STEPS * (n + 1), "sub": 0,
                    "quorum": MESH_STEPS}:
        raise AssertionError(f"sharded step launches {counts()}: want one "
                             f"step-kernel launch a slice a step")
    out["sharded_max_abs_err"] = err
    out["seam_ms"] = seam_round_trip_ms(torch, C, dev, whole, sharded, packed)

    # (c) the graft entry's dryrun over MESH_SLICES slices on the card
    zero()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(n)
    lines = buf.getvalue().splitlines()
    phases = [line for line in lines if line.startswith("phase ")]
    if len(phases) != 4 or not lines[-1].startswith(
            f"dryrun_multichip ok: {n} slices on 1 distinct device(s) "
            f"({dev.type})"):
        raise AssertionError(f"dryrun_multichip: {lines}")
    out["dryrun"] = lines
    out["launches"]["dryrun"] = counts()
    c = out["launches"]["dryrun"]
    if c["full"] <= 0 or c["full"] % n or c["sub"] or c["quorum"]:
        raise AssertionError(f"dryrun launches {c}: want {n} step-kernel "
                             f"launches a step and nothing else")

    # (d) the main path's shape through a mesh (phase_main zeroes the
    # counts just before it drives the path and reads them just after)
    r = phase_main(torch, C, S, dev, workdir, "mesh_", mesh=[dev] * n)
    out["main"] = r
    out["launches"]["main"] = r["launches"]
    out["launches"]["phase"] = {
        k: sum(out["launches"][part][k] for part in ("entry", "dryrun", "main"))
        for k in ("full", "sub", "quorum")}
    return out


def mesh_line(kx: dict, card: str) -> str:
    r = kx["main"]
    return (
        f"(a) entry() on {kx['device']} == on the CPU in every state field and "
        f"egress field (max_abs_err {kx['entry_max_abs_err']}), launches "
        f"{kx['launches']['entry']}; (b) {MESH_SLICES} slices == the "
        f"unsharded step kernel and the plain step (card and CPU) over "
        f"{MESH_STEPS} chained steps at "
        f"G={GROUPS} with scatter rows at every slice edge (max_abs_err "
        f"{kx['sharded_max_abs_err']}); a step through the device seam, "
        f"host mailbox to host egress (median of {TIMED_CALLS}, host "
        f"clock): unsharded {kx['seam_ms']['one']:.6f} ms, {MESH_SLICES} "
        f"slices {kx['seam_ms']['sharded']:.6f} ms, of which the mailbox "
        f"split {kx['seam_ms']['split']:.6f} ms; (c) dryrun_multichip({MESH_SLICES}): "
        f"{kx['dryrun'][-1]}, launches {kx['launches']['dryrun']}; (d) main "
        f"path over {MESH_SLICES} slices on {kx['device']}: set-up "
        f"{r['setup_s']:.3f} "
        f"s; {main_line(r, card)}")


# ---------------------------------------------------------------------------
# phase 9: the command-lane scenarios on the card


def lane_cases():
    """The command-lane scenarios and the pack corpus shared with the CPU
    tests (``tests/lane_cases.py``, numpy only)."""
    tests = os.path.join(HERE, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    import lane_cases as L

    return L


LANE_CAP = 8  # the pack fuzz's mailbox width, as tests/test_native_runtime.py


def first_difference(a, b, path="record"):
    """Where two records first differ, for the error message."""
    if isinstance(a, dict) and isinstance(b, dict) and a.keys() == b.keys():
        for k in a:
            if a[k] != b[k]:
                return first_difference(a[k], b[k], f"{path}[{k!r}]")
    if (isinstance(a, (list, tuple)) and isinstance(b, (list, tuple))
            and len(a) == len(b)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
    return f"{path}: card {a!r}, cpu {b!r}"


def phase_lane(torch, C, S, dev) -> dict:
    """The deterministic command-lane scenarios of
    ``tests/test_command_lane.py`` (both redirects in each active-set
    mode, the admission reject, the pipeline window) on coordinators on
    ``dev``, each record held against the port's CPU record of the same
    interleaving, run in this process (tier-1 holds that CPU record
    against the JAX package); ``always`` must launch the active-set
    kernel and ``never`` the full-width one. Then the watchdog in each
    mode on ``dev`` with the original's assertions, and the native
    mailbox pack fuzz into the pinned buffers a coordinator on ``dev``
    uploads from, against the Python column stores. Any difference or
    missing launch raises."""
    L = lane_cases()
    card = L.Lane("ra_tpu_torch", dev)
    cpu = L.Lane("ra_tpu_torch", "cpu")
    runs = [(n, m) for n in L.MODED for m in L.MODES]
    runs += [("admission_reject", "auto"), ("pipeline_window", "auto")]
    out = {"cases": {}, "watchdog": {}}
    S.LAUNCHES_FULL = S.LAUNCHES_SUB = C.quorum.LAUNCHES = 0
    for name, mode in runs:
        flow = L.DETERMINISTIC[name]
        before = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
        got = flow(card, mode)
        torch.cuda.synchronize()
        full, sub = (S.LAUNCHES_FULL - before[0], S.LAUNCHES_SUB - before[1])
        want = flow(cpu, mode)
        if (S.LAUNCHES_FULL, S.LAUNCHES_SUB) != (before[0] + full,
                                                 before[1] + sub):
            raise AssertionError("the CPU run launched a step kernel")
        if got != want:
            raise AssertionError(f"phase lane, {name} ({mode}): "
                                 f"{first_difference(got, want)}")
        if mode == "always" and (sub == 0 or full != 0):
            raise AssertionError(f"phase lane, {name} (always): launches "
                                 f"full {full}, sub {sub}")
        if mode == "never" and (full == 0 or sub != 0):
            raise AssertionError(f"phase lane, {name} (never): launches "
                                 f"full {full}, sub {sub}")
        if full + sub == 0:
            raise AssertionError(f"phase lane, {name} ({mode}): no launch")
        out["cases"][f"{name}/{mode}"] = {"full": full, "sub": sub}
    for mode in L.MODES:
        before = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
        out["watchdog"][mode] = L.watchdog(card, mode)
        out["watchdog"][mode]["launches"] = {
            "full": S.LAUNCHES_FULL - before[0],
            "sub": S.LAUNCHES_SUB - before[1]}
    out["launches"] = {"full": S.LAUNCHES_FULL, "sub": S.LAUNCHES_SUB,
                       "quorum": C.quorum.LAUNCHES}
    # the native pack into the pinned mailbox of a coordinator on dev
    c_nat = card.coord("lnpk0", capacity=LANE_CAP, num_peers=1,
                       idle_sleep_s=0, native="pack")
    c_off = card.coord("lnpk1", capacity=LANE_CAP, num_peers=1,
                       idle_sleep_s=0, native="off")
    try:
        if not c_nat._nat_pack:
            raise AssertionError("the native pack library did not load")
        pinned = []

        def buffer(rows, width):
            buf = c_nat._dev.mbox_buffer(rows, width)
            pinned.append(torch.from_numpy(buf).is_pinned())
            return buf

        L.pack_fuzz(card, c_nat, c_off, LANE_CAP, buffer=buffer)
        if not all(pinned):
            raise AssertionError("a pack buffer was not pinned")
        nat = c_nat.counters.get("native_pack_batches")
        if nat == 0 or c_nat.counters.get("native_fallbacks"):
            raise AssertionError(
                f"native pack batches {nat}, fallbacks "
                f"{c_nat.counters.get('native_fallbacks')}")
        out["pack"] = {"trials": L.PACK_TRIALS, "pinned": len(pinned),
                       "native_batches": nat}
    finally:
        c_nat.stop()
        c_off.stop()
    return out


def lane_line(kl: dict, card: str) -> str:
    wd = "; ".join(
        f"{m}: {r['verdict']}, lane_wedges {r['lane_wedges']}, "
        f"lane_recoveries {r['lane_recoveries']}, launches {r['launches']}"
        for m, r in kl["watchdog"].items())
    return (
        f"{len(kl['cases'])} hand-stepped scenarios on the card == the CPU "
        f"record (launches by scenario {json.dumps(kl['cases'])}); "
        f"watchdog {wd}; native pack into {kl['pack']['pinned']} pinned "
        f"mailboxes == the Python stores byte for byte over "
        f"{kl['pack']['trials']} corpora ({kl['pack']['native_batches']} "
        f"native batches); kernel launches in the phase {kl['launches']} "
        f"| {card}")


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
    local = {n: sass_local_memory(kernels.build(n)) for n in names}
    log(f"phase device: local-memory instructions (STL/LDL) in the SASS by "
        f"kernel: {json.dumps(local)}")
    if any(local["quorum"].values()):
        raise AssertionError(
            f"quorum_kernel's SASS uses local memory: {local['quorum']}")

    # phase 2: the quorum kernel against its plain version
    t = time.perf_counter()
    kq = phase_kernel(torch, quorum, dev)
    log(f"phase kernel: quorum_scan == plain bit for bit on {kq['shapes']} "
        f"shapes: P = 1..8 at G = {KERNEL_GS}, miscompile rows included, "
        f"and views at offsets {KERNEL_OFFSETS} (max_abs_err "
        f"{kq['max_abs_err']}) | {card} | {time.perf_counter() - t:.2f} s")
    for p in KERNEL_TIMED_PS:
        log(f"phase kernel, {kernel_row_line(kq['rows'][p])} | {card}")
    fl = kq["floor"]
    log(f"phase kernel, empty-launch floor at the grid of G={fl['g']}: "
        f"{fl['ms']:.6f} ms a call (events), card time {fl['card_us']:.3f} us "
        f"(profiler, 50 calls) | {card}")
    log(f"phase kernel, scaling, not a deployment: "
        f"{kernel_row_line(kq['scaling'])} | {card}")

    # phase 3: the step kernels against the plain step, card and CPU
    t = time.perf_counter()
    ks = phase_step(torch, C, S, dev)
    log(f"phase step: step kernels == plain step (on cuda and on cpu) in "
        f"every state field and egress row over {ks['steps']} packed steps "
        f"with edge inputs at G={GROUPS}, P={STEP_WIDTHS}, K={SUFFIX_K} and "
        f"at G={GROUPS - 3}, P={PEERS}, K=7 from an offset ring "
        f"(max_abs_err full {ks['full']['max_abs_err']}, sub "
        f"{ks['sub']['max_abs_err']}) | {time.perf_counter() - t:.2f} s")
    for kind in ("full", "sub"):
        r = ks[kind]
        log(f"phase step, {kind} at G={GROUPS} P={PEERS} K={SUFFIX_K}"
            f"{'' if kind == 'full' else f' S={SUB_CAP} ({SUB_REAL} real)'}: "
            f"kernel {r['ms']:.6f} ms a call, plain {r['plain_ms']:.6f} ms "
            f"(medians of {TIMED_CALLS} event-bracketed calls); host part "
            f"{r['host_ms']:.6f} ms (median host clock, launch replaced by "
            f"a no-op); card part {r['card_us']:.3f} us a step (profiler, "
            f"50 steps: {r['launched']}); bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']}, {r['bytes']} B, {r['ops']} ops) | {card}")

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

    # phase 7: the port's bench and operator tools, each in a process of
    # its own (within one process the first run of a pair is faster)
    t = time.perf_counter()
    kb = phase_bench(torch, C, S, dev)
    for label, res in kb["benches"].items():
        log(f"phase bench, {label} ({kb['seconds'][label]:.2f} s): "
            f"{json.dumps(res)} | {card}")
    for label, res in kb["tools"].items():
        log(f"phase bench, {label}: {json.dumps(res)} | {card}")
    log(f"phase bench: decision loop at G={GROUPS}, "
        f"{kb['decisions_check']['steps']} steps: step kernel == plain step "
        f"in every state field and success sum (max_abs_err "
        f"{kb['decisions_check']['max_abs_err']}) | "
        f"{time.perf_counter() - t:.2f} s")

    # phase 8: the multi-device path (a coordinator's groups in slices,
    # all on this card) and the graft entry
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="ra_smoke_mesh_")
    try:
        kx = phase_mesh(torch, C, S, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase mesh: {mesh_line(kx, card)} | {time.perf_counter() - t:.2f} s")

    # phase 9: the command-lane scenarios, the watchdog and the native
    # pack into pinned memory, on the card
    t = time.perf_counter()
    kl = phase_lane(torch, C, S, dev)
    log(f"phase lane: {lane_line(kl, card)} | "
        f"{time.perf_counter() - t:.2f} s")
    log(f"total {time.perf_counter() - t_all:.2f} s")

    replaces = {"full": "ra_tpu/ops/consensus.py:693",
                "sub": "ra_tpu/ops/consensus.py:703"}

    def by_phase(kind):
        return {"main": km["launches"][kind], "api": ka["launches"][kind],
                "harness": kh["launches"][kind],
                "bench": bench_launches(kb, kind),
                "mesh": kx["launches"]["phase"][kind],
                "lane": kl["launches"][kind]}

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
        "host_ms": kq["host_ms"],
        "card_us": kq["card_us"],
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
        "host_ms": ks[kind]["host_ms"],
        "card_us": ks[kind]["card_us"],
        "launches_by_phase": by_phase(kind),
    } for kind in ("full", "sub")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
