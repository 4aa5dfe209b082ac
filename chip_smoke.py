#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``ra_tpu_torch``) on one GPU and check it.

Run from the root of the repository, on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the hand-written CUDA kernels from ``ra_tpu_torch/csrc/``,
holds each against its plain PyTorch version on the card, holds the
fused consensus step on the card against the same step on the CPU, then
runs the main path — the durable replicated write of the batch backend:
three ``BatchCoordinator``s hosting 10240 raft groups x 3 replicas over
WAL-backed logs, cooperative pipelined stepping — and checks that every
command was committed and applied on all three replicas.

Phases print one line each (and their elapsed time). The line before
the last is a JSON object ``{"kernels": [...]}`` with each kernel's
launches on the main path, its parity result and its times; the last
line is ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that last line. Without CUDA it exits non-zero at once.
It imports nothing of JAX and nothing of the ``ra_tpu`` package.
"""

from __future__ import annotations

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
# phase 3: the fused step on the card against the step on the CPU


def random_state_fields(rng, g: int, p: int, k: int) -> dict:
    """A seeded, internally consistent state: tails inside the term ring,
    ascending terms, some leaders with followers' replies in flight."""
    snap = rng.integers(0, 20, g)
    tail = rng.integers(0, k - 1, g)
    last = snap + tail
    snap_term = rng.integers(1, 3, g)
    suffix = np.zeros((g, k), np.int32)
    term = snap_term.copy()
    for off in range(k - 1):
        idx = snap + 1 + off
        live = idx <= last
        term = term + ((rng.random(g) < 0.3) & live)
        suffix[np.arange(g)[live], (idx % k)[live]] = term[live]
    last_term = np.where(tail > 0, term, snap_term)
    cur = last_term + rng.integers(0, 2, g)
    commit = np.minimum(snap + rng.integers(0, 4, g), last)
    written = np.clip(last - rng.integers(0, 3, g), snap, None)
    role = rng.choice([0, 1, 2, 3], size=g, p=[0.4, 0.1, 0.1, 0.4])
    self_slot = rng.integers(0, p, g)
    voting = rng.random((g, p)) < 0.9
    voting[np.arange(g), self_slot] = True
    match = np.minimum(rng.integers(0, 40, (g, p)), last[:, None])
    return {
        "current_term": cur, "voted_for": rng.integers(-1, p, g),
        "commit_index": commit, "last_applied": commit,
        "last_index": last, "last_term": last_term,
        "written_index": written, "snapshot_index": snap,
        "snapshot_term": snap_term, "role": role,
        "leader_slot": np.where(role == 3, self_slot, -1),
        "self_slot": self_slot, "machine_version": rng.integers(0, 2, g),
        "match_index": match, "next_index": match + 1,
        "voting": voting, "active": np.ones((g, p), bool),
        "votes": rng.random((g, p)) < 0.3,
        "pre_votes": rng.random((g, p)) < 0.3,
        "term_suffix": suffix, "unknown_lo": np.ones(g),
        "unknown_hi": np.zeros(g), "pre_vote_token": rng.integers(0, 3, g),
    }


def random_packed(rng, C, st: dict, cols: np.ndarray, width: int) -> np.ndarray:
    """A packed mailbox (MBOX_FIELDS + MBOX_SCAT_FIELDS rows) whose
    column j addresses group ``cols[j]`` (pad columns: msg_type 0)."""
    n = len(cols)
    g = st["role"].shape[0]
    R = {f: i for i, f in enumerate(C.MBOX_FIELDS + C.MBOX_SCAT_FIELDS)}
    out = np.zeros((len(R), width), np.int32)
    out[R["host_term_idx"]] = -1
    out[R["host_term_val"]] = -1
    mt = rng.choice([0, 1, 2, 3, 4, 5, 6], size=n,
                    p=[0.05, 0.3, 0.35, 0.08, 0.08, 0.07, 0.07])
    cur = st["current_term"][cols]
    last = st["last_index"][cols]
    term = np.clip(cur + rng.integers(-1, 2, n), 0, None)
    prev = np.clip(last - rng.integers(0, 3, n), 0, None)
    ring = st["term_suffix"][cols, prev % st["term_suffix"].shape[1]]
    prev_term = np.where(rng.random(n) < 0.7, ring, ring + 1)
    vals = {
        "msg_type": mt, "sender_slot": rng.integers(0, PEERS, n),
        "term": term, "prev_idx": prev, "prev_term": prev_term,
        "num_entries": rng.integers(0, 4, n), "entries_last_term": term,
        "leader_commit": st["commit_index"][cols] + rng.integers(0, 4, n),
        "success": rng.random(n) < 0.8,
        "reply_next_idx": np.clip(last + rng.integers(-2, 2, n), 1, None),
        "reply_last_idx": np.clip(last - rng.integers(0, 2, n), 0, None),
        "reply_last_term": term,
        "cand_last_idx": np.clip(last + rng.integers(-2, 3, n), 0, None),
        "cand_last_term": st["last_term"][cols] + rng.integers(-1, 2, n),
        "cand_machine_version": rng.integers(0, 3, n),
        "token": st["pre_vote_token"][cols],
    }
    for f, v in vals.items():
        out[R[f], :n] = v
    # fused scatter rows: appended runs on distinct groups, watermarks
    out[R["a_gid"]] = g
    out[R["w_gid"]] = g
    na = min(n, width) // 4
    ag = rng.choice(cols, size=na, replace=False)
    hi = st["last_index"][ag] + rng.integers(0, 3, na)
    out[R["a_gid"], :na] = ag
    out[R["a_lo"], :na] = np.maximum(hi - rng.integers(0, 40, na), 1)
    out[R["a_hi"], :na] = hi
    out[R["a_term"], :na] = st["current_term"][ag]
    nw = min(n, width) // 4
    wg = rng.choice(cols, size=nw, replace=False)
    out[R["w_gid"], :nw] = wg
    out[R["w_idx"], :nw] = st["last_index"][wg]
    return out


def phase_step(torch, C, dev) -> dict:
    rng = np.random.default_rng(7)
    g = GROUPS
    fields = random_state_fields(rng, g, PEERS, SUFFIX_K)
    fields = {
        f: np.asarray(v, bool if f in ("voting", "active", "votes", "pre_votes")
                      else np.int32)
        for f, v in fields.items()
    }
    s_dev = C.state_from_numpy(fields, dev)
    s_cpu = C.state_from_numpy(fields, "cpu")
    launches0 = C.quorum.LAUNCHES
    steps = 0
    for i in range(6):
        host = C.state_to_numpy(s_cpu)
        if i % 2 == 0:
            packed = random_packed(rng, C, host, np.arange(g), g)
            s_dev, e_dev = C.consensus_step_packed_scat(
                s_dev, torch.from_numpy(packed).to(dev))
            s_cpu, e_cpu = C.consensus_step_packed_scat(
                s_cpu, torch.from_numpy(packed))
        else:
            n = 1500
            cap = 2048
            cols = np.sort(rng.choice(g, size=n, replace=False))
            packed = random_packed(rng, C, host, cols, cap)
            gidx = np.full(cap, g, np.int32)
            gidx[:n] = cols
            s_dev, e_dev = C.consensus_step_packed_sub_scat(
                s_dev, torch.from_numpy(packed).to(dev),
                torch.from_numpy(gidx).to(dev))
            s_cpu, e_cpu = C.consensus_step_packed_sub_scat(
                s_cpu, torch.from_numpy(packed), torch.from_numpy(gidx))
        steps += 1
        if not torch.equal(e_dev.cpu(), e_cpu):
            bad = [f for r, f in enumerate(C.EGRESS_FIELDS)
                   if not torch.equal(e_dev[r].cpu(), e_cpu[r])]
            raise AssertionError(f"step {i}: egress rows differ: {bad}")
        a, b = C.state_to_numpy(s_dev), C.state_to_numpy(s_cpu)
        bad = [f for f in a if not np.array_equal(a[f], b[f])]
        if bad:
            raise AssertionError(f"step {i}: state fields differ: {bad}")
    if C.quorum.LAUNCHES - launches0 != steps:
        raise AssertionError("the CUDA steps did not run the quorum kernel")
    # sanity: the scan did advance commit for some leaders
    if not (C.state_to_numpy(s_cpu)["commit_index"] > fields["commit_index"]).any():
        raise AssertionError("no commit advanced: the inputs exercise nothing")
    return {"steps": steps}


# ---------------------------------------------------------------------------
# phase 4: the main path


def phase_main(torch, C, dev, workdir: str) -> dict:
    from ra_tpu_torch.log.log import Log
    from ra_tpu_torch.log.segment_writer import SegmentWriter
    from ra_tpu_torch.log.tables import TableRegistry
    from ra_tpu_torch.log.wal import Wal
    from ra_tpu_torch.models.bench_machine import BenchMachine
    from ra_tpu_torch.protocol import Command, ElectionTimeout, USR
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = GROUPS
    # device time of each fused step, bracketed with CUDA events (the
    # coordinator looks the step functions up on the module per call):
    # (stage, kind) -> event pairs, stage "election", "waves" or
    # "profiled", kind "full" or "sub"
    step_events = {}
    stage = ["election"]
    orig = {}

    def timed(kind, fn):
        def run(*args):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            out = fn(*args)
            b.record()
            step_events.setdefault((stage[0], kind), []).append((a, b))
            return out
        return run

    for kind, name in (("full", "consensus_step_packed_scat"),
                       ("sub", "consensus_step_packed_sub_scat")):
        orig[name] = getattr(C, name)
        setattr(C, name, timed(kind, orig[name]))

    coords = [
        BatchCoordinator(f"smoke{i}", capacity=g_n, num_peers=PEERS,
                         suffix_k=SUFFIX_K, idle_sleep_s=0, device=dev)
        for i in range(3)
    ]
    storage = []
    try:
        for i, c in enumerate(coords):
            d = os.path.join(workdir, f"smoke{i}")
            tables = TableRegistry()
            sw = SegmentWriter(os.path.join(d, "data"), tables, c.wal_notify)
            w = Wal(os.path.join(d, "wal"), tables, c.wal_notify,
                    segment_writer=sw, max_batch_size=65536)
            w.notify_many = c.wal_notify_many
            storage.append((tables, w, sw, d))

        def mk_log(i, uid):
            tables, w, _sw, d = storage[i]
            return Log(uid, os.path.join(d, "data", uid), tables, w)

        members = lambda g: [(f"g{g}", f"smoke{i}") for i in range(3)]  # noqa: E731
        for i, c in enumerate(coords):
            c.add_groups([
                (f"g{g}", f"cl{g}", members(g), BenchMachine(),
                 mk_log(i, f"g{g}"))
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
        # the counts cover the main path only
        C.quorum.LAUNCHES = 0
        wide0 = C.WIDE_SORT_STEPS
        deadline = time.time() + 600
        t0 = time.perf_counter()
        coords[0].deliver_many(
            [((n, "smoke0"), ElectionTimeout(), None) for n in names]
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

        stage[0] = "waves"
        t_waves = run_waves(WAVES)
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
        launches = C.quorum.LAUNCHES
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
        if launches == 0:
            raise AssertionError("the main path never launched the quorum kernel")
        if wide:
            raise AssertionError(f"{wide} steps ran the P > 8 sort path")
        step_ms = {
            f"{st}_{kind}": (len(ev), sum(a.elapsed_time(b) for a, b in ev) / len(ev))
            for (st, kind), ev in sorted(step_events.items())
        }
        return {
            "election_s": t_elect,
            "waves_s": t_waves,
            "cmds": WAVES * g_n,
            "durable_cmds_per_s": WAVES * g_n / t_waves,
            "steps": sum(c.steps for c in coords),
            "sub_steps": sum(c.sub_steps for c in coords),
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    import ra_tpu_torch
    from ra_tpu_torch.ops import consensus as C
    from ra_tpu_torch.ops import kernels, quorum

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

    # phase 1: device and build
    t = time.perf_counter()
    kernels.build("quorum")
    log(card)
    log(f"phase device: {torch.cuda.get_device_name(0)} | torch "
        f"{torch.__version__} | cuda {torch.version.cuda} | quorum kernel "
        f"build {kernels.BUILD_SECONDS['quorum']:.2f} s | "
        f"{time.perf_counter() - t:.2f} s")
    for line in kernels.BUILD_LOG.get("quorum", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # phase 2: kernel against its plain version
    t = time.perf_counter()
    kq = phase_kernel(torch, quorum, dev)
    log(f"phase kernel: quorum_scan == plain on {kq['shapes']} shapes "
        f"(max_abs_err {kq['max_abs_err']}); at G={GROUPS} P={PEERS}: "
        f"kernel {kq['ms']:.6f} ms, plain {kq['plain_ms']:.6f} ms, "
        f"sort+gather {kq['library_ms']:.6f} ms, bound {kq['bound_ms']:.6f} ms "
        f"({kq['bound_by']}, {kq['bytes']} B) | {card} | "
        f"{time.perf_counter() - t:.2f} s")

    # phase 3: the fused step, card against CPU
    t = time.perf_counter()
    ks = phase_step(torch, C, dev)
    log(f"phase step: {ks['steps']} packed steps (scat and sub_scat) at "
        f"G={GROUPS} P={PEERS} K={SUFFIX_K}: every state field and egress "
        f"row equal on cuda and cpu | {time.perf_counter() - t:.2f} s")

    # phase 4: the main path
    t = time.perf_counter()
    workdir = tempfile.mkdtemp(prefix="ra_smoke_")
    try:
        km = phase_main(torch, C, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    log(f"phase main: {GROUPS} groups x 3 replicas, WAL-backed: election "
        f"{km['election_s']:.3f} s; {km['cmds']} cmds in {km['waves_s']:.3f} s "
        f"= {km['durable_cmds_per_s']:.1f} durable cmds/s, applied on all 3 "
        f"replicas; steps {km['steps']} (sub {km['sub_steps']}; waves "
        f"{km['wave_steps']}, sub {km['wave_sub_steps']}); quorum kernel "
        f"launches {km['launches']}; fused step device time, (steps, mean "
        f"ms) by stage and kind: {km['step_ms']}; native host paths "
        f"{km['native']} | {card} | {time.perf_counter() - t:.2f} s")
    log(f"phase main, profiled extra wave: {GROUPS} cmds in "
        f"{km['profiled_wave_s']:.3f} s under torch.profiler; device busy "
        f"{km['device_busy_ms']:.3f} ms = {km['device_busy_share']:.4f} of the "
        f"wave's wall time; top kernels (ms): {km['top_kernels']} | {card}")
    log(f"total {time.perf_counter() - t_all:.2f} s")

    log(json.dumps({"kernels": [{
        "name": "quorum_scan",
        "route": "cuda",
        "source": "ra_tpu_torch/csrc/quorum.cu",
        "replaces": "ra_tpu/ops/pallas_quorum.py:38",
        "launches": km["launches"],
        "max_abs_err": kq["max_abs_err"],
        "ms": kq["ms"],
        "plain_ms": kq["plain_ms"],
        "bound_ms": kq["bound_ms"],
        "bound_by": kq["bound_by"],
        "library_ms": kq["library_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
