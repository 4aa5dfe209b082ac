#!/usr/bin/env python3
"""Compare two checkouts of the repository on one card, in turns.

    python3 scripts/ab_compare.py DIR_A DIR_B [--rounds 1]
                                  [--pieces step,decisions,profile_wave]

Each round runs A, B, B, A (so neither side always goes first), each
piece in a fresh process from the checkout's root. The pieces (the
first three by default):

- ``chip_smoke.phase_step``: the step kernels against the plain step,
  then the time per call of both step entry points at G = 10240, P = 3,
  K = 32 (median of 200 event-bracketed calls) and whatever card time
  and host part that checkout's phase step reports;
- ``python -m ra_tpu_torch.bench --decisions`` (10240 groups x 200
  steps): decisions/s and card time a step;
- ``python -m ra_tpu_torch.profile_wave 2048 4``: the wave-phase table's
  ``device_step`` row;
- ``main``: ``chip_smoke.phase_main`` through the step kernels, 10240
  groups x 3 replicas, WAL-backed: durable cmds/s, the fleet election,
  the steps of the measured waves, each wave step call's card span and
  host wall and the wave-phase sums;
- ``headline``: ``python -m ra_tpu_torch.bench --cmds 4`` (as
  ``chip_smoke.py``'s phase bench): cmds/s, unloaded p50/p99, admitted
  cmds/s;
- ``reads``: ``python -m ra_tpu_torch.bench --reads --groups 256 --cmds
  60``: reads/s lease on and off;
- ``kernel``: the quorum kernel (``csrc/quorum.cu``) through
  ``ops.quorum.agreed_commit`` at G = 10240 with P = 3, 5 and 7 and at the
  scaling shape G = 4,194,304, P = 3: time a call (median of 200
  event-bracketed calls), its host part (median host clock with the C
  entry called at G = 0, where it returns before launching), card time
  (``torch.profiler``, 50 calls), the plain version and ``torch.sort`` +
  ``gather``; and the empty-launch floor where the checkout's library
  exports ``ra_quorum_empty_launch``. It reaches the launcher through
  ``_fns`` or, in checkouts before the kernel's redesign, ``_fn``.

It prints one JSON line per piece and run, tagged with the side and the
card's name and power limit, and exits non-zero if any piece failed.
Needs a CUDA card; imports no JAX.
"""

import argparse
import json
import os
import subprocess
import sys

PHASE_STEP = r"""
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.ops import kernels
from ra_tpu_torch.ops import step as S
kernels.build_many(["quorum", "step"])
ks = cs.phase_step(torch, C, S, torch.device("cuda", 0))
keep = ("ms", "plain_ms", "host_ms", "card_us", "device_us_per_step",
        "bound_ms", "max_abs_err")
print(json.dumps({kind: {k: v for k, v in ks[kind].items() if k in keep}
                  for kind in ("full", "sub")}))
"""

MAIN = r"""
import json, sys, tempfile, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.ops import kernels
from ra_tpu_torch.ops import step as S
kernels.build_many(["quorum", "step"])
r = cs.phase_main(torch, C, S, torch.device("cuda", 0),
                  tempfile.mkdtemp(prefix="ra_ab_"), "ab")
print(json.dumps({k: r[k] for k in (
    "durable_cmds_per_s", "election_s", "wave_steps", "wave_sub_steps",
    "wave_split_ms", "step_ms")}))
"""


KERNEL = r"""
import json, statistics, sys, time, numpy as np, torch
sys.path.insert(0, ".")
import chip_smoke as cs
from ra_tpu_torch.ops import kernels
from ra_tpu_torch.ops import quorum as Q
kernels.build_many(["quorum"])
dev = torch.device("cuda", 0)
real = Q._kernel()
def swap(fn):
    if hasattr(Q, "_fns"):
        Q._fns["ra_quorum_launch"] = fn
    else:
        Q._fn = fn
def no_launch(m, v, nv, out, g, p, stream):
    return real(m, v, nv, out, 0, p, stream) and 0
def host_ms(call):
    swap(no_launch)
    try:
        for _ in range(20):
            call()
        ts = []
        for _ in range(200):
            t0 = time.perf_counter()
            call()
            ts.append(time.perf_counter() - t0)
    finally:
        swap(real)
    return statistics.median(ts) * 1e3
rng = np.random.default_rng(1)
out = {}
for g, p in ((10240, 3), (10240, 5), (10240, 7), (4194304, 3)):
    tm, tv, tn = (torch.from_numpy(a).to(dev) for a in cs.quorum_inputs(rng, g, p))
    call = lambda: Q.agreed_commit(tm, tv, tn)
    assert torch.equal(call(), Q.agreed_commit_plain(tm, tv, tn)), (g, p)
    _, us = cs.profile_kernels(torch, call, 50, ("quorum_kernel",))
    eff = torch.where(tv, tm, -1)
    pos = torch.clamp(p - 1 - torch.div(tn, 2, rounding_mode="floor"), 0, p - 1).long()[:, None]
    nbytes = g * (5 * p + 8)
    card_us = sum(us.values())
    out[f"{g}x{p}"] = {
        "ms": cs.median_ms(call), "host_ms": host_ms(call), "card_us": card_us,
        "plain_ms": cs.median_ms(lambda: Q.agreed_commit_plain(tm, tv, tn)),
        "library_ms": cs.median_ms(lambda: torch.sort(eff, dim=-1).values.gather(-1, pos)),
        "bytes": nbytes, "bound_share": nbytes / cs.HBM_BYTES_PER_S * 1e6 / card_us}
lib = kernels.load("quorum")
if hasattr(lib, "ra_quorum_empty_launch"):
    out["empty_launch"] = cs.launch_floor(torch, Q, 10240, dev)
print(json.dumps(out))
"""


def run(where: str, args: list, timeout: float) -> str:
    proc = subprocess.run([sys.executable, *args], cwd=where,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{args[:3]} in {where} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    return proc.stdout


def last_json(where: str, args: list, timeout: float) -> dict:
    return json.loads(run(where, args, timeout).strip().splitlines()[-1])


def bench(where: str, args: list, keys: tuple) -> dict:
    res = last_json(where, ["-m", "ra_tpu_torch.bench", *args,
                            "--device", "cuda:0"], 600)
    return {k: res.get(k) for k in keys}


PIECES = ("step", "decisions", "profile_wave", "main", "headline", "reads",
          "kernel")


def pieces(where: str, which) -> dict:
    out = {}
    if "step" in which:
        out["phase_step"] = last_json(where, ["-c", PHASE_STEP], 900)
    if "decisions" in which:
        out["decisions"] = bench(where, ["--decisions"], (
            "value", "card_us_per_step", "loop_card_us_per_step",
            "kernel_launches"))
    if "profile_wave" in which:
        table = run(where, ["-m", "ra_tpu_torch.profile_wave", "2048", "4",
                            "--device", "cuda:0"], 600)
        out["profile_wave"] = [ln for ln in table.splitlines()
                               if ln.startswith("| ") and "device_step" in ln]
    if "main" in which:
        out["main"] = last_json(where, ["-c", MAIN], 900)
    if "kernel" in which:
        out["kernel"] = last_json(where, ["-c", KERNEL], 600)
    if "headline" in which:
        out["headline"] = bench(where, ["--cmds", "4"], (
            "value", "p50_ms", "p99_ms", "admitted_cmds_per_sec"))
    if "reads" in which:
        res = last_json(where, ["-m", "ra_tpu_torch.bench", "--reads",
                                "--groups", "256", "--cmds", "60",
                                "--device", "cuda:0"], 600)
        out["reads"] = {arm: {k: res[arm][k] for k in (
            "reads_per_sec", "read_p50_ms")} for arm in ("lease_on", "lease_off")}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--pieces", default="step,decisions,profile_wave",
                    help=f"comma-separated, of {','.join(PIECES)}")
    args = ap.parse_args()
    which = args.pieces.split(",")
    if set(which) - set(PIECES):
        ap.error(f"unknown pieces {sorted(set(which) - set(PIECES))}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    failed = False
    for rnd in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            where = os.path.abspath(getattr(args, side))
            try:
                res = pieces(where, which)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                failed = True
                res = {"error": str(e)[-3000:]}
            print(json.dumps({"round": rnd, "side": side, "dir": where,
                              "device": card, **res}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
