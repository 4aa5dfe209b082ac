#!/usr/bin/env python3
"""Compare two checkouts of the repository on one card, in turns.

    python3 scripts/ab_compare.py DIR_A DIR_B [--rounds 1]

Each round runs A, B, B, A (so neither side always goes first), each
piece in a fresh process from the checkout's root:

- ``chip_smoke.phase_step``: the step kernels against the plain step,
  then the time per call of both step entry points at G = 10240, P = 3,
  K = 32 (median of 200 event-bracketed calls) and whatever card time
  and host part that checkout's phase step reports;
- ``python -m ra_tpu_torch.bench --decisions`` (10240 groups x 200
  steps): decisions/s and card time a step;
- ``python -m ra_tpu_torch.profile_wave 2048 4``: the wave-phase table's
  ``device_step`` row.

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


def run(where: str, args: list, timeout: float) -> str:
    proc = subprocess.run([sys.executable, *args], cwd=where,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"{args[:3]} in {where} exited {proc.returncode}:\n"
                           f"{proc.stderr[-3000:]}")
    return proc.stdout


def pieces(where: str) -> dict:
    out = {}
    out["phase_step"] = json.loads(
        run(where, ["-c", PHASE_STEP], 900).strip().splitlines()[-1])
    dec = json.loads(run(where, ["-m", "ra_tpu_torch.bench", "--decisions",
                                 "--device", "cuda:0"], 600)
                     .strip().splitlines()[-1])
    out["decisions"] = {k: dec.get(k) for k in (
        "value", "card_us_per_step", "loop_card_us_per_step", "kernel_launches")}
    table = run(where, ["-m", "ra_tpu_torch.profile_wave", "2048", "4",
                        "--device", "cuda:0"], 600)
    out["profile_wave"] = [ln for ln in table.splitlines()
                           if ln.startswith("| ") and "device_step" in ln]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    failed = False
    for rnd in range(args.rounds):
        for side in ("a", "b", "b", "a"):
            where = os.path.abspath(getattr(args, side))
            try:
                res = pieces(where)
            except (RuntimeError, subprocess.TimeoutExpired) as e:
                failed = True
                res = {"error": str(e)[-3000:]}
            print(json.dumps({"round": rnd, "side": side, "dir": where,
                              "device": card, **res}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
