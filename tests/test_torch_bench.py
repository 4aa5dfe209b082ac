"""The port's bench (``ra_tpu_torch.bench``) against the JAX package's
root-level ``bench.py``, on the CPU.

1. Decisions: the port's decision loop (the packed mailbox through
   ``consensus_step_packed_scat``) on ``device="cpu"`` against a JAX
   ``lax.scan`` of ``consensus_step_impl`` built the way ``bench.py``'s
   ``bench_decisions`` builds it, at G = 64 and T = 8: the final state
   equal field for field and the per-step ``success`` sums equal,
   exactly.
2. Pipeline: ``bench_pipeline`` at 16 groups x 2 commands on both
   packages, the port in each mode (``on``, ``off``, ``threaded``, and
   ``on`` without the WAL): the reference's JSON keys plus the port's
   listed additions, three passes completed (a failed state check exits
   the bench), launches of no kernel on the CPU.
3. Reads: ``bench_reads`` at 8 groups x 3 rounds on both packages.
4. Every bench function raises without CUDA when no device is given.

The JAX side runs once per module, one module-scoped fixture for each
reference bench (decisions, pipeline, reads), so a reference run can
fail only the tests that use its result. The benches run with the
reference's native host library kept out (``native="off"``, and its
loader reporting nothing built), so these tests start no g++ build of
``ra_tpu/native``. The reference pipeline bench keeps a known race (a
re-election noop can lift the applied floor its waves end on), which
exits it with its own message; the fixture retries that exit, and only
that one, a bounded number of times. The port's benches never retry.
"""

import contextlib
import importlib.util
import io
import os
import re
import sys
import warnings
from typing import Optional

import numpy as np
import pytest
import torch

from ra_tpu_torch import bench as port_bench
from ra_tpu_torch.ops import consensus as PC

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G_DEC, T_DEC = 64, 8
G_PIPE, CMDS = 16, 2
G_READS, ROUNDS = 8, 3

# keys the port's pipeline and read benches add to the reference's
PIPELINE_ADDED = {"device", "kernel_launches", "passes_completed"}
READS_ADDED = {"device", "kernel_launches"}


def _ref_bench():
    spec = importlib.util.spec_from_file_location(
        "ra_ref_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_decisions(groups, steps):
    """``bench.py``'s decision scan (its ``many_steps``), returning the
    final state and the per-step success sums instead of a rate."""
    import jax
    import jax.numpy as jnp

    from ra_tpu.ops.consensus import (MSG_AER, consensus_step_impl,
                                      empty_mailbox, make_group_state)

    G, T = groups, steps
    state = make_group_state(G, 3)
    mbox = empty_mailbox(G)._replace(
        msg_type=jnp.full((G,), MSG_AER, jnp.int32),
        term=jnp.ones((G,), jnp.int32),
        num_entries=jnp.ones((G,), jnp.int32),
        entries_last_term=jnp.ones((G,), jnp.int32),
    )

    def many_steps(state, mbox):
        def body(st, _):
            mb = mbox._replace(prev_idx=st.last_index, prev_term=st.last_term)
            st2, eg = consensus_step_impl(st, mb)
            return st2, eg.success.sum()

        return jax.lax.scan(body, state, None, length=T)

    st, sums = jax.jit(many_steps)(state, mbox)
    return ({k: np.asarray(v) for k, v in st._asdict().items()},
            np.asarray(sums))


@pytest.fixture(scope="module")
def ref_native_off():
    """The reference bench module with its native host paths off: the
    WAL asks ``available()``, a coordinator ``entry_points()`` (so
    ``bench_reads``, which takes no ``native=`` argument, runs without
    them too)."""
    import ra_tpu.native

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ra_tpu.native, "available", lambda: False)
        mp.setattr(ra_tpu.native, "entry_points",
                   lambda: dict.fromkeys(("wal", "pack", "classify",
                                          "egress"), False))
        yield _ref_bench()


# The reference pipeline bench's known race: its cooperative modes end a
# wave on the applied-index floor, which a re-election noop can lift, so a
# latency wave's commands land in a measured pass and the groups they hit
# are found ahead of the expected count, none behind. It exits the bench
# (SystemExit(1) on the CPU) with this message. The port's copy waits on
# the machine mirrors.
RACE = re.compile(r"bench error: \d+/\d+ groups wrong state \(expected "
                  r"\+(\d+); advance min=(\d+) max=(\d+)\)")
REF_PIPELINE_TRIES = 5


def race_in(err: str) -> Optional[str]:
    """The race's message in a run's stderr: the wrong groups advanced
    past the expected count, and no group fell short of it. None for any
    other failure."""
    m = RACE.search(err)
    if m is None:
        return None
    want, lo, hi = map(int, m.groups())
    return m[0] if want <= lo and want < hi else None


@pytest.fixture(scope="module")
def jax_pipeline(ref_native_off):
    """One completed run of the reference pipeline bench. A run that
    exits with the race's own message is retried, up to
    ``REF_PIPELINE_TRIES`` runs in all, and each retry is reported as a
    warning; any other exit fails."""
    for _ in range(REF_PIPELINE_TRIES):
        err = io.StringIO()
        try:
            with contextlib.redirect_stderr(err):
                return ref_native_off.bench_pipeline(G_PIPE, CMDS,
                                                     native="off")
        except SystemExit:
            race = race_in(err.getvalue())
            if race is None:
                raise AssertionError(
                    f"reference bench_pipeline failed: {err.getvalue()}")
            warnings.warn(f"reference bench_pipeline retried after its "
                          f"applied-floor race: {race}")
        finally:
            sys.stderr.write(err.getvalue())
    raise AssertionError(f"reference bench_pipeline hit its race in "
                         f"{REF_PIPELINE_TRIES} runs of {REF_PIPELINE_TRIES}")


@pytest.fixture(scope="module")
def jax_decisions():
    """The reference's decision scan."""
    return _jax_decisions(G_DEC, T_DEC)


@pytest.fixture(scope="module")
def jax_reads(ref_native_off):
    """One run of the reference read bench."""
    return ref_native_off.bench_reads(G_READS, ROUNDS)


# -- 1. decisions -------------------------------------------------------------


def test_decision_loop_equals_the_jax_scan(jax_decisions):
    want_state, want_sums = jax_decisions
    st, sums = port_bench.decisions_loop(G_DEC, T_DEC, device="cpu")
    got = PC.state_to_numpy(st)
    assert set(got) == set(want_state)
    for name, want in want_state.items():
        np.testing.assert_array_equal(
            got[name].astype(want.dtype), want, err_msg=name)
    np.testing.assert_array_equal(sums.numpy(), want_sums)
    # the loop did decide: every group accepted an AER at every step
    assert (want_sums == G_DEC).all()
    assert (got["last_index"] == T_DEC).all()


def test_decision_mailbox_packs_the_reference_mailbox():
    packed = port_bench.decisions_mailbox(G_DEC, torch.device("cpu"))
    rows = PC.MBOX_FIELDS + PC.MBOX_SCAT_FIELDS
    assert packed.shape == (len(rows), G_DEC)
    assert packed.dtype == torch.int32
    want = {"msg_type": PC.MSG_AER, "term": 1, "num_entries": 1,
            "entries_last_term": 1, "host_term_idx": -1,
            "host_term_val": -1, "a_gid": G_DEC, "w_gid": G_DEC}
    for i, name in enumerate(rows):
        assert (packed[i] == want.get(name, 0)).all(), name


def test_bench_decisions_reports_the_loop(jax_decisions):
    out = port_bench.bench_decisions(G_DEC, T_DEC, device="cpu")
    assert out["unit"] == "decisions/sec" and out["value"] > 0
    assert out["groups"] == G_DEC and out["steps"] == T_DEC
    assert out["success_total"] == int(jax_decisions[1].sum())
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert "device cpu" in out["metric"]
    assert out["card_us_per_step"] is None
    assert out["loop_card_us_per_step"] is None
    assert "host clock" in out["timing"]
    # CPU tensors take the plain step: no kernel launched
    assert out["kernel_launches"] == {"step_full": 0, "step_sub": 0,
                                      "quorum_scan": 0}


# -- 2. pipeline --------------------------------------------------------------


@pytest.mark.parametrize("mode", [
    dict(pipeline="on"),
    dict(pipeline="off"),
    dict(pipeline="threaded"),
    dict(pipeline="on", wal=False),
])
def test_bench_pipeline_matches_the_reference_shape(jax_pipeline, mode,
                                                   tmp_path):
    out = port_bench.bench_pipeline(G_PIPE, CMDS, device="cpu",
                                    workdir=str(tmp_path), **mode)
    ref = jax_pipeline
    assert set(out) == set(ref) | PIPELINE_ADDED
    # three verified passes (a wrong state exits the bench), a rate,
    # latency from every phase
    assert out["passes_completed"] == 3
    assert out["value"] > 0 and out["unit"] == ref["unit"] == "commands/sec"
    assert out["admitted_cmds_per_sec"] is not None
    for k in ("p50_ms", "p99_ms", "loaded_p50_ms", "unbounded_loaded_p50_ms"):
        assert out[k] is not None and out[k] >= 0, k
    assert out["pipeline"] == mode["pipeline"]
    assert out["device"] == {"name": "cpu", "power_limit": None}
    assert "device cpu" in out["metric"]
    assert out["kernel_launches"] == {"step_full": 0, "step_sub": 0,
                                      "quorum_scan": 0}
    assert set(out["native_counters"]) == set(ref["native_counters"])
    assert set(out["ring_counters"]) == set(ref["ring_counters"])
    wal = "shared-WAL" in out["metric"]
    assert wal == mode.get("wal", True)


# -- 3. reads -----------------------------------------------------------------


def test_bench_reads_matches_the_reference(jax_reads):
    out = port_bench.bench_reads(G_READS, ROUNDS, device="cpu")
    ref = jax_reads
    assert set(out) == set(ref) | READS_ADDED
    for arm in ("lease_on", "lease_off"):
        assert set(out[arm]) == set(ref[arm])
        for r in (out, ref):
            assert r[arm]["reads"] == G_READS * ROUNDS
    assert out["lease_off"]["read_lease_served"] == 0
    assert ref["lease_off"]["read_lease_served"] == 0
    assert (out["lease_off"]["read_quorum_fallback"]
            == ref["lease_off"]["read_quorum_fallback"])
    # at the leader, a lease-arm read is served by the lease or, when
    # the lease lapsed, by a quorum round: never both, never neither
    for r in (out, ref):
        on = r["lease_on"]
        assert (on["read_lease_served"] + on["read_quorum_fallback"]
                == G_READS * ROUNDS)
    assert out["kernel_launches"]["quorum_scan"] == 0


# -- 4. no card, no device ----------------------------------------------------


@pytest.mark.parametrize("call", [
    lambda: port_bench.bench_pipeline(4, 1),
    lambda: port_bench.bench_reads(4, 1),
    lambda: port_bench.bench_decisions(4, 1),
    lambda: port_bench.decisions_loop(4, 1),
], ids=["pipeline", "reads", "decisions", "decisions_loop"])
def test_bench_raises_without_cuda_when_no_device_is_given(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        call()
