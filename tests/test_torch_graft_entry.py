"""The port's graft entry (``ra_tpu_torch.graft_entry``) against the
repository root's ``__graft_entry__.py``, on the CPU: ``entry()`` stepped
once equals the JAX ``entry()`` stepped once, field by field, and
``dryrun_multichip`` passes the reference's four phases over a mesh of
CPU slices. A ``cuda``-marked test runs the dryrun on the card."""

import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ra_tpu_torch import graft_entry
from ra_tpu_torch.ops import consensus as T
from ra_tpu_torch.ops import step as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PHASES = (
    "phase election+commit ok (64 groups, 8-device mesh)",
    "phase failover ok (dry1 leads all 64 groups, sharding intact)",
    "phase membership ok (dead member removed, group still serves)",
    "phase snapshot_install ok (fresh member caught up via snapshot, sharded)",
)


def _ref_entry():
    spec = importlib.util.spec_from_file_location(
        "ra_ref_graft_entry", os.path.join(ROOT, "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_entry_stepped_once_matches_the_jax_entry():
    jfn, (jst, jmb) = _ref_entry().entry()
    fn, (st, mb) = graft_entry.entry(device="cpu")
    assert st.role.device.type == "cpu" and st.role.shape == (4096,)
    js, je = jfn(jst, jmb)
    ts, te = fn(st, mb)
    got = T.state_to_numpy(ts)
    for k, v in js._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), got[k], err_msg=k)
    for k, v in je._asdict().items():
        np.testing.assert_array_equal(np.asarray(v), getattr(te, k).numpy(),
                                      err_msg=f"egress {k}")
    # the example mailbox really moves the state: every group accepts
    assert (np.asarray(je.aer_code) == T.AER_OK).all()


def test_entry_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is exercised on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        graft_entry.dryrun_multichip(2)


def test_dryrun_multichip_passes_the_four_phases(capsys):
    graft_entry.dryrun_multichip(8, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out[:4] == list(PHASES)
    assert out[4].startswith("dryrun_multichip ok: 8 slices on 1 distinct "
                             "device(s) (cpu), 64 groups")


def test_module_runs_entry_and_dryrun():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "ra_tpu_torch.graft_entry", "--device", "cpu",
         "--devices", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "entry ok"
    assert lines[1] == "phase election+commit ok (16 groups, 2-device mesh)"
    assert lines[-1].startswith("dryrun_multichip ok: 2 slices")


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card():
    """Two slices on the card (``cuda:(i % device_count)``), each
    stepped by the step kernel: one launch a slice a step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    launches = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
    graft_entry.dryrun_multichip(2)
    full = S.LAUNCHES_FULL - launches[0]
    assert full > 0 and full % 2 == 0
    assert S.LAUNCHES_SUB == launches[1]
