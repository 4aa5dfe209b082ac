"""The port's operator tools on the CPU: ``ra_tpu_torch.profile_wave``,
``ra_tpu_torch.obs_smoke`` and ``ra_tpu_torch.ra_top``, the copies of
the JAX package's ``profile_wave.py``, ``scripts/obs_smoke.py`` and
``scripts/ra_top.py`` (``tests/test_torch_package.py`` holds each copy
against its original).

- ``profile_wave`` imports without touching ``sys.argv``, and at 16
  groups x 2 commands its cost table attributes the step loop to
  exactly the phases of ``obs.WAVE_STEP_PHASES``.
- ``obs_smoke`` at ``--groups 16 --cmds 2 --device cpu`` passes its gate
  (exit 0).
- ``ra_top --from-json`` renders a ``cluster_health()`` snapshot of the
  port's demo cluster as the JAX package's ``render`` does, and
  ``--demo --device cpu`` runs its refreshes.
- Every entry point raises without CUDA when no device is given.
"""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from ra_tpu_torch import obs

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_module(args, env_extra=None, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


# -- profile_wave -------------------------------------------------------------


def test_profile_wave_import_leaves_argv_alone(monkeypatch):
    argv = ["prog", "256", "8", "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", list(argv))
    importlib.reload(importlib.import_module("ra_tpu_torch.profile_wave"))
    assert sys.argv == argv


def test_profile_wave_attributes_the_step_loop_to_its_phases(capsys):
    from ra_tpu_torch import profile_wave

    profile_wave.main(16, 2, top=len(obs.WAVE_PHASES), device="cpu")
    out = capsys.readouterr().out
    assert "## profile_wave: 16 groups x 2 cmds" in out
    table = out.split("### Wave-phase cost attribution")[1].split("###")[0]
    rows = [line.split("|")[1:-1] for line in table.splitlines()
            if line.startswith("| ") and line[2].isdigit()]
    step = {r[1].strip() for r in rows if r[3].strip().endswith("%")}
    assert step == {ph for ph, _ in obs.WAVE_STEP_PHASES}
    shares = [float(r[3].strip()[:-1]) for r in rows
              if r[3].strip().endswith("%")]
    assert abs(sum(shares) - 100.0) < 0.5
    assert "### Commit-latency stage decomposition" in out


# -- obs_smoke ----------------------------------------------------------------


def test_obs_smoke_passes_on_the_cpu():
    proc = _run_module(["ra_tpu_torch.obs_smoke", "--groups", "16",
                        "--cmds", "2", "--device", "cpu"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "obs_smoke: PASS" in proc.stderr


# -- ra_top -------------------------------------------------------------------


def _ref_ra_top():
    spec = importlib.util.spec_from_file_location(
        "ra_ref_top", os.path.join(ROOT, "scripts", "ra_top.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ra_top_renders_a_cluster_health_snapshot_of_the_port(
        tmp_path, monkeypatch, capsys):
    from ra_tpu_torch import api, ra_top

    teardown = ra_top._demo_cluster(device="cpu")
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            health = api.cluster_health()
            rows = [r for cl in health["clusters"].values()
                    for r in cl["groups"].values()]
            if (len(health["nodes"]) >= 3 and len(rows) >= 24
                    and any(r["role"] == "leader" for r in rows)):
                break
            time.sleep(0.1)
    finally:
        teardown()
    health = json.loads(json.dumps(health))
    path = tmp_path / "health.json"
    path.write_text(json.dumps(health))
    monkeypatch.setattr(sys, "argv", ["ra_top", "--from-json", str(path),
                                      "-n", "1", "-i", "0", "--top", "3"])
    assert ra_top.main() == 0
    out = capsys.readouterr().out
    panel = out.split("(refresh 1)\n", 1)[1].rstrip("\n")
    assert panel == ra_top.render(health, top_k=3)
    assert panel == _ref_ra_top().render(health, top_k=3)
    assert panel.startswith("== ra_top · ")
    for name in ("top0", "top1", "top2"):
        assert f"  {name} " in panel


def test_ra_top_demo_runs_on_the_given_device():
    proc = _run_module(["ra_tpu_torch.ra_top", "--demo", "--device", "cpu",
                        "-n", "2", "-i", "0.5"])
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("== ra_top · ") == 2
    assert "(refresh 2)" in proc.stdout


# -- no card, no device -------------------------------------------------------


def test_tools_raise_without_cuda_when_no_device_is_given(monkeypatch):
    from ra_tpu_torch import profile_wave, ra_top

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        profile_wave.main(4, 1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ra_top._demo_cluster()
    monkeypatch.setattr(sys, "argv", ["ra_top", "--demo", "-n", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ra_top.main()


def test_obs_smoke_fails_without_cuda_when_no_device_is_given():
    proc = _run_module(["ra_tpu_torch.obs_smoke", "--groups", "4",
                        "--cmds", "1"], env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert "obs_smoke: PASS" not in proc.stderr
