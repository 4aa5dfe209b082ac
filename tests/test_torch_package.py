"""Package rules of the port: ``ra_tpu_torch`` imports neither JAX nor any
module of ``ra_tpu``, and every host module it copied from ``ra_tpu``
still equals its original after the package-name rewrite."""

import ast
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "ra_tpu_torch")
REF = os.path.join(ROOT, "ra_tpu")

# host modules carried over verbatim: the coordinator's import closure,
# then the client API and the actor backend (with the kv model the
# batch-backend API tests run)
COPIED = [
    "protocol.py", "utils/__init__.py", "utils/seq.py", "utils/wire.py",
    "utils/lib.py", "utils/flru.py", "effects.py", "machine.py", "aux.py",
    "faults.py", "leaderboard.py", "log/__init__.py", "log/api.py",
    "log/memory.py", "log/tables.py", "log/memtable.py", "log/segment.py",
    "log/segments.py", "log/snapshot.py", "log/wal.py",
    "log/segment_writer.py", "log/log.py", "native/__init__.py",
    "native/rt_native.cpp", "native/wal_native.cpp", "runtime/__init__.py",
    "runtime/clock.py", "runtime/transport.py", "counters.py", "li.py",
    "obs.py", "health.py", "pressure.py", "rings.py", "lease.py",
    "models/__init__.py", "models/bench_machine.py", "ops/__init__.py",
    "ops/decisions.py",
    "system.py", "directory.py", "log/meta.py", "log/meta_store.py",
    "log/sync_pool.py", "runtime/timers.py", "runtime/scheduler.py",
    "log/read_plan.py", "server.py", "runtime/proc.py", "detector.py",
    "runtime/tcp.py", "runtime/node.py", "api.py", "testing.py",
    "models/kv.py",
    # the fault-injection harnesses and the models they drive
    "utils/range.py", "models/fifo.py", "models/session.py", "nemesis.py",
    "linearize.py", "kv_harness.py", "sim/clock.py", "sim/scheduler.py",
    "sim/schedule.py", "sim/transport.py", "sim/workloads.py",
    "sim/shrink.py", "sim/world.py", "sim/explorer.py", "sim/__init__.py",
    "dbg.py",
]

# permitted differences from the rewritten original, each with its reason,
# as (original, copy)
EDITED_LINES = {
    # comment lines that named the change history of the reference
    # package (the port's program files do not refer to it)
    "native/__init__.py": [(
        "- ``wal_native``: WAL batch framing + write + fsync (PR 5);",
        "- ``wal_native``: WAL batch framing + write + fsync;",
    )],
    "lease.py": [(
        "# Test-only failpoint (PR-8 style, see models/fifo.py",
        "# Test-only failpoint (in the style of models/fifo.py",
    )],
    # kv_harness.py and linearize.py: the change-history comments as
    # above, then the device of the batch backend, whose coordinators
    # need one (None means "cuda" and raises without a card; the tests
    # pass "cpu"): a ``device`` argument threaded from the entry points to
    # each BatchCoordinator, plus ``--device`` in the ops entry point.
    # The actor backend is host-only and takes none.
    "kv_harness.py": [
        ("    flow-control contract (ISSUE 5 tentpole item 5):\n",
         "    flow-control contract:\n"),
        ("# fifo workload (ISSUE 13: second harnessed workload over FifoMachine)\n",
         "# fifo workload (the second harnessed workload, over FifoMachine)\n"),
        ("    lease: bool = False,\n) -> HarnessResult:\n",
         "    lease: bool = False,\n    device=None,\n) -> HarnessResult:\n"),
        ("    outlives its leader shows up as a stale read.\"\"\"",
         "    outlives its leader shows up as a stale read.\n\n"
         "    ``device`` places the batch backend's coordinators (``None``:\n"
         "    ``\"cuda\"``); the actor backend is host-only and ignores it."
         "\"\"\""),
        ("combined=combined, native=native, lease=lease)\n",
         "combined=combined, native=native, lease=lease,\n"
         "                          device=device)\n"),
        ("native=\"auto\", lease=False) -> HarnessResult:\n",
         "native=\"auto\", lease=False,\n"
         "               device=None) -> HarnessResult:\n"),
        ("            lease=lease,\n        )\n",
         "            lease=lease,\n            device=device,\n        )\n"),
        ("(docs/INTERNALS.md §20)\")\n    args = ap.parse_args()\n",
         "(docs/INTERNALS.md §20)\")\n"
         "    ap.add_argument(\"--device\", default=None,\n"
         "                    help=\"torch device of the batch backend's \"\n"
         "                         \"coordinators (default: cuda)\")\n"
         "    args = ap.parse_args()\n"),
        ("lease=args.lease)\n", "lease=args.lease, device=args.device)\n"),
    ],
    "linearize.py": [
        ("    op_timeout: float = 10.0,\n) -> CheckResult:\n",
         "    op_timeout: float = 10.0,\n    device=None,\n) -> CheckResult:\n"),
        ("    the checker verdict over the recorded history.\"\"\"\n",
         "    the checker verdict over the recorded history. ``device`` "
         "places the\n    batch backend's coordinators (``None``: "
         "``\"cuda\"``).\"\"\"\n"),
        ("        setup = _setup_batch\n",
         "        def setup(seed, nodes, op_timeout):\n"
         "            return _setup_batch(seed, nodes, op_timeout, "
         "device=device)\n"),
        ("op_timeout: float):\n    from ra_tpu_torch import leaderboard\n",
         "op_timeout: float, device=None):\n"
         "    from ra_tpu_torch import leaderboard\n"),
        ("detector_poll_s=0.05)\n",
         "detector_poll_s=0.05, device=device)\n"),
        ("    ap.add_argument(\"--ops\", type=int, default=100)\n",
         "    ap.add_argument(\"--ops\", type=int, default=100)\n"
         "    ap.add_argument(\"--device\", default=None,\n"
         "                    help=\"torch device of the batch backend's \"\n"
         "                         \"coordinators (default: cuda)\")\n"),
        ("ops_per_client=args.ops)\n",
         "ops_per_client=args.ops,\n                       device=args.device)\n"),
    ],
}

def rewrite(src: str) -> str:
    """The package-name rewrite every copy went through: each whole-word
    ``ra_tpu`` (imports, logger name, wire allowlist prefix, messages)
    becomes ``ra_tpu_torch``."""
    return re.sub(r"\bra_tpu\b", "ra_tpu_torch", src)


# a docstring's absolute path into the upstream project's source checkout
# (rabbitmq/ra) keeps only the path inside that project
_UPSTREAM_PATH = re.compile(r"(?m)^(\s+)/\w+/reference/")


def _read(*parts) -> str:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return f.read()


def test_import_loads_neither_jax_nor_the_reference_package():
    code = (
        "import sys\n"
        "import ra_tpu_torch.runtime.coordinator\n"
        "import ra_tpu_torch.ops.quorum\n"
        "import ra_tpu_torch.api, ra_tpu_torch.runtime.node, ra_tpu_torch.runtime.tcp\n"
        "import ra_tpu_torch.kv_harness, ra_tpu_torch.linearize\n"
        "import ra_tpu_torch.nemesis, ra_tpu_torch.sim, ra_tpu_torch.sim.explorer\n"
        "import ra_tpu_torch.dbg\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ra_tpu' or m.startswith('ra_tpu.'))\n"
        "print(','.join(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "", out.stdout


def _port_files(suffixes):
    for d, _dirs, files in os.walk(PORT):
        for f in files:
            if f.endswith(suffixes):
                yield os.path.join(d, f)


_BAD_IMPORT = re.compile(r"^\s*(from|import)\s+(jax\b|ra_tpu(\.|\s|$))", re.M)


def test_no_file_of_the_port_imports_jax_or_the_reference():
    files = list(_port_files((".py",)))
    assert len(files) > 40
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    for path in files:
        src = _read(path)
        assert not _BAD_IMPORT.search(src), path
        for node in ast.walk(ast.parse(src)):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                top = n.split(".")[0]
                assert top not in ("jax", "jaxlib", "ra_tpu"), (path, n)


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_equals_its_original(rel):
    want = _UPSTREAM_PATH.sub(r"\1", rewrite(_read(REF, rel)))
    for original, copy in EDITED_LINES.get(rel, []):
        assert want.count(original) == 1, (rel, original)
        want = want.replace(original, copy)
    assert _read(PORT, rel) == want, rel
