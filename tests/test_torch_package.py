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
]

# permitted differences from the rewritten original, each with its reason:
# comment lines that named the change history of the reference package
# (the port's program files do not refer to it), as (original, copy)
EDITED_LINES = {
    "native/__init__.py": [(
        "- ``wal_native``: WAL batch framing + write + fsync (PR 5);",
        "- ``wal_native``: WAL batch framing + write + fsync;",
    )],
    "lease.py": [(
        "# Test-only failpoint (PR-8 style, see models/fifo.py",
        "# Test-only failpoint (in the style of models/fifo.py",
    )],
}

def rewrite(src: str) -> str:
    """The package-name rewrite every copy went through: each whole-word
    ``ra_tpu`` (imports, logger name, wire allowlist prefix, messages)
    becomes ``ra_tpu_torch``."""
    return re.sub(r"\bra_tpu\b", "ra_tpu_torch", src)


def _read(*parts) -> str:
    with open(os.path.join(*parts), encoding="utf-8") as f:
        return f.read()


def test_import_loads_neither_jax_nor_the_reference_package():
    code = (
        "import sys\n"
        "import ra_tpu_torch.runtime.coordinator\n"
        "import ra_tpu_torch.ops.quorum\n"
        "import ra_tpu_torch.api, ra_tpu_torch.runtime.node, ra_tpu_torch.runtime.tcp\n"
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
    want = rewrite(_read(REF, rel))
    for original, copy in EDITED_LINES.get(rel, []):
        assert want.count(original) == 1, (rel, original)
        want = want.replace(original, copy)
    assert _read(PORT, rel) == want, rel
