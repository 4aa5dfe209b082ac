"""Offline WAL replay debugger.

Capability parity with the reference's ``ra_dbg:replay_log/4``
(``src/ra_dbg.erl:12-30``): re-read a server's persisted log (WAL +
segments) outside any running system and fold a machine over it,
optionally calling a callback per applied entry — for post-mortem
debugging of machine behavior.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Optional, Tuple

from ra_tpu_torch.log.log import Log
from ra_tpu_torch.log.segment_writer import SegmentWriter
from ra_tpu_torch.log.tables import TableRegistry
from ra_tpu_torch.log.wal import Wal
from ra_tpu_torch.machine import Machine, normalize_apply_result
from ra_tpu_torch.protocol import Command, USR


def replay_log(
    node_dir: str,
    uid: str,
    machine: Machine,
    on_entry: Optional[Callable[[int, Any, Any], None]] = None,
    to_index: Optional[int] = None,
) -> Tuple[Any, int]:
    """Rebuild the log from ``<node_dir>/{wal,data/<uid>}`` and apply all
    USR entries in order. Returns (final_machine_state, last_applied)."""
    tables = TableRegistry()
    sink: list = []
    sw = SegmentWriter(
        os.path.join(node_dir, "data"), tables, lambda u, e: sink.append((u, e)),
        threaded=False,
    )
    wal = Wal(
        os.path.join(node_dir, "wal"), tables, lambda u, e: sink.append((u, e)),
        segment_writer=sw, threaded=False, sync_method="none",
    )
    log = Log(uid, os.path.join(node_dir, "data", uid), tables, wal)
    snap = log.read_snapshot()
    if snap is not None:
        meta, state = snap
        from_idx = meta.index + 1
        mac_state = state
    else:
        from_idx = 1
        mac_state = machine.init({"name": uid})
    last = log.last_index_term()[0]
    hi = min(last, to_index) if to_index is not None else last
    applied = from_idx - 1
    for i in range(from_idx, hi + 1):
        e = log.fetch(i)
        if e is None:
            continue  # compacted dead entry
        cmd = e.cmd
        if isinstance(cmd, Command) and cmd.kind == USR:
            mac_state, reply, _effs = normalize_apply_result(
                machine.apply({"index": i, "term": e.term, "machine_version": 0},
                              cmd.data, mac_state)
            )
            if on_entry is not None:
                on_entry(i, cmd.data, mac_state)
        applied = i
    wal.close()
    sw.close()
    log.close()
    return mac_state, applied
