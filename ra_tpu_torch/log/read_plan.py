"""External log read plans.

The counterpart of the reference's ``ra_log_read_plan`` (reference:
``src/ra_log_read_plan.erl:10-31``): a server captures a small PLAN
(uid, indexes, storage locations) inside its event loop, and the CALLER
executes the actual reads outside the server process — memtable lookups
go through the node's shared TableRegistry (the ETS analog) and segment
reads open the files read-only. Heavy log reads (ra_kv-style
log-as-value-store gets) therefore never block the consensus path.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ra_tpu_torch.protocol import Entry


@dataclasses.dataclass(frozen=True)
class ReadPlan:
    uid: str
    node_name: str
    server_dir: str  # absolute path holding the segments/ subdir
    indexes: Tuple[int, ...]

    def execute(self, registry=None) -> Dict[int, Entry]:
        """Run the reads on the CALLING thread. ``registry`` defaults to
        the process-global node registry (in-proc nodes); for a purely
        file-based read (another process) pass ``registry=False`` to
        skip memtables and read segments only."""
        import os

        out: Dict[int, Entry] = {}
        missing: List[int] = []
        mt = None
        if registry is not False:
            if registry is None:
                from ra_tpu_torch.runtime.transport import registry as node_registry

                registry = node_registry()
            node = registry.get(self.node_name)
            if node is not None:
                mt = node.tables.mem_table(self.uid)
        for i in self.indexes:
            e = mt.get(i) if mt is not None else None
            if e is not None:
                out[i] = e
            else:
                missing.append(i)
        if missing:
            segdir = os.path.join(self.server_dir, "segments")
            if os.path.isdir(segdir):
                from ra_tpu_torch.log.segments import SegmentSet

                # fresh read-only view; binary index mode keeps memory
                # flat for sparse reads over many segments. readonly
                # skips compaction recovery — a caller-side read must
                # not unlink the owner's in-flight compaction temps.
                segs = SegmentSet(segdir, index_mode="binary", readonly=True)
                try:
                    for i in missing:
                        e = segs.fetch(i)
                        if e is not None:
                            out[i] = e
                finally:
                    segs.close()
        return out


def exec_read_plan(plan: ReadPlan, registry=None) -> Dict[int, Entry]:
    """Module-level convenience mirroring the reference API shape."""
    return plan.execute(registry=registry)
