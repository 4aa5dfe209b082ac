"""Scripted fault-injection (nemesis) harness.

Capability parity with the reference's ``test/nemesis.erl`` scenario
runner (``{part, Nodes, Ms} | {wait, Ms} | {app_restart, Servers} |
heal`` — test/nemesis.erl:29-33, over inet_tcp_proxy): here the faults
drive the in-proc transport's partition hooks, so the same scripts work
against actor nodes and batch coordinators. Beyond network faults, the
vocabulary covers DISK faults and infra-thread crashes through the
failpoint registry (``ra_tpu_torch.faults``) — the storage half of the fault
model the BlackWater-style robustness work calls for.
"""

from __future__ import annotations

import time
from typing import Any, List, Sequence, Tuple

from ra_tpu_torch import faults
from ra_tpu_torch.runtime.transport import registry as node_registry


def _block_pair(a: str, b: str) -> None:
    na, nb = node_registry().get(a), node_registry().get(b)
    if na is not None:
        na.transport.block(a, b)
    if nb is not None:
        nb.transport.block(b, a)


def heal_all() -> None:
    for name in node_registry().names():
        node = node_registry().get(name)
        if node is not None:
            node.transport.unblock_all()


def partition(minority: Sequence[str], rest: Sequence[str]) -> None:
    for a in minority:
        for b in rest:
            _block_pair(a, b)


def partition_oneway(a: str, b: str) -> None:
    """Asymmetric partition: ``a``'s sends to ``b`` are dropped while
    ``b -> a`` (and every other direction) stays up. The transports'
    ``blocked`` sets are already directional (``InProcTransport`` /
    ``TcpTransport`` check ``(from, to)`` on send), so this only arms
    one side of what ``partition`` arms.

    The canonical use is the stale-leader scenario: block each
    follower's path BACK to the leader and the leader keeps streaming
    AppendEntries (resetting follower election timers) while never
    hearing an ack — without check-quorum (server.py leader tick) it
    would reign uselessly forever and wedge every client on it."""
    na = node_registry().get(a)
    if na is not None:
        na.transport.block(a, b)


def crash_thread(node: str, which: str) -> None:
    """Arm a one-shot thread-crash failpoint against ``node``'s WAL or
    segment-writer loop (``which`` in {"wal", "segment_writer"}). The
    loop hits its site within one wait tick (≤0.5s) even when idle; the
    node's infra supervisor then detects and heals."""
    if which not in ("wal", "segment_writer"):
        raise ValueError(f"unknown infra thread {which!r}")
    faults.arm(f"{which}.thread", ("crash",), ("one_shot",), scope=node)


def heal_disk() -> None:
    """Disarm every failpoint (the disk-fault analog of heal_all)."""
    faults.disarm_all()


def run_scenario(script: List[Tuple], api_mod=None) -> None:
    """Execute a nemesis script. Steps:

    ("part", [nodes...], [other nodes...], seconds) — partition then heal
    ("part_hold", [nodes...], [other nodes...])     — partition, no heal
    ("part_oneway", a, b)                           — drop a->b only
    ("wait", seconds)
    ("restart", [server_ids...])                    — restart server procs
    ("heal",)
    ("disk_fault", site, action, trigger[, node])   — arm a failpoint
        (grammar in ra_tpu_torch.faults; node scopes it to one node's storage)
    ("crash_thread", node, which)                   — kill an infra
        thread ("wal" | "segment_writer") on node via a one-shot
        crash failpoint
    ("heal_disk",)                                  — disarm everything
    """
    for step in script:
        op = step[0]
        if op == "part":
            _, minority, rest, secs = step
            partition(minority, rest)
            time.sleep(secs)
            heal_all()
        elif op == "part_hold":
            _, minority, rest = step
            partition(minority, rest)
        elif op == "part_oneway":
            _, a, b = step
            partition_oneway(a, b)
        elif op == "wait":
            time.sleep(step[1])
        elif op == "restart":
            from ra_tpu_torch import api as _api

            for sid in step[1]:
                (api_mod or _api).restart_server(sid)
        elif op == "heal":
            heal_all()
        elif op == "disk_fault":
            _, site, action, trigger = step[:4]
            faults.arm(site, tuple(action), tuple(trigger),
                       scope=step[4] if len(step) > 4 else None)
        elif op == "crash_thread":
            _, node, which = step
            crash_thread(node, which)
        elif op == "heal_disk":
            heal_disk()
        else:
            raise ValueError(f"unknown nemesis step {step!r}")
