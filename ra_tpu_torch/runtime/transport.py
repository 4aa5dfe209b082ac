"""Transport: async server-to-server messaging with backpressure status.

Abstraction over the reference's use of Erlang distribution (async casts
with noconnect/nosuspend, reference: src/ra_server_proc.erl:1875-1881,
2094-2110). Two implementations:

- ``InProcTransport``: every "node" lives in this process; sends are
  direct mailbox enqueues. Supports scripted fault injection (drop /
  partition) for nemesis tests — the counterpart of the reference's
  inet_tcp_proxy trick.
- ``TcpTransport`` (ra_tpu_torch.runtime.tcp): length-framed pickle over TCP
  for real multi-process clusters.

Delivery is at-most-once and unordered across peers (like the reference
across reconnects); the consensus protocol tolerates loss.
"""

from __future__ import annotations

import threading
from typing import Any, Callable, Dict, Optional, Set, Tuple

from ra_tpu_torch.protocol import ServerId


class NodeRegistry:
    """Process-global registry of in-proc nodes (name -> RaNode)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.nodes: Dict[str, Any] = {}

    def register(self, name: str, node: Any) -> None:
        with self._lock:
            if name in self.nodes:
                raise RuntimeError(f"node {name!r} already registered")
            self.nodes[name] = node

    def unregister(self, name: str) -> None:
        with self._lock:
            self.nodes.pop(name, None)

    def get(self, name: str) -> Optional[Any]:
        return self.nodes.get(name)

    def names(self):
        return list(self.nodes.keys())


_global_registry = NodeRegistry()


def registry() -> NodeRegistry:
    return _global_registry


class InProcTransport:
    def __init__(self, node_name: str, nodes: Optional[NodeRegistry] = None):
        self.node_name = node_name
        self.nodes = nodes or _global_registry
        self._lock = threading.Lock()
        self.blocked: Set[Tuple[str, str]] = set()  # directed (from, to) node pairs
        self.drop_fn: Optional[Callable[[ServerId, Any], bool]] = None
        self.dropped = 0

    # -- fault injection ---------------------------------------------------

    def block(self, a: str, b: str) -> None:
        with self._lock:
            self.blocked.add((a, b))

    def unblock_all(self) -> None:
        with self._lock:
            self.blocked.clear()

    # -- sending -----------------------------------------------------------

    def send(self, to: ServerId, msg: Any, from_sid: Optional[ServerId] = None) -> bool:
        """Async send; returns False when known-undeliverable (node down
        or blocked) so callers can update peer status."""
        _, node_name = to
        if (self.node_name, node_name) in self.blocked:
            self.dropped += 1
            return False
        if self.drop_fn is not None and self.drop_fn(to, msg):
            self.dropped += 1
            return False
        node = self.nodes.get(node_name)
        if node is None or not getattr(node, "running", False):
            self.dropped += 1
            return False
        return node.deliver(to, msg, from_sid)

    def node_alive(self, node_name: str) -> bool:
        if (self.node_name, node_name) in self.blocked:
            return False
        node = self.nodes.get(node_name)
        return node is not None and getattr(node, "running", False)

    def proc_alive(self, sid: ServerId) -> bool:
        """Best-effort: is the server proc behind sid still running? Used
        to distinguish live leader contact from stale in-flight messages
        of a dead leader. Over in-proc transport this is exact; remote
        transports approximate with node aliveness."""
        if not self.node_alive(sid[1]):
            return False
        node = self.nodes.get(sid[1])
        procs = getattr(node, "procs", None)
        if procs is None:
            return True
        return sid[0] in procs

    def known_nodes(self):
        return self.nodes.names()
