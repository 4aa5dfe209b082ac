"""Simulated network: schedule-driven delivery with seeded faults.

Implements the ``InProcTransport`` seam (``send`` returning False on
known-undeliverable, directional ``blocked`` pairs, ``node_alive`` /
``proc_alive``) over the sim run queue, so the pure ``Server`` cores and
the nemesis plane (``NemesisContext`` closures -> ``block`` /
``unblock_all``) drive it unchanged.

Every send draws a stable sequence number and one decision from the
network's OWN rng stream (decorrelated from the workload/election
streams): deliver after the base latency, drop in flight, duplicate, or
delay. Blocked directed pairs refuse at the sender (``send`` -> False,
like a closed connection: the caller marks the peer disconnected);
probabilistic drops are silent in-flight loss (``send`` -> True), like
a lossy link. Both are recorded in the world trace keyed by the send
seq, which is what makes a failing schedule replayable and shrinkable.
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, Optional, Set, Tuple

from ra_tpu_torch.protocol import ServerId
from ra_tpu_torch.sim.scheduler import SimScheduler


class SimNetwork:
    def __init__(
        self,
        sched: SimScheduler,
        seed: int,
        drop_p: float = 0.0,
        dup_p: float = 0.0,
        delay_p: float = 0.0,
        delay_ms_max: int = 50,
        base_latency_ms: int = 1,
        ctr=None,
        trace: Optional[Callable[..., None]] = None,
    ) -> None:
        self.sched = sched
        self.rng = random.Random((seed << 8) ^ 0x4E4554)  # "NET"
        self.drop_p = drop_p
        self.dup_p = dup_p
        self.delay_p = delay_p
        self.delay_ms_max = delay_ms_max
        self.base_latency_ms = base_latency_ms
        self.ctr = ctr
        self.trace = trace or (lambda *a: None)
        # node_name -> deliver(to_sid, msg, from_sid); None while crashed
        self._deliver: Dict[str, Optional[Callable[[ServerId, Any, Optional[ServerId]], None]]] = {}
        self.blocked: Set[Tuple[str, str]] = set()  # directed (from, to)
        self.send_seq = 0
        self.dropped = 0

    def _c(self, field: str, n: int = 1) -> None:
        if self.ctr is not None:
            self.ctr.incr(field, n)

    # -- node registry -------------------------------------------------------

    def attach(self, node_name: str, deliver) -> None:
        self._deliver[node_name] = deliver

    def detach(self, node_name: str) -> None:
        self._deliver[node_name] = None

    # -- fault injection (InProcTransport seam; NemesisContext closures) ------

    def block(self, a: str, b: str) -> None:
        self.blocked.add((a, b))

    def unblock_all(self) -> None:
        self.blocked.clear()

    # -- aliveness (InProcTransport seam) --------------------------------------

    def node_alive(self, node_name: str) -> bool:
        return self._deliver.get(node_name) is not None

    def proc_alive(self, sid: ServerId) -> bool:
        return self.node_alive(sid[1])

    def known_nodes(self):
        return list(self._deliver.keys())

    # -- sending ----------------------------------------------------------------

    def send(self, frm: ServerId, to: ServerId, msg: Any) -> bool:
        """Schedule delivery; False when known-undeliverable (dead node
        or blocked directed pair), True otherwise — including silent
        in-flight loss, which a sender cannot observe."""
        self.send_seq += 1
        seq = self.send_seq
        if (frm[1], to[1]) in self.blocked or not self.node_alive(to[1]):
            self.dropped += 1
            self._c("sim_msgs_dropped")
            return False
        # one decision per send, one rng draw shape per branch
        r = self.rng.random()
        kind = type(msg).__name__
        if r < self.drop_p:
            self.dropped += 1
            self._c("sim_msgs_dropped")
            self.trace("drop", seq, frm[1], to[1], kind)
            return True
        # the single draw partitions [0,1) into disjoint fault bands:
        # [0, drop) | [drop, drop+delay) | [.., +dup) | the rest delivers
        delay = self.base_latency_ms
        if r < self.drop_p + self.delay_p:
            delay += 1 + self.rng.randrange(self.delay_ms_max)
            self._c("sim_msgs_delayed")
            self.trace("delay", seq, frm[1], to[1], kind, delay)
        self._arm(seq, frm, to, msg, delay, kind)
        if self.drop_p + self.delay_p <= r < self.drop_p + self.delay_p + self.dup_p:
            dup_delay = delay + 1 + self.rng.randrange(self.delay_ms_max)
            self._c("sim_msgs_duplicated")
            self.trace("dup", seq, frm[1], to[1], kind, dup_delay)
            self._arm(seq, frm, to, msg, dup_delay, kind)
        return True

    def _arm(self, seq: int, frm: ServerId, to: ServerId, msg: Any,
             delay_ms: int, kind: str) -> None:
        def deliver() -> None:
            # re-checked at delivery time: a partition or crash that
            # landed while the message was in flight eats it
            if (frm[1], to[1]) in self.blocked:
                self.dropped += 1
                self._c("sim_msgs_dropped")
                return
            fn = self._deliver.get(to[1])
            if fn is None:
                self.dropped += 1
                self._c("sim_msgs_dropped")
                return
            self._c("sim_msgs_delivered")
            self.trace("deliver", seq, frm[1], to[1], kind)
            fn(to, msg, frm)

        self.sched.after_ms(delay_ms, deliver)
