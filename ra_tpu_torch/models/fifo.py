"""FIFO queue machine — the quorum-queue-precursor workload.

Capability model: the reference's ``test/ra_fifo.erl`` (a full FIFO queue
machine used by its nemesis/partition suites): checkout-based consumers,
per-consumer in-flight settlement, monitor-driven consumer cleanup,
release-cursor emission once everything settled.

Commands:
  ("enqueue", msg)
  ("checkout", consumer_id[, prefetch])  -- register a consumer
  ("dequeue", consumer_id)           -- one-shot take (auto-settled)
  ("settle", consumer_id, msg_id)
  ("return", consumer_id, msg_id)    -- redeliver
  ("cancel", consumer_id)
  ("purge",)                         -- drop all ready messages
  ("down", consumer_id, info)        -- builtin monitor DOWN
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict, deque
from typing import Any, Dict, Optional, Tuple

from ra_tpu_torch.effects import Monitor, ReleaseCursor, SendMsg
from ra_tpu_torch.machine import Machine


@dataclasses.dataclass
class FifoState:
    queue: deque = dataclasses.field(default_factory=deque)  # (msg_id, msg)
    next_msg_id: int = 1
    # consumer_id -> {msg_id: msg} in-flight
    consumers: "OrderedDict[Any, Dict[int, Any]]" = dataclasses.field(
        default_factory=OrderedDict
    )
    # consumer_id -> prefetch credit (max in-flight)
    prefetch: Dict[Any, int] = dataclasses.field(default_factory=dict)
    service_queue: deque = dataclasses.field(default_factory=deque)  # ready consumers
    low_settled_index: int = 0

    def clone(self) -> "FifoState":
        st = FifoState(
            queue=deque(self.queue),
            next_msg_id=self.next_msg_id,
            consumers=OrderedDict((k, dict(v)) for k, v in self.consumers.items()),
            prefetch=dict(self.prefetch),
            service_queue=deque(self.service_queue),
            low_settled_index=self.low_settled_index,
        )
        return st


# Test-only failpoint: re-introduces the reversed-requeue bug (a
# multi-message consumer down redelivers highest msg_id first) that the
# comment in the down/cancel branch below guards against. Exists solely
# so the simulation plane can demonstrate end-to-end that its schedule
# explorer finds the violation and the shrinker minimizes the repro
# (tests/test_sim.py, docs/INTERNALS.md §19). Never set outside tests.
SIM_BUG_REVERSED_REQUEUE = False


class FifoMachine(Machine):
    def init(self, config) -> FifoState:
        return FifoState()

    def apply(self, meta, cmd, state: FifoState):
        if not isinstance(cmd, tuple) or not cmd:
            return state, None
        st = state.clone()
        op = cmd[0]
        effects = []
        if op == "enqueue":
            msg_id = st.next_msg_id
            st.next_msg_id += 1
            st.queue.append((msg_id, cmd[1]))
            self._service(st, effects)
            return st, ("ok", msg_id), effects
        if op == "checkout":
            cid = cmd[1]
            credit = cmd[2] if len(cmd) > 2 else 1
            if cid not in st.consumers:
                st.consumers[cid] = {}
                effects.append(Monitor("process", cid, "machine"))
            st.prefetch[cid] = max(int(credit), 1)
            if cid not in st.service_queue:
                st.service_queue.append(cid)
            self._service(st, effects)
            return st, ("ok", None), effects
        if op == "dequeue":
            # one-shot take with auto-settlement (the reference's
            # dequeue/settled checkout mode)
            if not st.queue:
                return st, ("ok", None), effects
            msg_id, msg = st.queue.popleft()
            if not st.queue and all(not f for f in st.consumers.values()):
                effects.append(ReleaseCursor(meta["index"], st))
            return st, ("ok", (msg_id, msg)), effects
        if op == "purge":
            n = len(st.queue)
            st.queue.clear()
            if all(not f for f in st.consumers.values()):
                effects.append(ReleaseCursor(meta["index"], st))
            return st, ("ok", n), effects
        if op == "settle":
            _, cid, msg_id = cmd
            inflight = st.consumers.get(cid, {})
            inflight.pop(msg_id, None)
            if cid in st.consumers and cid not in st.service_queue:
                st.service_queue.append(cid)
            self._service(st, effects)
            if not st.queue and all(not f for f in st.consumers.values()):
                effects.append(ReleaseCursor(meta["index"], st))
            return st, ("ok", None), effects
        if op == "return":
            _, cid, msg_id = cmd
            inflight = st.consumers.get(cid, {})
            msg = inflight.pop(msg_id, None)
            if msg is not None:
                st.queue.appendleft((msg_id, msg))
            # the returning consumer is ready again (else the returned
            # message sits undelivered until an unrelated op services it)
            if cid in st.consumers and cid not in st.service_queue:
                st.service_queue.append(cid)
            self._service(st, effects)
            return st, ("ok", None), effects
        if op in ("cancel", "down"):
            cid = cmd[1]
            st.prefetch.pop(cid, None)
            inflight = st.consumers.pop(cid, None)
            if cid in st.service_queue:
                st.service_queue.remove(cid)
            if inflight:
                # requeue at the FRONT in original order: appendleft
                # reverses, so walk the ids highest-first — the lowest
                # msg_id must end up at the head or a multi-message down
                # (prefetch > 1) redelivers out of FIFO order
                for msg_id, msg in sorted(
                    inflight.items(), reverse=not SIM_BUG_REVERSED_REQUEUE
                ):
                    st.queue.appendleft((msg_id, msg))
                self._service(st, effects)
            return st, ("ok", None), effects
        return state, ("error", "unknown_op")

    def _service(self, st: FifoState, effects) -> None:
        """Deliver queued messages to ready consumers, up to each
        consumer's prefetch credit (reference: checkout credit)."""
        while st.queue and st.service_queue:
            cid = st.service_queue[0]
            inflight = st.consumers.get(cid)
            if inflight is None:
                st.service_queue.popleft()
                continue
            credit = st.prefetch.get(cid, 1)
            if len(inflight) >= credit:
                st.service_queue.popleft()
                continue  # at capacity
            # fill up to credit while messages remain
            while st.queue and len(inflight) < credit:
                msg_id, msg = st.queue.popleft()
                inflight[msg_id] = msg
                effects.append(
                    SendMsg(cid, ("delivery", msg_id, msg), ("ra_event",))
                )
            if len(inflight) >= credit:
                # only at capacity does the consumer leave the ready
                # queue; with spare credit it must keep receiving later
                # enqueues (the outer loop's queue check terminates)
                st.service_queue.popleft()
            else:
                break  # queue drained; consumer stays ready

    def overview(self, state: FifoState):
        return {
            "type": "fifo",
            "ready": len(state.queue),
            "consumers": len(state.consumers),
            "in_flight": sum(len(f) for f in state.consumers.values()),
            "prefetch": dict(state.prefetch),
        }
