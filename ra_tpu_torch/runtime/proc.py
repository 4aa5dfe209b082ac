"""Chunked snapshot sender shared by the batch coordinator.

Holds only ``SnapshotSender``, copied from the JAX package's
``runtime/proc.py``. The batch coordinator imports it lazily to stream
an outbound snapshot transfer through a ``_SenderShim``. The actor
backend's ``ServerProc`` (and the ``server`` module it needs) is not
part of this package yet.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

from ra_tpu_torch.protocol import (
    CHUNK_INIT,
    CHUNK_LAST,
    CHUNK_NEXT,
    CHUNK_PRE,
    InstallSnapshotAck,
    InstallSnapshotResult,
    InstallSnapshotRpc,
    ServerId,
)


class SnapshotSender:
    """Chunked snapshot sender to one peer (the reference spawns a
    transient process per transfer: src/ra_server_proc.erl:1691-1735).

    The snapshot payload (meta, body source, live entries) is captured
    on the owning proc thread *before* this thread starts — the log is
    single-owner and must not be read concurrently. Preferred body
    source is ``chunk_iter``, a byte-chunk iterator reading the
    already-serialized body straight FROM DISK (the fd was opened at
    capture time, so the stream survives snapshot pruning) — peak sender
    memory is O(chunk), matching the reference's begin_read/read_chunk
    protocol (src/ra_snapshot.erl:135-210). ``state_obj`` is the
    fallback for memory-backed logs: pickled in one blob on this
    thread."""

    def __init__(
        self,
        proc: "ServerProc",
        to: ServerId,
        meta,
        state_obj,
        live_entries: list,
        term: int,
        chunk_size: int,
        chunk_iter=None,
    ):
        self.proc = proc
        self.to = to
        self.meta = meta
        self.state_obj = state_obj
        self.chunk_iter = chunk_iter
        self.chunk_size = chunk_size
        self.live_entries = live_entries
        self.term = term
        self.acks: "threading.Condition" = threading.Condition()
        self.last_ack: int = -1
        # receiver-paced credit window (docs/INTERNALS.md §21): highest
        # chunk_no the receiver has authorized = last ack's chunk_no +
        # its granted credits. Old-format acks default credits=1, which
        # reproduces stop-and-wait exactly.
        self.window_until: int = 0
        self.result: Optional[InstallSnapshotResult] = None
        self.thread = threading.Thread(
            target=self._run, name=f"ra-snap-send-{to[0]}", daemon=True
        )

    def start(self) -> None:
        self.thread.start()

    def on_ack(self, ack: InstallSnapshotAck) -> None:
        with self.acks:
            self.last_ack = max(self.last_ack, ack.chunk_no)
            credits = max(0, getattr(ack, "credits", 1))
            self.window_until = max(self.window_until, ack.chunk_no + credits)
            self.acks.notify()

    def on_result(self, res: InstallSnapshotResult) -> None:
        with self.acks:
            self.result = res
            self.acks.notify()

    def _await_ack(self, chunk_no: int, timeout: float) -> str:
        """-> "ack" | "result" (terminal reply: stop streaming) |
        "timeout". Wall clock on purpose (clock-seam audit, INTERNALS
        §19): this blocks a real Condition on a real sender thread —
        paths the simulation plane never runs."""
        deadline = time.monotonic() + timeout
        with self.acks:
            while True:
                if self.result is not None:
                    return "result"
                if self.last_ack >= chunk_no:
                    return "ack"
                left = deadline - time.monotonic()
                if left <= 0:
                    return "timeout"
                self.acks.wait(timeout=left)

    def _acquire_credit(self, no: int, timeout: float, send) -> str:
        """Block until the receiver's credit window covers chunk ``no``
        -> "ok" | "result" | "timeout". Credits ride acks, and a
        storage-blocked receiver grants 0 — with no chunks in flight it
        would never ack again, so starvation is probed by re-sending an
        already-acked chunk number (a duplicate the receiver re-acks
        with its CURRENT grant, without appending). Starvation past the
        ack timeout fails the transfer into the existing
        backoff-and-retry machinery (docs/INTERNALS.md §21)."""
        deadline = time.monotonic() + timeout
        while True:
            with self.acks:
                if self.result is not None:
                    return "result"
                if self.window_until >= no:
                    return "ok"
                left = deadline - time.monotonic()
                if left <= 0:
                    return "timeout"
                starved = not self.acks.wait(timeout=min(0.5, left))
                probe_no = self.last_ack
            if starved and probe_no >= 0:
                # outside the lock: transports may deliver inline
                count = getattr(self.proc.server, "_c", None)
                if count is not None:
                    count("snapshot_credit_waits")
                send(probe_no, CHUNK_NEXT)

    def _run(self) -> None:
        proc = self.proc
        try:
            if self.chunk_iter is not None:
                chunk_src = self.chunk_iter  # lazy reads from disk
            else:
                # memory-backed fallback: serialization happens HERE,
                # off the consensus threads — the state object was
                # captured immutably by the owning thread
                import pickle

                blob = pickle.dumps(self.state_obj)
                cs = self.chunk_size
                chunk_src = iter(
                    [blob[o : o + cs] for o in range(0, max(len(blob), 1), cs)]
                    or [b""]
                )
            timeout = proc.snapshot_ack_timeout_s

            def send(no, phase, data=b""):
                proc.transport.send(
                    self.to,
                    InstallSnapshotRpc(
                        term=self.term, leader_id=proc.server.id, meta=self.meta,
                        chunk_no=no, chunk_phase=phase, data=data,
                    ),
                    from_sid=proc.server.id,
                )

            def finish_on(status) -> bool:
                if status == "timeout":
                    proc.enqueue(("snapshot_send_failed", self.to))
                    return True
                if status == "result":
                    # terminal reply mid-transfer (e.g. stale term):
                    # surface it and stop streaming
                    proc.enqueue(("snapshot_send_done", self.to, self.result))
                    return True
                return False

            send(0, CHUNK_INIT)
            if finish_on(self._await_ack(0, timeout)):
                return
            no = 1
            if self.live_entries:
                send(no, CHUNK_PRE, self.live_entries)
                if finish_on(self._await_ack(no, timeout)):
                    return
                no += 1
            # body chunks stream under the receiver-granted credit
            # window (in-flight <= credits; old acks grant 1, which IS
            # stop-and-wait) — a one-chunk lookahead tags the final
            # chunk CHUNK_LAST while holding at most two chunks in
            # memory
            pending = next(chunk_src, b"")
            for chunk in chunk_src:
                if finish_on(self._acquire_credit(no, timeout, send)):
                    return
                send(no, CHUNK_NEXT, pending)
                no += 1
                pending = chunk
            if finish_on(self._acquire_credit(no, timeout, send)):
                return
            send(no, CHUNK_LAST, pending)
            # final result arrives as InstallSnapshotResult; wait for it
            deadline = time.monotonic() + timeout
            with self.acks:
                while self.result is None and time.monotonic() < deadline:
                    self.acks.wait(timeout=0.1)
            if self.result is None:
                proc.enqueue(("snapshot_send_failed", self.to))
            else:
                proc.enqueue(("snapshot_send_done", self.to, self.result))
        except Exception:  # noqa: BLE001
            proc.enqueue(("snapshot_send_failed", self.to))
