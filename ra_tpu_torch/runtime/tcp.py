"""TCP transport: real multi-process/multi-host clusters.

The distributed communication backend (counterpart of the reference's
use of Erlang distribution: async casts with noconnect/nosuspend
semantics and backpressure-aware peer status, reference:
src/ra_server_proc.erl:1875-1881, 2094-2110):

- node names are ``host:port`` strings; each node runs one
  ``TcpTransport`` that accepts inbound connections and lazily dials
  outbound ones;
- wire format: length-framed ``HMAC-SHA256(cookie) || pickle`` of
  ``(to_name, from_sid, msg)``. Every frame is authenticated with a
  shared-secret cookie before it is unpickled (the counterpart of the
  Erlang distribution cookie): a frame with a bad MAC kills the
  connection without touching pickle. **Trust model**: inbound frames
  deserialize through a RESTRICTED unpickler — only the protocol/effect
  vocabulary, plain containers, and application-registered payload
  types resolve (``register_wire_type``); a cookie holder cannot smuggle
  os/subprocess/functools gadget chains. Still set a secret cookie
  (``RA_TPU_COOKIE`` env or the ``cookie=`` arg): authenticated peers
  can of course drive the full management plane;
- sends are async and never block the caller: each peer has a bounded
  outbox drained by a writer thread — when the outbox overflows, sends
  report failure (the peer status flips, exactly like distribution
  buffer backpressure in the reference);
- at-most-once delivery; reconnection is lazy on next send.

``TcpNodeBridge`` glues a transport to a local RaNode/BatchCoordinator:
inbound messages are delivered into the local registry, and the node's
``InProcTransport`` is replaced so outbound remote sends go over TCP
while local names stay in-process.
"""

from __future__ import annotations

import hashlib
import hmac
import logging
import os
import pickle
import socket
import struct
import threading
from collections import deque
from typing import Any, Dict, Optional, Tuple

from ra_tpu_torch import faults
from ra_tpu_torch.protocol import ServerId

logger = logging.getLogger("ra_tpu_torch")

_LEN = struct.Struct("<I")
MAX_FRAME = 64 * 1024 * 1024
_MAC_LEN = 16  # truncated HMAC-SHA256 prefix on every frame

# restricted wire deserialization: see ra_tpu_torch.utils.wire (inbound
# frames resolve classes through an allowlist — a cookie holder cannot
# smuggle gadget chains). Re-exported here for discoverability.
from ra_tpu_torch.utils.wire import (  # noqa: F401 (re-export)
    register_wire_type,
    unregister_wire_type,
    wire_loads as _wire_loads,
)


class _Peer:
    def __init__(self, addr: Tuple[str, int], outbox_cap: int):
        self.addr = addr
        # elements are (wire_bytes, frame_count): wire_bytes is already
        # length-prefixed, so the writer joins and sends without any
        # per-frame work; a natively sealed batch rides as ONE element
        # carrying its frame count for exact drop accounting
        self.outbox: deque = deque()
        self.cap = outbox_cap
        self.cv = threading.Condition()
        self.sock: Optional[socket.socket] = None
        self.thread: Optional[threading.Thread] = None
        self.closed = False


class TcpTransport:
    """Duck-type compatible with InProcTransport (send / node_alive /
    proc_alive / blocked set for fault injection).

    The ``blocked`` set holds DIRECTED ``(from, to)`` node pairs checked
    on the sender's side only, so the nemesis plane's one-way partitions
    (``testing.partition_oneway`` / the soak's ``oneway`` dimension) work
    identically over TCP: arming ``(a, b)`` on a's transport drops a's
    sends to b while b's sends to a still flow — the stale-leader
    scenario (acks lost, AppendEntries delivered) needs exactly that
    asymmetry. A symmetric partition arms both directions, each on its
    own side's transport."""

    def __init__(
        self,
        node_name: str,
        deliver,  # fn(to_sid, msg, from_sid) -> bool
        bind: Optional[Tuple[str, int]] = None,
        outbox_cap: int = 10_000,
        cookie: Optional[str] = None,
    ):
        host, port = node_name.rsplit(":", 1)
        self.node_name = node_name
        self.deliver = deliver
        self.outbox_cap = outbox_cap
        self._cookie = (
            cookie or os.environ.get("RA_TPU_COOKIE") or "ra_tpu_default_cookie"
        ).encode()
        self.blocked: set = set()
        self.drop_fn = None
        self.dropped = 0
        self._peers: Dict[str, _Peer] = {}
        self._lock = threading.Lock()
        self._closed = False

        bind_addr = bind or (host, int(port))
        self._server = socket.create_server(bind_addr, reuse_port=False)
        self._server.settimeout(0.5)
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"ra-tcp-accept-{node_name}", daemon=True
        )
        self._accept_thread.start()
        # liveness: ping every known peer; a peer is alive while pongs
        # are fresh. With a ``detector`` (ra_tpu_torch.detector.
        # PhiAccrualDetector) attached, pong ARRIVALS feed it and
        # node_alive uses the adaptive phi window instead of the fixed
        # timeout — jittery links widen their window, steady links
        # tighten (the aten role; both backends share this transport,
        # so liveness semantics stay uniform)
        self.ping_interval_s = 0.2
        self.pong_timeout_s = 1.0
        self.detector = None
        self._last_pong: Dict[str, float] = {}
        # set by the owning node: called with a ServerId when a remote
        # peer announces one of its procs died
        self.on_proc_down_cb = None
        # management plane (reference: rpc:call start/restart/delete on
        # remote nodes, src/ra_server_sup_sup.erl:33-50): the owning
        # node sets on_mgmt_cb(op, kwargs) -> result; mgmt_call() is the
        # client side
        self.on_mgmt_cb = None
        self._mgmt_futs: Dict[int, Tuple[threading.Event, dict]] = {}
        self._mgmt_seq = 0
        self._mgmt_lock = threading.Lock()
        self._ping_thread = threading.Thread(
            target=self._ping_loop, name=f"ra-tcp-ping-{node_name}", daemon=True
        )
        self._ping_thread.start()

    # ------------------------------------------------------------------

    def send(self, to: ServerId, msg: Any, from_sid: Optional[ServerId] = None) -> bool:
        node_name = to[1]
        if node_name == self.node_name:
            return self.deliver(to, msg, from_sid)
        if (self.node_name, node_name) in self.blocked or self._closed:
            self.dropped += 1
            return False
        if self.drop_fn is not None and self.drop_fn(to, msg):
            self.dropped += 1
            return False
        try:
            # injected send fault: raise -> reported undeliverable (the
            # caller's resend machinery covers it); latency just delays
            faults.fire("tcp.send", self.node_name)
        except OSError:
            self.dropped += 1
            return False
        peer = self._peer(node_name)
        if peer is None:
            self.dropped += 1
            return False
        from ra_tpu_torch.protocol import sanitize_for_wire

        try:
            frame = self._seal(
                pickle.dumps((to[0], from_sid, sanitize_for_wire(msg)))
            )
        except Exception:  # noqa: BLE001 — unpicklable payload
            self.dropped += 1
            return False
        if len(frame) > MAX_FRAME:
            # the receiver would kill the connection (and every queued
            # frame behind this one); report failure to the caller instead
            self.dropped += 1
            return False
        with peer.cv:
            if len(peer.outbox) >= peer.cap:
                # backpressure: report undeliverable, do not block
                self.dropped += 1
                return False
            peer.outbox.append((_LEN.pack(len(frame)) + frame, 1))
            peer.cv.notify()
        return True

    def send_batch(self, node_name: str, msgs) -> int:
        """Batch send of ``(to_sid, msg, from_sid)`` triples to ONE
        node: every frame is sealed (HMAC) + length-prefixed in a
        single GIL-released native call (ra_tpu_torch.native.seal_frames)
        and enqueued as one outbox element — the egress fan-out's
        native fast path (docs/INTERNALS.md §18). Byte-identical on
        the wire to per-message ``send``. Returns the number of frames
        enqueued (drops counted per message, exactly like ``send``),
        or -1 when the native sealer is unavailable or a tcp failpoint
        is armed — the caller falls back to per-message ``send`` so
        fire/mangle fault semantics stay per frame."""
        from ra_tpu_torch import native as _native

        if (
            node_name == self.node_name
            or self._closed
            or faults.any_armed("tcp.send", "tcp.frame")
            or not _native.entry_points()["egress"]
        ):
            return -1
        if (self.node_name, node_name) in self.blocked:
            self.dropped += len(msgs)
            return 0
        peer = self._peer(node_name)
        if peer is None:
            self.dropped += len(msgs)
            return 0
        from ra_tpu_torch.protocol import sanitize_for_wire

        drop = self.drop_fn
        payloads = []
        for to, msg, frm in msgs:
            if drop is not None and drop(to, msg):
                self.dropped += 1
                continue
            try:
                p = pickle.dumps((to[0], frm, sanitize_for_wire(msg)))
            except Exception:  # noqa: BLE001 — unpicklable payload
                self.dropped += 1
                continue
            if len(p) + _MAC_LEN > MAX_FRAME:
                self.dropped += 1
                continue
            payloads.append(p)
        if not payloads:
            return 0
        blob = _native.seal_frames(payloads, self._cookie, _MAC_LEN)
        if blob is None:
            # the lib vanished between the probe and the call (never in
            # practice); at-most-once transport: count as dropped, the
            # resend machinery covers it
            self.dropped += len(payloads)
            return 0
        with peer.cv:
            if len(peer.outbox) >= peer.cap:
                self.dropped += len(payloads)
                return 0
            peer.outbox.append((blob, len(payloads)))
            peer.cv.notify()
        return len(payloads)

    def node_alive(self, node_name: str) -> bool:
        if node_name == self.node_name:
            return not self._closed
        if (self.node_name, node_name) in self.blocked:
            return False
        peer = self._peers.get(node_name)
        if peer is None or peer.sock is None:
            return False
        import time as _t

        last = self._last_pong.get(node_name)
        if last is None:
            return False
        d = self.detector
        if d is not None:
            return not d.suspect(node_name)
        return (_t.monotonic() - last) < self.pong_timeout_s

    def proc_alive(self, sid: ServerId) -> bool:
        # remote proc liveness is not observable over TCP; approximate
        # with connection liveness (documented contract in transport.py)
        return self.node_alive(sid[1])

    def known_nodes(self):
        return [self.node_name] + list(self._peers.keys())

    def block(self, a: str, b: str) -> None:
        self.blocked.add((a, b))

    def unblock_all(self) -> None:
        self.blocked.clear()

    def close(self) -> None:
        self._closed = True
        try:
            self._server.close()
        except OSError:
            pass
        with self._lock:
            peers = list(self._peers.values())
        for p in peers:
            with p.cv:
                p.closed = True
                p.cv.notify_all()

    # ------------------------------------------------------------------

    def _seal(self, payload: bytes) -> bytes:
        mac = hmac.new(self._cookie, payload, hashlib.sha256).digest()[:_MAC_LEN]
        # injected frame corruption (torn -> truncated, raise -> bit
        # flip): the receiver's MAC check kills the connection, the
        # sender reconnects lazily — the wire-corruption drill
        return faults.mangle("tcp.frame", mac + payload, self.node_name)

    def _open(self, frame: bytes) -> Optional[bytes]:
        if len(frame) < _MAC_LEN:
            return None
        mac, payload = frame[:_MAC_LEN], frame[_MAC_LEN:]
        want = hmac.new(self._cookie, payload, hashlib.sha256).digest()[:_MAC_LEN]
        return payload if hmac.compare_digest(mac, want) else None

    def _peer(self, node_name: str) -> Optional[_Peer]:
        with self._lock:
            if self._closed:
                # close() already swept the peer table: a late send
                # must not spawn a writer that would park (untimed)
                # with nobody left to close it
                return None
            p = self._peers.get(node_name)
            if p is not None:
                return p
            try:
                host, port = node_name.rsplit(":", 1)
                p = _Peer((host, int(port)), self.outbox_cap)
            except ValueError:
                return None
            self._peers[node_name] = p
            p.thread = threading.Thread(
                target=self._writer_loop, args=(p,),
                name=f"ra-tcp-out-{node_name}", daemon=True,
            )
            p.thread.start()
            return p

    def _writer_loop(self, peer: _Peer) -> None:
        while not self._closed and not peer.closed:
            with peer.cv:
                while not peer.outbox and not peer.closed and not self._closed:
                    # event-driven idle: every enqueue notifies the
                    # peer cv and close() marks peer.closed under it —
                    # an idle sender consumes zero CPU
                    # (docs/INTERNALS.md §16)
                    peer.cv.wait()
                if peer.closed or self._closed:
                    break
                frames = []
                nf = 0
                while peer.outbox and len(frames) < 512:
                    chunk, n = peer.outbox.popleft()
                    frames.append(chunk)
                    nf += n
            if peer.sock is None:
                try:
                    peer.sock = socket.create_connection(peer.addr, timeout=2)
                    peer.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                except OSError:
                    self.dropped += nf
                    peer.sock = None
                    continue
            try:
                # elements are pre-framed at enqueue: the writer is a
                # pure join + sendall, no per-frame length packing
                peer.sock.sendall(b"".join(frames))
            except OSError:
                self.dropped += nf
                try:
                    peer.sock.close()
                except OSError:
                    pass
                peer.sock = None  # reconnect lazily on next batch

    def _ping_loop(self) -> None:
        import time as _t

        while not self._closed:
            with self._lock:
                peers = list(self._peers.keys())
            for name in peers:
                self._enqueue_control(name, "__ping__")
            _t.sleep(self.ping_interval_s)

    def _enqueue_control(self, node_name: str, kind: str, payload=None) -> bool:
        peer = self._peer(node_name)
        if peer is None:
            return False  # unaddressable node name
        frame = self._seal(pickle.dumps((kind, self.node_name, payload)))
        with peer.cv:
            if len(peer.outbox) >= peer.cap:
                return False
            peer.outbox.append((_LEN.pack(len(frame)) + frame, 1))
            peer.cv.notify()
        return True

    def mgmt_call(self, node_name: str, op: str, kwargs: dict, timeout: float = 10.0):
        """Synchronous management RPC against a remote node (start /
        restart / stop / delete server, overview). Raises on timeout or
        remote error."""
        with self._mgmt_lock:
            self._mgmt_seq += 1
            corr = self._mgmt_seq
            ev, slot = threading.Event(), {}
            self._mgmt_futs[corr] = (ev, slot)
        try:
            if not self._enqueue_control(node_name, "__mgmt__", (corr, op, kwargs)):
                raise RuntimeError(
                    f"mgmt {op}: node {node_name!r} unaddressable or outbox full"
                )
            if not ev.wait(timeout):
                raise TimeoutError(f"mgmt {op} on {node_name} timed out")
        finally:
            with self._mgmt_lock:
                self._mgmt_futs.pop(corr, None)
        status, value = slot["r"]
        if status != "ok":
            raise RuntimeError(f"mgmt {op} on {node_name} failed: {value}")
        return value

    def broadcast_proc_down(self, sid: ServerId) -> None:
        """Tell every connected peer that a local server proc died (the
        TCP stand-in for remote process monitors)."""
        with self._lock:
            peers = list(self._peers.keys())
        for name in peers:
            self._enqueue_control(name, "__proc_down__", sid)

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _addr = self._server.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(
                target=self._reader_loop, args=(conn,),
                name="ra-tcp-in", daemon=True,
            ).start()

    def _reader_loop(self, conn: socket.socket) -> None:
        conn.settimeout(None)
        buf = b""
        try:
            while not self._closed:
                data = conn.recv(1 << 16)
                if not data:
                    return
                buf += data
                while len(buf) >= _LEN.size:
                    (ln,) = _LEN.unpack_from(buf)
                    if ln > MAX_FRAME:
                        return  # corrupt/hostile stream: drop connection
                    if len(buf) < _LEN.size + ln:
                        break
                    frame = buf[_LEN.size : _LEN.size + ln]
                    buf = buf[_LEN.size + ln :]
                    payload = self._open(frame)
                    if payload is None:
                        return  # unauthenticated frame: drop connection
                    try:
                        to_name, from_sid, msg = _wire_loads(payload)
                    except Exception:  # noqa: BLE001
                        # with the wire allowlist this is the primary
                        # failure mode for LEGITIMATE traffic carrying an
                        # unregistered payload type — never drop silently
                        # (the peer would reconnect and loop forever)
                        logger.exception(
                            "tcp %s: dropping connection on frame decode "
                            "failure (unregistered wire type? see "
                            "ra_tpu_torch.utils.wire.register_wire_type)",
                            self.node_name,
                        )
                        return
                    if to_name == "__ping__":
                        self._enqueue_control(from_sid, "__pong__")
                        continue
                    if to_name == "__pong__":
                        import time as _t

                        self._last_pong[from_sid] = _t.monotonic()
                        d = self.detector
                        if d is not None:
                            d.heartbeat(from_sid)
                        continue
                    if to_name == "__mgmt__":
                        corr, op, kwargs = msg
                        cb = self.on_mgmt_cb

                        # off the receive thread: start/restart do WAL
                        # recovery + disk I/O, which must not stall the
                        # peer's Raft traffic on this connection
                        def run_mgmt(corr=corr, op=op, kwargs=kwargs, frm=from_sid):
                            try:
                                r = (
                                    ("ok", cb(op, kwargs))
                                    if cb is not None
                                    else ("error", "management not supported")
                                )
                            except Exception as e:  # noqa: BLE001
                                r = ("error", repr(e))
                            self._enqueue_control(frm, "__mgmt_reply__", (corr, r))

                        threading.Thread(
                            target=run_mgmt, name="ra-tcp-mgmt", daemon=True
                        ).start()
                        continue
                    if to_name == "__mgmt_reply__":
                        corr, r = msg
                        with self._mgmt_lock:
                            fut = self._mgmt_futs.get(corr)
                        if fut is not None:
                            fut[1]["r"] = r
                            fut[0].set()
                        continue
                    if to_name == "__proc_down__":
                        cb = self.on_proc_down_cb
                        if cb is not None and msg is not None:
                            try:
                                cb(tuple(msg))
                            except Exception:  # noqa: BLE001
                                pass
                        continue
                    self.deliver((to_name, self.node_name), msg, from_sid)
        except OSError:
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass
