"""The fused consensus step as a hand-written CUDA kernel (``csrc/step.cu``).

``launch_full`` and ``launch_sub`` run the whole main-path step on the
card in one cooperative launch: the packed scatters, the per-group
decisions, the quorum scan inlined on registers and the packed egress
(``csrc/step.cu`` says how), instead of the plain version's hundreds of
eager torch operations. They are the CUDA half of
``ops.consensus.consensus_step_packed_scat`` and
``consensus_step_packed_sub_scat``, which dispatch on the device: CPU
tensors run the plain torch-op step of that module, CUDA tensors come
here and launch the kernel or raise. Nothing here falls back to the
plain version.

Every peer width runs on the card: P = 1..8 take instances with their
P-wide rows in registers, wider groups one instance of runtime width.
On the TPU the step is XLA-fused ``jnp`` (``ra_tpu/ops/consensus.py``)
reaching the Pallas quorum kernel; this kernel has no Pallas original.

Each call allocates one output buffer on the card and returns the new
state (fresh tensors for every field the step changes, viewed out of
that buffer by ``out_views``; no state tensor is updated in place) and
the (17, S) int32 egress. The kernel's pre-pass maps live in a
``Scratch`` per (device, stream, G), zeroed once and reused: every launch
tags its entries with a fresh epoch. ``LAUNCHES_FULL`` and
``LAUNCHES_SUB`` count the kernel launches (one per step).

The host side of a call is kept short: the state's fields are checked
once, and a field carried unchanged from a state this module returned
is trusted by identity (``check``); the kernel's arguments are built by
the C launcher from one base pointer. A returned tensor reshaped in
place (``resize_``, ``set_``) is outside that contract.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, Optional, Sequence, Tuple

import torch

from ra_tpu_torch.ops import consensus as C

# kernel launches of each step kind (plain-version calls not counted)
LAUNCHES_FULL = 0
LAUNCHES_SUB = 0

# the kernel's layouts, in the order csrc/step.cu reads them: the state
# fields and the packed mailbox rows of ops.consensus (the egress rows
# are its EGRESS_FIELDS)
STATE_FIELDS = C.GroupState._fields
MBOX_ROWS = tuple(C.MBOX_FIELDS + C.MBOX_SCAT_FIELDS)
# the fields the step changes (fresh outputs); the others pass through
OUT_FIELDS = (
    "current_term", "voted_for", "commit_index", "last_index", "last_term",
    "written_index", "role", "leader_slot", "match_index", "next_index",
    "votes", "pre_votes", "term_suffix", "unknown_lo", "unknown_hi",
)
_OUT_POS = tuple(STATE_FIELDS.index(f) for f in OUT_FIELDS)

_BOOL = frozenset(("voting", "active", "votes", "pre_votes"))
_PEER = frozenset(("match_index", "next_index", "voting", "active", "votes",
                   "pre_votes"))
# per state field: (dtype, shape kind) with kind 0 = [G], 1 = [G, P],
# 2 = [G, K]
_SPEC = tuple(
    (torch.bool if f in _BOOL else torch.int32,
     1 if f in _PEER else 2 if f == "term_suffix" else 0)
    for f in STATE_FIELDS
)

_PTRS = ctypes.c_void_p * len(STATE_FIELDS)
_fns: Dict[str, object] = {}

# The states this module checked or returned lately, each as (state, its
# 23 field pointers, (G, P, K, device), returned?): a field of a new call
# that is the same tensor object as the field of such a state is known
# to be well formed. Replaced whole (never mutated), so readers need no
# lock. Sixteen cover the states that share one card in a process (three
# coordinators, each over a mesh of four slices); it keeps up to sixteen
# recent states alive.
_records: Tuple[tuple, ...] = ()
_KEEP = 16


def _record_of(state) -> Optional[tuple]:
    """The recorded state that ``state`` is or was derived from, if any:
    one whose ring or match rows ``state`` still holds."""
    for rec in _records:
        prev = rec[0]
        if prev is state or prev[19] is state[19] or prev[13] is state[13]:
            return rec
    return None


def _check_field(name, t, spec, shapes, dev, cuda) -> None:
    dtype, kind = spec
    if t.dtype != dtype:
        raise TypeError(f"state field {name}: dtype {t.dtype}, expected {dtype}")
    if t.shape != shapes[kind]:
        raise ValueError(
            f"state field {name}: shape {tuple(t.shape)}, expected {shapes[kind]}")
    if t.device != dev:
        raise ValueError(f"state field {name} is on {t.device}, not {dev}")
    if cuda and not t.is_contiguous():
        raise ValueError(f"state field {name} is not contiguous")


def check(state: Sequence[torch.Tensor], packed: torch.Tensor,
          gidx: Optional[torch.Tensor] = None) -> None:
    """Raise on inputs neither the kernel nor the plain step takes:
    a state that is not 23 tensors of consistent [G], [G, P], [G, K]
    shapes and int32/bool types on one device, a packed mailbox that is
    not (24, S) int32 with S = G at full width, an active-set index that
    is not (S,) int32. On CUDA every tensor must also be contiguous.
    Fields carried unchanged from a state this module returned are
    known to be well formed and cost an identity comparison."""
    if len(state) != len(STATE_FIELDS):
        raise ValueError(f"state has {len(state)} fields, expected {len(STATE_FIELDS)}")
    rec = _record_of(state)
    if rec is not None:
        g, p, k, dev = rec[2]
        cuda = dev.type == "cuda"
        prev = rec[0]
        if prev is not state:
            shapes = ((g,), (g, p), (g, k))
            for name, t, old, spec in zip(STATE_FIELDS, state, prev, _SPEC):
                if t is not old:
                    _check_field(name, t, spec, shapes, dev, cuda)
    else:
        match, ts = state[13], state[19]
        if match.dim() != 2 or ts.dim() != 2:
            raise ValueError("match_index and term_suffix must be 2-D")
        g, p = match.shape
        k = ts.shape[1]
        shapes = ((g,), (g, p), (g, k))
        dev = match.device
        cuda = dev.type == "cuda"
        for name, t, spec in zip(STATE_FIELDS, state, _SPEC):
            _check_field(name, t, spec, shapes, dev, cuda)
        if k < 1:
            raise ValueError("term_suffix must have at least one slot")
    if packed.dtype != torch.int32:
        raise TypeError(f"packed mailbox dtype {packed.dtype}, expected torch.int32")
    if packed.dim() != 2 or packed.shape[0] != len(MBOX_ROWS):
        raise ValueError(
            f"packed mailbox shape {tuple(packed.shape)}, expected ({len(MBOX_ROWS)}, S)")
    if packed.device != dev:
        raise ValueError(f"packed mailbox is on {packed.device}, not {dev}")
    if cuda and not packed.is_contiguous():
        raise ValueError("packed mailbox is not contiguous")
    if gidx is None:
        if packed.shape[1] != g:
            raise ValueError(
                f"full-width packed mailbox has {packed.shape[1]} columns, expected G={g}")
        return
    if gidx.dtype != torch.int32:
        raise TypeError(f"gidx dtype {gidx.dtype}, expected torch.int32")
    if gidx.shape != (packed.shape[1],):
        raise ValueError(
            f"gidx shape {tuple(gidx.shape)}, expected ({packed.shape[1]},)")
    if gidx.device != dev:
        raise ValueError(f"gidx is on {gidx.device}, not {dev}")
    if cuda and not gidx.is_contiguous():
        raise ValueError("gidx is not contiguous")


class Scratch:
    """The kernel's pre-pass maps for G groups on one (device, stream):
    20 bytes a group (two 64-bit and one 32-bit [G] map), zeroed once.
    Each launch takes the next epoch under ``lock`` and enqueues under it
    too, so epochs rise in stream order even with several threads on one
    stream; when the 32-bit epoch would wrap, the maps are zeroed (on the
    same stream, before the launch) and the count starts again at 1."""

    BYTES_PER_GROUP = 20

    def __init__(self, g: int, device) -> None:
        self.buf = torch.zeros(self.BYTES_PER_GROUP * g, dtype=torch.uint8,
                               device=device)
        self.ptr = self.buf.data_ptr()
        self.epoch = 0
        self.lock = threading.Lock()

    def next_epoch(self) -> int:
        """The epoch of the next launch; the caller holds ``lock``."""
        if self.epoch == 0xFFFFFFFF:
            self.buf.zero_()
            self.epoch = 0
        self.epoch += 1
        return self.epoch


_scratches: Dict[tuple, Scratch] = {}
_scratch_lock = threading.Lock()


def scratch_for(device: torch.device, stream: int, g: int) -> Scratch:
    """The scratch of (device, stream, G), made at first use."""
    key = (device.index, stream, g)
    sc = _scratches.get(key)
    if sc is None:
        with _scratch_lock:
            sc = _scratches.get(key)
            if sc is None:
                sc = _scratches[key] = Scratch(g, device)
    return sc


def out_words(g: int, p: int, k: int, s: int) -> int:
    """int32 words of the one output buffer of a step."""
    return g * k + 10 * g + 2 * g * p + 17 * s + (2 * g * p + 3) // 4


def out_views(buf: torch.Tensor, g: int, p: int, k: int, s: int):
    """The step's outputs in ``buf`` (``out_words`` int32), laid out as
    ``csrc/step.cu``'s ``out_offsets``: the ring first, the ten [G]
    scalars, match and next, the egress, then the bool rows. Returns
    (the 15 changed fields in ``OUT_FIELDS`` order, the (17, S) egress).
    One ``split_with_sizes`` and six views: each torch call here costs
    microseconds of the step call's host time."""
    gp = g * p
    parts = buf.split_with_sizes(
        (g * k,) + (g,) * 10 + (gp, gp, 17 * s, (2 * gp + 3) // 4))
    bools = parts[14].view(torch.bool)
    at = bools.storage_offset()  # as_strided's offset counts from the storage
    return ((*parts[1:9], parts[11].view(g, p), parts[12].view(g, p),
             bools.as_strided((g, p), (p, 1), at),
             bools.as_strided((g, p), (p, 1), at + gp),
             parts[0].view(g, k), parts[9], parts[10]),
            parts[13].view(17, s))


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ra_tpu_torch.ops import kernels

        fn = getattr(kernels.load("step"), name)
        fn.restype = ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
        if name.startswith("ra_step_full"):
            fn.argtypes = [ptrs, ptrs, vp, vp, vp, u, i, i, i, vp]
        else:
            fn.argtypes = [ptrs, ptrs, vp, vp, vp, vp, u, i, i, i, i, vp]
        _fns[name] = fn
    return fn


def run(fn, state, packed, gidx, scratch: Scratch, stream: int):
    """One step through the C launcher ``fn`` (``ra_step_full_launch``'s
    or ``ra_step_sub_launch``'s signature) on ``stream``: allocate the
    output buffer, take the scratch's next epoch and launch under its
    lock, and return (the new state, the egress). ``check`` has passed.
    The input is recorded unless it is a state this module returned, and
    the output always, so that the next call that takes either costs
    identity comparisons in ``check`` and here."""
    global _records
    g, p = state[13].shape
    k = state[19].shape[1]
    s = packed.shape[1]
    buf = torch.empty(out_words(g, p, k, s), dtype=torch.int32,
                      device=packed.device)
    outs, egress = out_views(buf, g, p, k, s)
    key = (g, p, k, packed.device)
    rec = _record_of(state)
    if rec is not None and rec[0] is state:
        ins = rec[1]
        keep = () if rec[3] else (rec,)  # a checked input moves up
    else:
        if rec is None:
            ins = _PTRS(*[t.data_ptr() for t in state])
        else:  # the recorded pointers, with those of replaced fields
            ins = _PTRS.from_buffer_copy(rec[1])
            for i, (t, old) in enumerate(zip(state, rec[0])):
                if t is not old:
                    ins[i] = t.data_ptr()
        keep = ((state, ins, key, False),)
    nxt = _PTRS()
    head = (ins, nxt, buf.data_ptr(), packed.data_ptr())
    if gidx is not None:
        head += (gidx.data_ptr(),)
    with scratch.lock:
        rc = fn(*head, scratch.ptr, scratch.next_epoch(), g, p, k,
                *((s,) if gidx is not None else ()), stream)
    if rc != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {rc}")
    fields = list(state)
    for i, t in zip(_OUT_POS, outs):
        fields[i] = t
    new = C.GroupState(*fields)
    moved = keep[0] if keep else None
    rest = tuple(r for r in _records if r is not moved)
    _records = (((new, nxt, key, True),) + keep + rest)[:_KEEP]
    return new, egress


def _launch(state, packed, gidx):
    dev = packed.device
    if dev.type != "cuda":
        raise ValueError(f"the step kernel runs on CUDA tensors, not {dev}")
    g, p = state[13].shape
    s = packed.shape[1]
    if p < 1:
        raise ValueError(f"peer width {p}: the step needs at least one peer")
    if g < 1 or s < 1:
        raise ValueError(f"empty step: G={g}, S={s}")
    fn = _kernel("ra_step_full_launch" if gidx is None else "ra_step_sub_launch")
    # the current stream's raw pointer (torch.cuda.current_stream builds a
    # Stream object: about 5 us of a call's host time on the H100's host)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return run(fn, state, packed, gidx, scratch_for(dev, stream, g), stream)
    with torch.cuda.device(dev):  # the runtime launches on the current device
        return run(fn, state, packed, gidx, scratch_for(dev, stream, g), stream)


def launch_full(state: Sequence[torch.Tensor], packed: torch.Tensor
                ) -> Tuple[C.GroupState, torch.Tensor]:
    """Full-width step on the card: (new state, egress). The caller has
    run ``check(state, packed)``."""
    global LAUNCHES_FULL
    res = _launch(state, packed, None)
    LAUNCHES_FULL += 1
    return res


def launch_sub(state: Sequence[torch.Tensor], packed: torch.Tensor,
               gidx: torch.Tensor) -> Tuple[C.GroupState, torch.Tensor]:
    """Active-set step on the card: (new state, egress). The caller has
    run ``check(state, packed, gidx)``."""
    global LAUNCHES_SUB
    res = _launch(state, packed, gidx)
    LAUNCHES_SUB += 1
    return res
