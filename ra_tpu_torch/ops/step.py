"""The fused consensus step as a hand-written CUDA kernel (``csrc/step.cu``).

``launch_full`` and ``launch_sub`` run the whole main-path step on the
card: the packed scatters, the per-group decisions, the quorum scan
inlined on registers and the packed egress, in four launches (a memset
and three kernels, ``csrc/step.cu`` says which) instead of the plain
version's hundreds of eager torch operations. They are the CUDA half of
``ops.consensus.consensus_step_packed_scat`` and
``consensus_step_packed_sub_scat``, which dispatch on the device: CPU
tensors run the plain torch-op step of that module, CUDA tensors come
here and launch the kernel or raise. Nothing here falls back to the
plain version.

Every peer width runs on the card: P = 1..8 take instances with their
P-wide rows in registers, wider groups one instance of runtime width.
On the TPU the step is XLA-fused ``jnp`` (``ra_tpu/ops/consensus.py``)
reaching the Pallas quorum kernel; this kernel has no Pallas original.

The wrappers allocate every output on the card (fresh tensors: no state
tensor is updated in place) and return the changed fields by name and
the (17, S) int32 egress. ``LAUNCHES_FULL`` and ``LAUNCHES_SUB`` count
the kernel launches (one per step).
"""

from __future__ import annotations

import ctypes
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

_fns: Dict[str, object] = {}


def check(state: Sequence[torch.Tensor], packed: torch.Tensor,
          gidx: Optional[torch.Tensor] = None) -> None:
    """Raise on inputs neither the kernel nor the plain step takes:
    a state that is not 23 tensors of consistent [G], [G, P], [G, K]
    shapes and int32/bool types on one device, a packed mailbox that is
    not (24, S) int32 with S = G at full width, an active-set index that
    is not (S,) int32. On CUDA every tensor must also be contiguous."""
    if len(state) != len(STATE_FIELDS):
        raise ValueError(f"state has {len(state)} fields, expected {len(STATE_FIELDS)}")
    match, ts = state[13], state[19]
    if match.dim() != 2 or ts.dim() != 2:
        raise ValueError("match_index and term_suffix must be 2-D")
    g, p = match.shape
    k = ts.shape[1]
    shapes = ((g,), (g, p), (g, k))
    dev = match.device
    cuda = dev.type == "cuda"
    for name, t, (dtype, kind) in zip(STATE_FIELDS, state, _SPEC):
        if t.dtype != dtype:
            raise TypeError(f"state field {name}: dtype {t.dtype}, expected {dtype}")
        if t.shape != shapes[kind]:
            raise ValueError(
                f"state field {name}: shape {tuple(t.shape)}, expected {shapes[kind]}")
        if t.device != dev:
            raise ValueError(f"state field {name} is on {t.device}, not {dev}")
        if cuda and not t.is_contiguous():
            raise ValueError(f"state field {name} is not contiguous")
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


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from ra_tpu_torch.ops import kernels

        fn = getattr(kernels.load("step"), name)
        fn.restype = ctypes.c_int
        ptrs = ctypes.POINTER(ctypes.c_void_p)
        vp, i = ctypes.c_void_p, ctypes.c_int
        if name == "ra_step_full_launch":
            fn.argtypes = [ptrs, ptrs, vp, vp, vp, i, i, i, vp]
        else:
            fn.argtypes = [ptrs, ptrs, vp, vp, vp, vp, i, i, i, i, vp]
        _fns[name] = fn
    return fn


def _launch(state, packed, gidx):
    match, ts = state[13], state[19]
    g, p = match.shape
    k = ts.shape[1]
    s = packed.shape[1]
    dev = match.device
    if dev.type != "cuda":
        raise ValueError(f"the step kernel runs on CUDA tensors, not {dev}")
    if p < 1:
        raise ValueError(f"peer width {p}: the step needs at least one peer")
    if g < 1 or s < 1:
        raise ValueError(f"empty step: G={g}, S={s}")
    # one int32 buffer: the 13 changed int32 fields, the two [G] maps of
    # the scatter pre-pass, the egress; one bool buffer: votes, pre_votes
    buf = torch.empty(g * (12 + 2 * p + k) + 17 * s, dtype=torch.int32,
                      device=dev)
    (current_term, voted_for, commit_index, last_index, last_term,
     written_index, role, leader_slot, match_index, next_index, term_suffix,
     unknown_lo, unknown_hi, maps, egress) = buf.split(
        (g, g, g, g, g, g, g, g, g * p, g * p, g * k, g, g, 2 * g, 17 * s))
    votes, pre_votes = torch.empty((2, g, p), dtype=torch.bool,
                                   device=dev).unbind()
    out = {
        "current_term": current_term, "voted_for": voted_for,
        "commit_index": commit_index, "last_index": last_index,
        "last_term": last_term, "written_index": written_index,
        "role": role, "leader_slot": leader_slot,
        "match_index": match_index.view(g, p),
        "next_index": next_index.view(g, p),
        "votes": votes, "pre_votes": pre_votes,
        "term_suffix": term_suffix.view(g, k),
        "unknown_lo": unknown_lo, "unknown_hi": unknown_hi,
    }
    ins = (ctypes.c_void_p * len(STATE_FIELDS))(*[t.data_ptr() for t in state])
    outs = (ctypes.c_void_p * len(OUT_FIELDS))(
        *[out[f].data_ptr() for f in OUT_FIELDS])
    if gidx is None:
        fn = _kernel("ra_step_full_launch")
        args = (ins, outs, packed.data_ptr(), egress.data_ptr(),
                maps.data_ptr(), g, p, k)
    else:
        fn = _kernel("ra_step_sub_launch")
        args = (ins, outs, packed.data_ptr(), gidx.data_ptr(),
                egress.data_ptr(), maps.data_ptr(), g, p, k, s)
    if dev.index is None or dev.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    else:  # the runtime launches on the current device: switch to dev
        with torch.cuda.device(dev):
            rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"step kernel launch failed: CUDA error {rc}")
    return out, egress.view(17, s)


def launch_full(state: Sequence[torch.Tensor], packed: torch.Tensor
                ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Full-width step on the card: (changed fields by name, egress).
    The caller has run ``check(state, packed)``."""
    global LAUNCHES_FULL
    res = _launch(state, packed, None)
    LAUNCHES_FULL += 1
    return res


def launch_sub(state: Sequence[torch.Tensor], packed: torch.Tensor,
               gidx: torch.Tensor
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Active-set step on the card: (changed fields by name, egress).
    The caller has run ``check(state, packed, gidx)``."""
    global LAUNCHES_SUB
    res = _launch(state, packed, gidx)
    LAUNCHES_SUB += 1
    return res
