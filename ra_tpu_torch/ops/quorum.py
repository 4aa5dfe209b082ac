"""Quorum scan: the hand-written CUDA kernel and its plain PyTorch version.

The per-step hot op of the batch backend is ``agreed_commit``: for every
group, the majority-replicated index, i.e. the (nvoters//2)-th largest
entry of the voter-masked match vector (reference semantics:
agreed_commit src/ra_server.erl:3684-3688; scalar spec:
``ra_tpu_torch.ops.decisions.agreed_commit``).

- ``agreed_commit_plain`` is the plain PyTorch version, a port of the
  JAX package's ``agreed_commit_sort``: mask, sort along the peer axis,
  pick ascending position ``clamp(P - 1 - nvoters // 2, 0, P - 1)``.
- ``agreed_commit`` is the wrapper. A CPU tensor goes to the plain
  version; a CUDA tensor launches the kernel of ``csrc/quorum.cu`` (one
  thread per group, an odd-even transposition network in registers) or
  raises. It never falls back to the plain version on the card.

It replaces the TPU kernel ``ra_tpu/ops/pallas_quorum.py::_quorum_kernel``.
"""

from __future__ import annotations

import ctypes

import torch

MAX_P = 8

# kernel launches made by agreed_commit (plain-version calls not counted)
LAUNCHES = 0

_fn = None


def agreed_commit_plain(
    match: torch.Tensor, voting: torch.Tensor, nvoters: torch.Tensor
) -> torch.Tensor:
    """Quorum scan, sort formulation. ``match`` i32[G, P], ``voting``
    bool[G, P], ``nvoters`` i32[G] -> i32[G]."""
    p = match.shape[-1]
    eff = torch.where(voting, match, -1)
    srt = torch.sort(eff, dim=-1).values  # ascending; non-voters (-1) first
    pos = torch.clamp(p - 1 - torch.div(nvoters, 2, rounding_mode="floor"), 0, p - 1)
    return torch.gather(srt, -1, pos.long()[:, None]).squeeze(-1)


def _kernel():
    global _fn
    if _fn is None:
        from ra_tpu_torch.ops import kernels

        fn = kernels.load("quorum").ra_quorum_launch
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        _fn = fn
    return _fn


def _check(match, voting, nvoters) -> None:
    if match.dim() != 2:
        raise ValueError(f"match must be [G, P], got shape {tuple(match.shape)}")
    g, p = match.shape
    if not 1 <= p <= MAX_P:
        raise ValueError(f"peer width {p} outside 1..{MAX_P}")
    if tuple(voting.shape) != (g, p) or tuple(nvoters.shape) != (g,):
        raise ValueError(
            f"shape mismatch: match {tuple(match.shape)}, voting "
            f"{tuple(voting.shape)}, nvoters {tuple(nvoters.shape)}"
        )
    if (match.dtype, voting.dtype, nvoters.dtype) != (
        torch.int32, torch.bool, torch.int32
    ):
        raise TypeError(
            f"dtypes must be (int32, bool, int32), got "
            f"({match.dtype}, {voting.dtype}, {nvoters.dtype})"
        )
    if not (voting.device == nvoters.device == match.device):
        raise ValueError("match, voting and nvoters must share one device")
    if not (match.is_contiguous() and voting.is_contiguous()
            and nvoters.is_contiguous()):
        raise ValueError("quorum kernel inputs must be contiguous")


def agreed_commit(
    match: torch.Tensor, voting: torch.Tensor, nvoters: torch.Tensor
) -> torch.Tensor:
    """Per-group agreed commit index. CPU tensors run the plain version;
    CUDA tensors launch the kernel (or raise)."""
    global LAUNCHES
    _check(match, voting, nvoters)
    dev = match.device
    if dev.type == "cpu":
        return agreed_commit_plain(match, voting, nvoters)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g, p = match.shape
    out = torch.empty(g, dtype=torch.int32, device=dev)
    if g == 0:
        return out
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _kernel()(match.data_ptr(), voting.data_ptr(), nvoters.data_ptr(),
                   out.data_ptr(), g, p, stream)
    if rc != 0:
        raise RuntimeError(f"quorum kernel launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
