"""The batch coordinator's device seam.

Every tensor operation of ``runtime/coordinator.py`` goes through one
``DeviceSeam``: building and scattering into the consensus state,
uploading packed mailboxes, fetching the packed egress and reading state
back to the host. The coordinator's host logic never touches a tensor
directly.

Asynchrony on CUDA (the pipelined loop dispatches a step and realises
it later):

- mailbox pack buffers are numpy views of pinned host tensors; ``upload``
  copies one to the device with ``non_blocking=True``. The coordinator
  returns a buffer to its pool only after the egress of the step that
  read it has been realised, which orders the reuse after the copy;
- ``start_fetch`` copies the egress into a pinned host tensor with
  ``non_blocking=True`` and records a CUDA event; ``realise`` waits on
  that event and returns the numpy view.

On the CPU every step is synchronous and ``realise`` is a view.

State tensors are never updated in place here or in ``ops.consensus``:
each scatter returns fresh tensors, so a reference to an earlier state
(the health scan's) stays valid and unchanging.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ra_tpu_torch.ops import consensus as C


class PendingEgress:
    """A device-to-host egress copy in flight: realise with
    ``DeviceSeam.realise``."""

    __slots__ = ("host", "event")

    def __init__(self, host: torch.Tensor, event):
        self.host = host
        self.event = event


class DeviceSeam:
    """All device work of one coordinator, on one explicit device."""

    def __init__(self, device=None):
        self.device = C.resolve_device(device)
        self.cuda = self.device.type == "cuda"

    # -- state ------------------------------------------------------------

    def init_state(self, capacity: int, num_peers: int, suffix_k: int) -> C.GroupState:
        """Fresh state; groups not yet registered are inactive non-voters."""
        st = C.make_group_state(capacity, num_peers, suffix_k, device=self.device)
        return st._replace(
            active=torch.zeros((capacity, num_peers), dtype=torch.bool,
                               device=self.device),
            voting=torch.zeros((capacity, num_peers), dtype=torch.bool,
                               device=self.device),
        )

    def tensor(self, values, dtype=np.int32) -> torch.Tensor:
        """Host values (list, scalar sequence or ndarray), copied, on the
        device."""
        return self.upload(np.array(values, dtype=dtype, order="C"))

    def _rows(self, state: C.GroupState, gids, fields: dict, reduce: str):
        if isinstance(gids, int):
            gids = [gids]
        idx = gids if torch.is_tensor(gids) else self.tensor(gids)
        upd = {}
        for name, vals in fields.items():
            cur = getattr(state, name)
            if not torch.is_tensor(vals):
                np_dtype = np.bool_ if cur.dtype == torch.bool else np.int32
                vals = self.tensor(np.broadcast_to(
                    np.asarray(vals, np_dtype), (idx.shape[0],) + tuple(cur.shape[1:])
                ), np_dtype)
            if reduce == "set":
                upd[name] = C.scatter_set(cur, idx, vals)
            else:
                upd[name] = C.scatter_max(cur, idx, vals)
        return state._replace(**upd)

    def set_rows(self, state: C.GroupState, gids, **fields) -> C.GroupState:
        """``field.at[gids].set(value)`` for each named field (host values
        broadcast over the rows; out-of-range gids drop)."""
        return self._rows(state, gids, fields, "set")

    def max_rows(self, state: C.GroupState, gids, **fields) -> C.GroupState:
        """``field.at[gids].max(value)`` for each named 1-D field."""
        return self._rows(state, gids, fields, "max")

    # -- mailbox up, egress down -------------------------------------------

    def mbox_buffer(self, rows: int, width: int) -> np.ndarray:
        """A zeroed int32 pack buffer (a view of pinned memory on CUDA)."""
        if self.cuda:
            t = torch.zeros((rows, width), dtype=torch.int32, pin_memory=True)
            return t.numpy()
        return np.zeros((rows, width), np.int32)

    def upload(self, buf: np.ndarray) -> torch.Tensor:
        """A host array on the device: zero-copy on the CPU; on CUDA an
        asynchronous copy from pinned memory (pageable arrays are staged
        through PyTorch's pinned host cache, which holds the staging
        block until the copy has run)."""
        t = torch.from_numpy(buf)
        if not self.cuda:
            return t
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def start_fetch(self, eg: torch.Tensor):
        """Begin copying a step's packed egress to the host."""
        if not self.cuda:
            return eg
        host = torch.empty(eg.shape, dtype=eg.dtype, pin_memory=True)
        host.copy_(eg, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return PendingEgress(host, ev)

    def realise(self, pending) -> np.ndarray:
        """The egress as a numpy array, once the device has produced it."""
        if isinstance(pending, PendingEgress):
            pending.event.synchronize()
            return pending.host.numpy()
        return pending.numpy()

    def read(self, tensors: Sequence[torch.Tensor]) -> Tuple[np.ndarray, ...]:
        """Synchronous host copies of ``tensors`` (one transfer each)."""
        return tuple(t.cpu().numpy() for t in tensors)
