"""The batch coordinator's device seam.

Every tensor operation of ``runtime/coordinator.py`` goes through one
seam: building and scattering into the consensus state, the rare-path
state updates, stepping packed mailboxes, fetching the packed egress and
reading state back to the host. The coordinator's host logic passes host
values (gids, rows) and never touches a tensor directly. ``DeviceSeam``
holds the state on one device; ``ShardedSeam`` holds it as per-device
slices of the group axis (a mesh, ``ops.consensus.ShardedState``) and
offers the same methods, routing each gid to its shard.

Asynchrony on CUDA (the pipelined loop dispatches a step and realises
it later):

- mailbox pack buffers are numpy views of pinned host tensors; ``upload``
  copies one to the device with ``non_blocking=True``. The coordinator
  returns a buffer to its pool only after the egress of the step that
  read it has been realised, which orders the reuse after the copy;
- ``start_fetch`` copies the egress into a pinned host tensor with
  ``non_blocking=True`` and records a CUDA event; ``realise`` waits on
  that event and returns the numpy view.

On the CPU every step is synchronous and ``realise`` is a view. A
sharded step runs every shard on the current stream of its device, and
its egress is realised once every shard's copy has landed.

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
        idx = self.tensor(np.atleast_1d(gids))
        scatter = C.scatter_set if reduce == "set" else C.scatter_max
        upd = {}
        for name, vals in fields.items():
            cur = getattr(state, name)
            np_dtype = np.bool_ if cur.dtype == torch.bool else np.int32
            upd[name] = scatter(cur, idx, self.tensor(np.broadcast_to(
                np.asarray(vals, np_dtype), (idx.shape[0],) + tuple(cur.shape[1:])
            ), np_dtype))
        return state._replace(**upd)

    def set_rows(self, state: C.GroupState, gids, **fields) -> C.GroupState:
        """``field.at[gids].set(value)`` for each named field (host gids;
        host values broadcast over the rows; out-of-range gids drop)."""
        return self._rows(state, gids, fields, "set")

    def max_rows(self, state: C.GroupState, gids, **fields) -> C.GroupState:
        """``field.at[gids].max(value)`` for each named 1-D field."""
        return self._rows(state, gids, fields, "max")

    # -- rare-path updates (host gids and values, one entry per gid) --------

    def set_roles(self, state: C.GroupState, gids, roles) -> C.GroupState:
        return C.set_roles(state, self.tensor(gids), self.tensor(roles))

    def record_appended(self, state: C.GroupState, gids, idxs, terms
                        ) -> C.GroupState:
        return C.record_appended(state, self.tensor(gids), self.tensor(idxs),
                                 self.tensor(terms))

    def record_snapshot(self, state: C.GroupState, gids, idxs, terms
                        ) -> C.GroupState:
        return C.record_snapshot(state, self.tensor(gids), self.tensor(idxs),
                                 self.tensor(terms))

    def force_elections(self, state: C.GroupState, gids) -> C.GroupState:
        return C.force_elections(state, self.tensor(gids))

    # -- the step -------------------------------------------------------------

    def step_full(self, state: C.GroupState, packed: np.ndarray):
        """The full-width step on a host mailbox: (new state, egress on
        the device)."""
        return C.consensus_step_packed_scat(state, self.upload(packed))

    def step_sub(self, state: C.GroupState, packed: np.ndarray,
                 gidx: np.ndarray):
        """The active-set step on a host mailbox and gather index."""
        return C.consensus_step_packed_sub_scat(
            state, self.upload(packed), self.upload(gidx))

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

    def read_fields(self, state: C.GroupState, names: Sequence[str]
                    ) -> Tuple[np.ndarray, ...]:
        """Host copies of the named state fields."""
        return self.read([getattr(state, n) for n in names])

    def read_match(self, state: C.GroupState, gid: int, slot: int) -> int:
        """One group's confirmed match index for one peer slot."""
        return int(self.read([state.match_index[gid, slot]])[0])


class PendingShards:
    """The shards' egress copies in flight: realise with
    ``ShardedSeam.realise``."""

    __slots__ = ("host", "events")

    def __init__(self, host: torch.Tensor, events):
        self.host = host
        self.events = events


class ShardedSeam:
    """All device work of one coordinator whose group axis is cut into
    equal slices over a mesh: a sequence of N devices (torch devices or
    names; repeats allowed, so N slices may share one card). The state
    is an ``ops.consensus.ShardedState``. Every method takes host gids
    of the whole axis and routes each to its shard, rebased; gids out of
    range drop, and a shard left with no rows is not touched. A step
    splits the full-width host mailbox into the shards' columns (one
    copy, into pinned memory on CUDA) and launches every shard; there is
    no active-set step."""

    def __init__(self, mesh):
        devices = [C.resolve_device(d) for d in mesh]
        if not devices:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devices}) != 1:
            raise ValueError(f"a mesh holds devices of one type: {devices}")
        self.cuda = devices[0].type == "cuda"
        if self.cuda:  # name the card of a bare "cuda"
            devices = [d if d.index is not None
                       else torch.device("cuda", torch.cuda.current_device())
                       for d in devices]
        self.devices = tuple(devices)
        self.device = devices[0]
        self.n = len(devices)
        self.seams = [DeviceSeam(d) for d in devices]
        self.gs = 0  # groups a shard, set by init_state

    # -- state ------------------------------------------------------------

    def init_state(self, capacity: int, num_peers: int, suffix_k: int
                   ) -> C.ShardedState:
        if capacity % self.n:
            raise ValueError(
                f"capacity {capacity} not divisible by mesh size {self.n}"
            )
        self.gs = capacity // self.n
        return C.ShardedState(
            sm.init_state(self.gs, num_peers, suffix_k) for sm in self.seams
        )

    def _each(self, state: C.ShardedState, gids, cols, update):
        """``update(seam, shard state, local gids, *cols)`` on every
        shard that one of ``gids`` routes to; ``cols`` hold one host row
        per gid, selected alongside it."""
        shard, local = C.route_gids(gids, self.gs * self.n, self.n)
        out = list(state.shards)
        for s in np.unique(shard[shard >= 0]):
            sel = np.flatnonzero(shard == s)
            out[s] = update(self.seams[s], out[s], local[sel],
                            *(c[sel] for c in cols))
        return C.ShardedState(out)

    def _rows(self, state: C.ShardedState, gids, fields: dict, reduce: str):
        n = np.asarray(gids).size
        names = list(fields)
        cols = []
        for name in names:
            cur = getattr(state.shards[0], name)
            np_dtype = np.bool_ if cur.dtype == torch.bool else np.int32
            cols.append(np.broadcast_to(np.asarray(fields[name], np_dtype),
                                        (n,) + tuple(cur.shape[1:])))

        def update(seam, st, ids, *vals):
            return seam._rows(st, ids, dict(zip(names, vals)), reduce)

        return self._each(state, gids, cols, update)

    def set_rows(self, state: C.ShardedState, gids, **fields):
        return self._rows(state, gids, fields, "set")

    def max_rows(self, state: C.ShardedState, gids, **fields):
        return self._rows(state, gids, fields, "max")

    def set_roles(self, state: C.ShardedState, gids, roles):
        return self._each(state, gids, [np.asarray(roles)],
                          DeviceSeam.set_roles)

    def record_appended(self, state: C.ShardedState, gids, idxs, terms):
        return self._each(state, gids, [np.asarray(idxs), np.asarray(terms)],
                          DeviceSeam.record_appended)

    def record_snapshot(self, state: C.ShardedState, gids, idxs, terms):
        return self._each(state, gids, [np.asarray(idxs), np.asarray(terms)],
                          DeviceSeam.record_snapshot)

    def force_elections(self, state: C.ShardedState, gids):
        return self._each(state, gids, [], DeviceSeam.force_elections)

    # -- the step, mailbox up, egress down ----------------------------------

    def mbox_buffer(self, rows: int, width: int) -> np.ndarray:
        """A zeroed int32 pack buffer; ``step_full`` copies it into the
        shards' pinned staging."""
        return np.zeros((rows, width), np.int32)

    def step_full(self, state: C.ShardedState, packed: np.ndarray):
        """The full-width step on every shard: (new state, the shards'
        egresses on their devices). The staging block is PyTorch's
        pinned host cache's, held until its copies have run."""
        rows = packed.shape[0]
        stage = torch.empty((self.n, rows, self.gs), dtype=torch.int32,
                            pin_memory=self.cuda)
        C.split_mailbox(packed, self.n, out=stage.numpy())
        if self.cuda:
            mboxes = [stage[s].to(d, non_blocking=True)
                      for s, d in enumerate(self.devices)]
        else:
            mboxes = list(stage)
        return C.consensus_step_packed_scat_sharded(state, mboxes)

    def start_fetch(self, egs):
        """Begin copying the shards' egresses to the host."""
        if not self.cuda:
            return egs
        host = torch.empty((self.n,) + tuple(egs[0].shape), dtype=egs[0].dtype,
                           pin_memory=True)
        events = []
        for s, eg in enumerate(egs):
            host[s].copy_(eg, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(eg.device))
            events.append(ev)
        return PendingShards(host, events)

    def realise(self, pending) -> np.ndarray:
        """The (17, G) egress in gid order, once every shard's copy has
        landed."""
        if isinstance(pending, PendingShards):
            for ev in pending.events:
                ev.synchronize()
            return C.join_egress(list(pending.host.numpy()))
        return C.join_egress([eg.numpy() for eg in pending])

    # -- reads --------------------------------------------------------------

    def read_fields(self, state: C.ShardedState, names: Sequence[str]
                    ) -> Tuple[np.ndarray, ...]:
        """Host copies of the named fields over the whole group axis."""
        parts = [sm.read_fields(st, names)
                 for sm, st in zip(self.seams, state.shards)]
        return tuple(np.concatenate(col) for col in zip(*parts))

    def read_match(self, state: C.ShardedState, gid: int, slot: int) -> int:
        s = gid // self.gs
        return self.seams[s].read_match(state.shards[s], gid - s * self.gs,
                                        slot)
