"""Helpers for running one scenario on both packages.

A scenario is a function ``flow(pkg, tmp, **kw)`` that builds nodes or
``BatchCoordinator``s of one package, drives them (through that
package's ``api`` where the original test does) and returns a record:
replies, machine states and, for coordinators, device state read back
at quiescence. The test runs it on ``ra_tpu`` and on ``ra_tpu_torch``
(whose coordinators run on ``device="cpu"``) and compares the two
records. Device state crosses as numpy arrays:
``np.asarray`` of a JAX array, ``.cpu().numpy()`` of a torch tensor,
read under the coordinator's ``_state_lock``.
"""

import importlib
import os
import time

import numpy as np

import torch_parity  # noqa: F401  (bounds torch's threads)

PACKAGES = ("ra_tpu", "ra_tpu_torch")

# GroupState fields compared at quiescence. Left out, as fields that two
# runs of one package may end with differently when each coordinator has
# its own step thread: next_index (a leader advances it optimistically at
# send time), votes, pre_votes and pre_vote_token (which vote replies
# reach a round before it closes, and whether a loaded follower's
# detector opens a pre-vote round that the leader then refuses), and the
# host-driven unknown_lo/hi and last_applied.
STABLE = (
    "current_term", "voted_for", "commit_index", "last_index", "last_term",
    "written_index", "snapshot_index", "snapshot_term", "role",
    "leader_slot", "self_slot", "machine_version", "match_index",
    "voting", "active", "term_suffix",
)
# after a failover, which survivor wins (and in which term) is a race
LEADER_AGNOSTIC = (
    "commit_index", "last_index", "written_index", "snapshot_index",
    "self_slot", "machine_version", "voting", "active",
)


class Pkg:
    """One package's modules, as a scenario uses them."""

    def __init__(self, name):
        def mod(sub):
            return importlib.import_module(f"{name}.{sub}")

        self.name = name
        self.torch = name == "ra_tpu_torch"
        self.api = mod("api")
        self.fx = mod("effects")
        self.faults = mod("faults")
        self.leaderboard = mod("leaderboard")
        self.machine = mod("machine")
        self.protocol = mod("protocol")
        self.C = mod("ops.consensus")
        self.coordinator = mod("runtime.coordinator")
        self.transport = mod("runtime.transport")
        self.proc = mod("runtime.proc")
        self.snapshot = mod("log.snapshot")
        self.Log = mod("log.log").Log
        self.SegmentWriter = mod("log.segment_writer").SegmentWriter
        self.TableRegistry = mod("log.tables").TableRegistry
        self.Wal = mod("log.wal").Wal
        self.kv = mod("models.kv")
        self.SystemConfig = mod("system").SystemConfig
        self.registry = self.transport.registry

    def coord(self, *args, **kw):
        """A BatchCoordinator; the port's on the CPU."""
        if self.torch:
            kw["device"] = "cpu"
        return self.coordinator.BatchCoordinator(*args, **kw)

    def adder(self):
        return self.machine.SimpleMachine(lambda c, s: s + c, 0)

    def command(self, data, fut=None, reply_mode="await_consensus"):
        return self.protocol.Command(kind=self.protocol.USR, data=data,
                                     reply_mode=reply_mode, from_ref=fut)

    def election(self):
        return self.protocol.ElectionTimeout()

    def field(self, coord, name) -> np.ndarray:
        """One GroupState field of a coordinator, on the host."""
        with coord._state_lock:
            t = getattr(coord.state, name)
            return t.cpu().numpy() if self.torch else np.asarray(t)


def clear_both():
    for name in PACKAGES:
        importlib.import_module(f"{name}.leaderboard").clear()
        importlib.import_module(f"{name}.faults").disarm_all()


def on_both(flow, tmp_path, **kw):
    """``flow(pkg, tmp, **kw)`` on each package: the records must be
    equal. Both packages' leaderboards and failpoints are cleared
    around every run."""
    got = {}
    for name in PACKAGES:
        clear_both()
        try:
            got[name] = flow(Pkg(name), tmp_path / name, **kw)
        except Exception as e:
            raise AssertionError(f"{flow.__name__} on {name}: {e!r}") from e
        finally:
            clear_both()
    assert got["ra_tpu_torch"].keys() == got["ra_tpu"].keys()
    for key in got["ra_tpu"]:
        assert got["ra_tpu_torch"][key] == got["ra_tpu"][key], key
    return got["ra_tpu"]


def await_(cond, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = cond()
        if v:
            return v
        time.sleep(0.01)
    raise AssertionError(f"timeout waiting for {what}")


def device_state(pkg, coords, groups, fields=STABLE, timeout=30.0):
    """Per coordinator and group, the named GroupState fields once every
    hosting coordinator has committed and written its whole log and two
    reads 0.2 s apart agree (quiescence)."""
    def snap():
        out = {}
        for c in coords:
            rows = {f: pkg.field(c, f) for f in set(fields) | {
                "commit_index", "last_index", "written_index", "role"}}
            for name in groups:
                g = c.by_name.get(name)
                if g is None:
                    continue
                out[(c.name, name)] = {f: rows[f][g.gid].tolist()
                                       for f in rows}
        return out

    def quiet():
        a = snap()
        settled = all(
            r["commit_index"] == r["last_index"] == r["written_index"]
            and g.last_applied == r["commit_index"]
            for (cn, name), r in a.items()
            for g in [next(c for c in coords if c.name == cn).by_name[name]]
        )
        if not settled:
            return None
        time.sleep(0.2)
        b = snap()
        return a if a == b else None

    st = await_(quiet, timeout, "device state to settle")
    return {k: {f: v[f] for f in fields} for k, v in st.items()}


def wal_storage(pkg, tmp, node, coord, scope=None):
    """(tables, wal, segment writer, dir) of one node; events go to
    ``coord`` (its ``wal_notify``), or through ``deliver`` to whatever
    coordinator ``coord_ref["c"]`` holds when ``coord`` is a dict."""
    d = str(tmp / node)
    tables = pkg.TableRegistry()
    if isinstance(coord, dict):
        ref = coord

        def notify(uid, evt):
            c = ref.get("c")
            if c is not None:
                c.deliver((uid, node), ("log_event", evt), None)
        sw = pkg.SegmentWriter(os.path.join(d, "data"), tables, notify)
        wal = pkg.Wal(os.path.join(d, "wal"), tables, notify, segment_writer=sw)
    else:
        sw = pkg.SegmentWriter(os.path.join(d, "data"), tables, coord.wal_notify)
        wal = pkg.Wal(os.path.join(d, "wal"), tables, coord.wal_notify,
                      segment_writer=sw)
        wal.notify_many = coord.wal_notify_many
    if scope is not None:
        sw.fault_scope = scope
        wal.fault_scope = scope
    return tables, wal, sw, d


def wal_log(pkg, storage, uid, **kw):
    tables, wal, _sw, d = storage
    return pkg.Log(uid, os.path.join(d, "data", uid), tables, wal, **kw)


def close_storage(storage):
    for _tables, wal, sw, _d in storage:
        for x in (wal, sw):
            try:
                x.close()
            except Exception:  # noqa: BLE001
                pass
