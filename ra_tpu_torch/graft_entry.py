"""Entry points of the port: the counterparts of the repository
root's ``__graft_entry__.py``.

``entry()`` returns the flagship step — the fused multi-group consensus
decision step (AppendEntries accept + vote grant + quorum commit scan
over a raft-group batch axis) — with example args at G = 4096, P = 3, on
the card by default. It is ``ops.consensus.consensus_step_impl``, the
plain step: on CUDA tensors its quorum scan launches the hand-written
quorum kernel (``csrc/quorum.cu``).

``dryrun_multichip(n)`` drives the REAL ``BatchCoordinator`` step loop
with every coordinator's group axis cut into ``n`` slices (a mesh of
``n`` devices; slice i on ``cuda:(i % device_count)``, or all on the CPU
when asked): three sharded coordinators, replicated 3-member groups,
election -> command ingest -> one full-width step per slice -> egress ->
reconciliation scatters -> quorum commit -> apply on every replica; then
leader failover, a membership change and a snapshot install onto a fresh
member, each on the sharded state. On one card the ``n`` slices share
it: that checks the code path, not scaling.

Run both with ``python -m ra_tpu_torch.graft_entry [--devices N]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import time

import torch

from ra_tpu_torch.ops import consensus as C


def entry(device=None):
    """(the step function, its example args (state, mailbox)) on
    ``device`` (``None``: ``"cuda"``, which raises without a card)."""
    dev = C.resolve_device(device)
    G, P = 4096, 3
    state = C.make_group_state(G, P, device=dev)

    def col(v):
        return torch.full((G,), v, dtype=torch.int32, device=dev)

    mbox = C.empty_mailbox(G, device=dev)._replace(
        msg_type=col(C.MSG_AER),
        term=col(1),
        num_entries=col(1),
        entries_last_term=col(1),
        leader_commit=col(1),
    )
    return C.consensus_step_impl, (state, mbox)


def mesh_devices(n: int, device=None) -> list:
    """The ``n`` devices of a mesh: slice i on ``cuda:(i % count)`` for
    ``device`` ``None`` or ``"cuda"``, else every slice on ``device``."""
    dev = C.resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]
    return [dev] * n


def dryrun_multichip(n_devices: int, device=None) -> None:
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import Command, ElectionTimeout, USR
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator
    from ra_tpu_torch.runtime.transport import NodeRegistry

    # Drive the REAL coordinator loop — client ingest, one full-width
    # step per slice, egress realisation, host-reconciliation scatters —
    # with every coordinator's GroupState cut over the mesh: a full
    # replicated "training step" (append -> replicate -> quorum commit
    # -> apply) for 3-replica groups spread over three coordinators.
    G = 8 * n_devices
    mesh = mesh_devices(n_devices, device)
    reg = NodeRegistry()
    coords = [
        BatchCoordinator(f"dry{i}", capacity=G, num_peers=3, nodes=reg,
                         mesh=mesh, idle_sleep_s=0)
        for i in range(3)
    ]

    def assert_sharded(c, what: str) -> None:
        # the consensus state really is n slices of 8 groups on the mesh
        shards = c.state.shards
        assert len(shards) == n_devices, what
        for st, d in zip(shards, mesh):
            for f in st:
                assert f.shape[0] == 8 and f.device == d, what

    members = lambda g: [(f"g{g}", f"dry{i}") for i in range(3)]  # noqa: E731
    for c in coords:
        c.add_groups(
            [(f"g{g}", f"cl{g}", members(g),
              SimpleMachine(lambda x, s: s + x, 0)) for g in range(G)]
        )

    def step_all() -> bool:
        worked = False
        for c in coords:
            worked = c.step_once() or worked
        return worked

    coords[0].deliver_many(
        [((f"g{g}", "dry0"), ElectionTimeout(), None) for g in range(G)]
    )
    for _ in range(400):
        if not step_all():
            break
    assert all(
        coords[0].by_name[f"g{g}"].role == C.R_LEADER for g in range(G)
    ), "sharded election incomplete"

    coords[0].deliver_many(
        [((f"g{g}", "dry0"),
          Command(kind=USR, data=g + 1, reply_mode="noreply"), None)
         for g in range(G)]
    )
    for _ in range(400):
        if not step_all():
            break
    for c in coords:
        assert all(
            c.by_name[f"g{g}"].machine_state == g + 1 for g in range(G)
        ), f"replicated apply incomplete on {c.name}"
    assert_sharded(coords[0], "state not sharded")
    commits = C.state_to_numpy(coords[0].state)["commit_index"][:G]
    assert (commits >= 2).all(), commits  # noop + one user command
    print(f"phase election+commit ok ({G} groups, {n_devices}-device mesh)")

    def pump(done, limit_s=120.0):
        deadline = time.monotonic() + limit_s
        while time.monotonic() < deadline:
            worked = step_all()
            if done():
                return
            if not worked:
                time.sleep(0.002)
        raise AssertionError("dryrun phase timed out")

    # ---- phase 2: leader failover under sharding -----------------------
    # dry0 (leader of every group) dies; dry1 takes over on the same
    # sharded state and the cluster keeps serving with a 2/3 quorum.
    coords[0].stop()
    alive = coords[1:]

    def step_all():  # noqa: F811 — rebind over the dead coordinator
        worked = False
        for c in alive:
            worked = c.step_once() or worked
        return worked

    coords[1].deliver_many(
        [((f"g{g}", "dry1"), ElectionTimeout(), None) for g in range(G)]
    )
    pump(lambda: all(
        coords[1].by_name[f"g{g}"].role == C.R_LEADER for g in range(G)
    ))
    coords[1].deliver_many(
        [((f"g{g}", "dry1"),
          Command(kind=USR, data=1000, reply_mode="noreply"), None)
         for g in range(G)]
    )
    pump(lambda: all(
        c.by_name[f"g{g}"].machine_state == g + 1001
        for c in alive for g in range(G)
    ))
    for c in alive:
        assert_sharded(c, "sharding lost after failover")
    print(f"phase failover ok (dry1 leads all {G} groups, sharding intact)")

    # ---- phase 3: membership change (remove the dead member) ----------
    # one-at-a-time cluster change on group g0: drop dry0 from the
    # member table; the change replicates and commits on the survivors.
    coords[1].deliver(("g0", "dry1"),
                      Command(kind="ra_leave", data=("g0", "dry0")), None)
    pump(lambda: ("g0", "dry0") not in [
        m for m in coords[1].by_name["g0"].members if m is not None
    ] and coords[1].by_name["g0"].cluster_change_permitted)
    coords[1].deliver(("g0", "dry1"),
                      Command(kind=USR, data=7, reply_mode="noreply"), None)
    pump(lambda: all(
        c.by_name["g0"].machine_state == 1 + 1000 + 7 for c in alive
    ))
    for c in alive:
        assert_sharded(c, "sharding lost after membership change")
    print("phase membership ok (dead member removed, group still serves)")

    # ---- phase 4: snapshot-install catch-up onto a fresh member -------
    # compact g0's log below its history, then JOIN a brand-new
    # coordinator (dry3, same mesh): it can only catch up via the
    # chunked snapshot transfer into its sharded row.
    g0 = coords[1].by_name["g0"]
    live_members = [m for m in g0.members if m is not None]
    g0.log.update_release_cursor(
        g0.last_applied, live_members, 0, g0.machine_state
    )
    assert g0.log.snapshot_index_term() is not None
    c3 = BatchCoordinator("dry3", capacity=G, num_peers=3, nodes=reg,
                          mesh=mesh, idle_sleep_s=0)
    alive.append(c3)
    c3.add_group("g0", "cl0", live_members + [("g0", "dry3")],
                 SimpleMachine(lambda x, s: s + x, 0))
    coords[1].deliver(("g0", "dry1"),
                      Command(kind="ra_join", data=(("g0", "dry3"), True)),
                      None)
    target = 1 + 1000 + 7
    pump(lambda: c3.by_name["g0"].machine_state == target)
    assert c3.by_name["g0"].log.snapshot_index_term() is not None, (
        "fresh member caught up without a snapshot install"
    )
    assert_sharded(c3, "joiner's state not sharded")
    print("phase snapshot_install ok (fresh member caught up via snapshot, "
          "sharded)")

    for c in alive:
        c.stop()
    print(
        f"dryrun_multichip ok: {n_devices} slices on {len(set(mesh))} "
        f"distinct device(s) ({mesh[0].type}), {G} groups, full "
        "coordinator loop sharded; phases: election+commit ok, failover "
        "ok, membership ok, snapshot_install ok"
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8,
                    help="slices of the mesh (default 8)")
    ap.add_argument("--device", default=None,
                    help="torch device of the step and the mesh (default: "
                         "cuda, its slices spread over the cards)")
    args = ap.parse_args(argv)
    fn, (state, mbox) = entry(args.device)
    new_state, egress = fn(state, mbox)
    if state.role.device.type == "cuda":
        torch.cuda.synchronize()
    assert egress.commit_advanced_to.shape == (state.role.shape[0],)
    print("entry ok")
    dryrun_multichip(args.devices, args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
