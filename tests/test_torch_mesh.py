"""The port's multi-device path on the CPU, held against the JAX package.

A mesh of the port is a sequence of N torch devices: each coordinator
holds its state as N equal slices of the group axis
(``ops.consensus.ShardedState``) through ``runtime.device.ShardedSeam``,
and steps every slice at full width. Here the slices all lie on the CPU
(repeated devices); the JAX package runs on the 8-device virtual CPU
mesh that ``tests/conftest.py`` provides. Data crosses as numpy arrays
(``state_from_numpy`` / ``state_to_numpy``), and every comparison is
exact equality, field by field.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from ra_tpu import health as JH
from ra_tpu import leaderboard as JL
from ra_tpu.machine import SimpleMachine as JSimpleMachine
from ra_tpu.ops import consensus as J
from ra_tpu.protocol import Command as JCommand
from ra_tpu.protocol import ElectionTimeout as JElectionTimeout
from ra_tpu.runtime import coordinator as JC
from ra_tpu.runtime.transport import NodeRegistry as JNodeRegistry

from ra_tpu_torch import health as TH
from ra_tpu_torch import leaderboard as TL
from ra_tpu_torch.machine import SimpleMachine as TSimpleMachine
from ra_tpu_torch.ops import consensus as T
from ra_tpu_torch.protocol import Command as TCommand
from ra_tpu_torch.protocol import ElectionTimeout as TElectionTimeout
from ra_tpu_torch.protocol import USR
from ra_tpu_torch.runtime import coordinator as TC
from ra_tpu_torch.runtime.device import DeviceSeam, ShardedSeam
from ra_tpu_torch.runtime.transport import NodeRegistry as TNodeRegistry

import torch_step_cases as cases
from torch_parity import jax_copy

PKG = {
    "jax": (JC, JSimpleMachine, JCommand, JElectionTimeout, JNodeRegistry, J),
    "torch": (TC, TSimpleMachine, TCommand, TElectionTimeout, TNodeRegistry, T),
}


def jax_mesh():
    return Mesh(np.array(jax.devices("cpu")[:8]), ("groups",))


def coordinator(pkg, name, capacity, mesh, **kw):
    """A BatchCoordinator of ``pkg``: the port's on the CPU, or over a
    mesh of ``mesh`` CPU slices; the JAX package's over its 8-device
    mesh when ``mesh`` is given."""
    mod = PKG[pkg][0]
    if pkg == "torch":
        where = {"mesh": ["cpu"] * mesh} if mesh else {"device": "cpu"}
    else:
        where = {"mesh": jax_mesh()} if mesh else {}
    return mod.BatchCoordinator(name, capacity=capacity, num_peers=3, **where,
                                **kw)


def device_fields(pkg, coord) -> dict:
    if pkg == "torch":
        return T.state_to_numpy(coord.state)
    return {k: np.asarray(v) for k, v in coord.state._asdict().items()}


def drive(pkg, mesh, tag, G=16):
    """``tests/test_coordinator.py::test_coordinator_sharded_mesh_parity``'s
    run: three coordinators elect, then three command waves."""
    mod, machine, command, election, registry, C = PKG[pkg]
    reg = registry()
    coords = [coordinator(pkg, f"m{tag}{i}", G, mesh, nodes=reg)
              for i in range(3)]
    ids = lambda g: [(f"g{g}", f"m{tag}{i}") for i in range(3)]  # noqa: E731

    def step_all():
        w = False
        for c in coords:
            w = c.step_once() or w
        return w

    try:
        for c in coords:
            c.add_groups([(f"g{g}", f"cl{g}", ids(g),
                           machine(lambda c_, s: s + c_, 0))
                          for g in range(G)])
        coords[0].deliver_many([((f"g{g}", f"m{tag}0"), election(), None)
                                for g in range(G)])
        for _ in range(300):
            if not step_all():
                break
        assert all(coords[0].by_name[f"g{g}"].role == C.R_LEADER
                   for g in range(G)), "cooperative election incomplete"
        for wave in range(3):
            coords[0].deliver_many(
                [((f"g{g}", f"m{tag}0"),
                  command(kind=USR, data=g + wave + 1, reply_mode="noreply"),
                  None) for g in range(G)])
            for _ in range(300):
                if not step_all():
                    break
        host = [(gh.machine_state, gh.term, gh.role, gh.last_applied)
                for gh in (coords[0].by_name[f"g{g}"] for g in range(G))]
        followers = [[coords[i].by_name[f"g{g}"].machine_state
                      for g in range(G)] for i in (1, 2)]
        st = device_fields(pkg, coords[0])
        dev = tuple(st[f][:G].tolist()
                    for f in ("current_term", "commit_index", "match_index"))
        whole = {k: v[:G] for k, v in st.items()}
        sub_steps = sum(c.sub_steps for c in coords)
        return (host, followers, dev), whole, sub_steps
    finally:
        for c in coords:
            c.stop()


@pytest.mark.parametrize("n", [8, 16])
def test_sharded_coordinators_match_unsharded_and_the_jax_mesh(n):
    """G = 16 over n CPU slices (16: one group a slice) equals the port
    unsharded and the JAX package on its 8-device mesh: host state,
    follower states and device state (``current_term``,
    ``commit_index``, ``match_index``), and on the port every device
    field of the leader's coordinator."""
    jx, _, _ = drive("jax", True, "j")
    un, un_all, _ = drive("torch", 0, "u")
    sh, sh_all, sh_sub = drive("torch", n, "s")
    assert sh == un == jx
    assert un_all.keys() == sh_all.keys()
    for k in un_all:
        np.testing.assert_array_equal(un_all[k], sh_all[k], err_msg=k)
    host, followers, _dev = sh
    assert all(h[0] == g + 1 + g + 2 + g + 3 for g, h in enumerate(host))
    assert followers[0] == [h[0] for h in host]
    # no active-set step over a mesh
    assert sh_sub == 0


def health_run(pkg):
    """``tests/test_health.py::test_sharded_mesh_health_scan_smoke``'s run:
    16 single-member groups elect and apply, then two health scans."""
    mod, machine, command, election, registry, C = PKG[pkg]
    health, board = (TH, TL) if pkg == "torch" else (JH, JL)
    board.clear()
    G = 16
    name = f"hmsh{pkg}"
    c = coordinator(pkg, name, G, 8, nodes=registry())
    try:
        c.add_groups([(f"g{g}", f"cl{g}", [(f"g{g}", name)],
                       machine(lambda c_, s: s + c_, 0)) for g in range(G)])
        c.deliver_many([((f"g{g}", name), election(), None) for g in range(G)])
        for _ in range(200):
            if not c.step_once():
                break
        assert all(c.by_name[f"g{g}"].role == C.R_LEADER for g in range(G))
        c.deliver_many([((f"g{g}", name),
                         command(kind=USR, data=g + 1, reply_mode="noreply"),
                         None) for g in range(G)])
        for _ in range(200):
            if not c.step_once():
                break
        now = time.monotonic()
        c._health_scan(now)
        c._health_scan(now + 1.0)
        sc = health.scanners()[name]
        counts = (sc.counters.get("health_scans"),
                  sc.counters.get("health_fetches"))
        rows = sorted((r["group"], r["role"], r["state"], r["commit_gap"])
                      for r in sc.rows())
        return counts, rows
    finally:
        c.stop()
        board.clear()


def test_health_scan_under_a_mesh_matches_the_jax_mesh():
    """One fetch a scan from the host's side over 8 slices
    (``health_scans == health_fetches == 2``), and the same rows as the
    JAX package's scan over its mesh."""
    counts, rows = health_run("torch")
    assert counts == (2, 2)
    assert len(rows) == 16
    assert all(r[1:] == ("leader", "quiet", 0) for r in rows)
    assert (counts, rows) == health_run("jax")


def _jax_state(fields):
    return J.GroupState(**{k: jnp.asarray(v) for k, v in fields.items()})


@pytest.mark.parametrize("g,n,near_max", [
    (64, 8, False), (64, 8, True), (64, 2, False), (8, 8, False),
])
def test_sharded_packed_step_matches_the_jax_step(g, n, near_max):
    """Three chained full-width steps, the port's state cut into n CPU
    slices and its mailbox split by ``split_mailbox`` (scatter rows at
    every shard edge, negative aliases and pads),
    equal JAX's single-device ``consensus_step_packed_scat``: every
    state field and egress row. G = 8 over 8 has one group a slice."""
    rng = np.random.default_rng(7000 + g + n + near_max)
    fields = cases.state_fields(rng, g, 3, 8, near_max=near_max)
    jst = _jax_state(fields)
    tst = T.split_state(T.state_from_numpy(fields, "cpu"), ["cpu"] * n)
    assert [s.role.shape[0] for s in tst.shards] == [g // n] * n
    for i in range(3):
        packed = cases.shard_edges(
            rng, fields, cases.packed(rng, fields, np.arange(g), g), n)
        jst, je = J.consensus_step_packed_scat(jax_copy(jst), jnp.asarray(packed))
        parts = T.split_mailbox(packed, n)
        tst, te = T.consensus_step_packed_scat_sharded(
            tst, [torch.from_numpy(p) for p in parts])
        np.testing.assert_array_equal(
            np.asarray(je), T.join_egress([e.numpy() for e in te]),
            err_msg=f"egress, step {i}")
        fields = T.state_to_numpy(tst)
        for k, v in jst._asdict().items():
            np.testing.assert_array_equal(np.asarray(v), fields[k],
                                          err_msg=f"{k}, step {i}")


def test_split_mailbox_routes_scatter_rows_by_group():
    """Message rows split by columns; scatter entries go to shard
    gid // Gs rebased, negatives wrap once, a gid of G (or past it, or
    below -G) drops and never lands in shard N; a row whose entries for
    one shard outnumber its columns is refused."""
    G, n = 8, 4
    R = cases.R
    packed = np.zeros((len(cases.ROWS), G), np.int32)
    packed[:len(T.MBOX_FIELDS)] = np.arange(G)[None, :] + 100
    packed[R["a_gid"]] = [1, 2, -1, G, G + 3, -G - 1, 7, 4]
    packed[R["a_hi"]] = np.arange(G) + 10
    packed[R["w_gid"]] = [5, 4, G, 0, G + 1, -G - 1, 1, -2]
    packed[R["w_idx"]] = [3, 9, 4, 1, 6, 2, 8, 11]
    out = T.split_mailbox(packed, n)
    assert out.shape == (n, len(cases.ROWS), 2)
    for s in range(n):
        np.testing.assert_array_equal(out[s, 0], [100 + 2 * s, 101 + 2 * s])
    # appended runs: gid 1 -> shard 0 local 1, 2 -> shard 1 local 0,
    # -1 -> 7 -> shard 3 local 1 (twice: -1 and 7 alias one group; two
    # entries fit the shard's two columns), 4 -> shard 2 local 0
    np.testing.assert_array_equal(out[0, R["a_gid"]], [1, 2])
    np.testing.assert_array_equal(out[0, R["a_hi"]], [10, 0])
    np.testing.assert_array_equal(out[1, R["a_gid"]], [0, 2])
    np.testing.assert_array_equal(out[2, R["a_gid"]], [0, 2])
    np.testing.assert_array_equal(out[3, R["a_gid"]], [1, 1])
    np.testing.assert_array_equal(out[3, R["a_hi"]], [12, 16])
    # watermarks: 5 and 4 -> shard 2 locals 1 and 0, in their order;
    # 0 and 1 -> shard 0; -2 -> 6 -> shard 3 local 0; none for shard 1
    np.testing.assert_array_equal(out[2, R["w_gid"]], [1, 0])
    np.testing.assert_array_equal(out[2, R["w_idx"]], [3, 9])
    np.testing.assert_array_equal(out[0, R["w_gid"]], [0, 1])
    np.testing.assert_array_equal(out[0, R["w_idx"]], [1, 8])
    np.testing.assert_array_equal(out[3, R["w_gid"]], [0, 2])
    np.testing.assert_array_equal(out[3, R["w_idx"]], [11, 0])
    np.testing.assert_array_equal(out[1, R["w_gid"]], [2, 2])
    for row, gids in (("a_gid", [0, 1, 0, G, G, G, G, G]),
                      ("w_gid", [5, 5, -3, G, G, G, G, G])):
        bad = packed.copy()
        bad[R[row]] = gids
        with pytest.raises(ValueError, match="3 entries for shard"):
            T.split_mailbox(bad, n)


@pytest.mark.parametrize("n", [1, 2, 16])
def test_sharded_seam_equals_the_single_seam(n):
    """Every state update of the seam, routed over n CPU slices (16: one
    group a slice), equals the same update on one device, and reads
    give the whole axis: gid lists that leave some slices with no rows,
    pads at G (dropped, never routed to slice N), broadcast values."""
    G, P, K = 16, 3, 8
    rng = np.random.default_rng(n)
    one = DeviceSeam("cpu")
    sh = ShardedSeam(["cpu"] * n)
    a = one.init_state(G, P, K)
    b = sh.init_state(G, P, K)
    assert len(b.shards) == n and b.shard_groups == G // n
    for step in range(12):
        gids = rng.choice(G, size=int(rng.integers(1, 5)), replace=False)
        gids = np.append(gids, G)  # a pad
        m = len(gids)
        vals = {"current_term": rng.integers(0, 9, m),
                "active": rng.random((m, P)) < 0.5,
                "self_slot": int(rng.integers(0, P))}
        calls = [
            ("set_rows", (gids,), vals),
            ("max_rows", (gids,), {"commit_index": rng.integers(0, 9, m)}),
            ("set_roles", (gids, rng.integers(0, 4, m)), {}),
            ("record_appended", (gids, rng.integers(1, 20, m),
                                 rng.integers(1, 5, m)), {}),
            ("record_snapshot", (gids, rng.integers(0, 4, m),
                                 rng.integers(0, 3, m)), {}),
            ("force_elections", (gids,), {}),
        ]
        name, args, kw = calls[step % len(calls)]
        a = getattr(one, name)(a, *args, **kw)
        b = getattr(sh, name)(b, *args, **kw)
        fa, fb = T.state_to_numpy(a), T.state_to_numpy(b)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{name} {k}")
    names = ("current_term", "match_index", "active")
    for x, y in zip(one.read_fields(a, names), sh.read_fields(b, names)):
        np.testing.assert_array_equal(x, y)
    b = sh.set_rows(b, [G - 1], match_index=np.array([4, 5, 6]))
    assert sh.read_match(b, G - 1, 2) == 6


def test_mesh_rules():
    """The reference's divisibility ValueError (same message), the mesh
    replacing the device, and no active set over a mesh even when
    ``active_set="always"`` asks for it."""
    with pytest.raises(ValueError) as port:
        TC.BatchCoordinator("tdiv", capacity=12, num_peers=3,
                            mesh=["cpu"] * 8)
    with pytest.raises(ValueError) as ref:
        JC.BatchCoordinator("jdiv", capacity=12, num_peers=3,
                            mesh=jax_mesh())
    assert str(port.value) == str(ref.value)
    assert "not divisible by mesh size 8" in str(port.value)
    with pytest.raises(ValueError, match="one type"):
        ShardedSeam(["cpu", "meta"])
    TL.clear()
    c = TC.BatchCoordinator("talw", capacity=8, num_peers=3,
                            mesh=[torch.device("cpu")] * 4,
                            active_set="always", nodes=TNodeRegistry())
    try:
        c.add_groups([(f"g{g}", f"cl{g}", [(f"g{g}", "talw")],
                       TSimpleMachine(lambda c_, s: s + c_, 0))
                      for g in range(8)])
        c.deliver_many([((f"g{g}", "talw"), TElectionTimeout(), None)
                        for g in range(8)])
        for _ in range(100):
            if not c.step_once():
                break
        assert all(c.by_name[f"g{g}"].role == T.R_LEADER for g in range(8))
        assert c.steps > 0 and c.sub_steps == 0
        assert [s.role.shape for s in c.state.shards] == [(2,)] * 4
    finally:
        c.stop()
        TL.clear()
