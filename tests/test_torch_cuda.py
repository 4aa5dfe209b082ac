"""The port on a CUDA card: the quorum kernel against its plain version,
the step kernels (full width and active set) against the plain torch-op
step on the card and on the CPU over the edge inputs of
``torch_step_cases``, a small 3-coordinator cluster committing
through the step kernels (unsharded, and over a mesh of four slices on
one card, whose sharded step is also held against the unsharded one), three started coordinators serving the
client API (``ra_tpu_torch.api``) through them, and the fault-injection
harness and the linearizability workload with their coordinators on the
card, and the decision bench's loop on the kernel against the plain
step. Every test skips without a card (the kernels
have no CPU mode). Run on a GPU machine from the repository root; the
file imports no JAX, so it also runs where JAX is not installed:

    python3 -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""

import importlib.util
import os
import time

import numpy as np
import pytest
import torch

from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.ops import quorum as Q
from ra_tpu_torch.ops import step as S

import torch_step_cases as cases

pytestmark = pytest.mark.cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")
    return torch.device("cuda")


def _quorum_inputs(rng, g, p):
    match = rng.integers(0, 1 << 20, (g, p)).astype(np.int32)
    voting = rng.random((g, p)) < 0.7
    voting[::3] = False
    voting[1::3] = True
    nvoters = voting.sum(axis=1).astype(np.int32)
    return match, voting, nvoters


@pytest.mark.parametrize("p", list(range(1, 9)))
def test_kernel_matches_plain_on_the_card(dev, p):
    rng = np.random.default_rng(p)
    args = [torch.from_numpy(a).to(dev) for a in _quorum_inputs(rng, 1001, p)]
    launches = Q.LAUNCHES
    got = Q.agreed_commit(*args)
    assert Q.LAUNCHES == launches + 1
    assert torch.equal(got, Q.agreed_commit_plain(*args))


# G around one tile of the kernel (64 groups), a large ragged G, the main
# path's G and G = 1
QUORUM_GS = (1, 63, 64, 65, 1001, 10237, 10240)


@pytest.mark.parametrize("p", list(range(1, 9)))
def test_kernel_at_every_g_matches_plain_and_counts_each_launch(dev, p):
    rng = np.random.default_rng(100 + p)
    for g in QUORUM_GS:
        args = [torch.from_numpy(a).to(dev) for a in _quorum_inputs(rng, g, p)]
        launches = Q.LAUNCHES
        got = Q.agreed_commit(*args)
        assert Q.LAUNCHES == launches + 1, g
        assert torch.equal(got, Q.agreed_commit_plain(*args)), g


@pytest.mark.parametrize("p", list(range(3, 9)))
def test_kernel_picks_below_the_last_entry(dev, p):
    """Every position 0..P-2 asked of rows whose largest entry sits last
    (nvcc 12.8 at -O3 returned that last entry for a register select
    chain over the sorted row)."""
    m, v, n = _chip_smoke().miscompile_rows(p)
    got = Q.agreed_commit(*(torch.from_numpy(a).to(dev) for a in (m, v, n)))
    want = np.sort(m, axis=1)[np.arange(len(m)), p - 1 - n // 2]
    assert (want < 10 * p).all()
    np.testing.assert_array_equal(got.cpu().numpy(), want)


def test_kernel_takes_views_at_an_offset(dev):
    """Input bases that are 4-byte or byte aligned, not 16-byte (views
    into larger buffers): the kernel stages them with narrower loads."""
    rng = np.random.default_rng(5)
    for p in (3, 4, 8):
        arrays = _quorum_inputs(rng, 1001, p)
        want = Q.agreed_commit_plain(*(torch.from_numpy(a) for a in arrays))
        for off in ((1, 1, 1), (2, 3, 3), (3, 5, 2)):
            views = []
            for a, o in zip(arrays, off):
                t = torch.from_numpy(a).to(dev)
                buf = torch.zeros(t.numel() + o, dtype=t.dtype, device=dev)
                views.append(buf[o:].view(t.shape))
                views[-1].copy_(t)
            assert views[1].data_ptr() % 16
            assert torch.equal(Q.agreed_commit(*views).cpu(), want), (p, off)


def test_every_block_size_matches_plain(dev):
    """The sweep's entry (``ra_quorum_launch_tiled``) at every block size
    it takes, at aligned bases and with the voting mask at an offset; a
    block size it does not take is refused with cudaErrorInvalidValue
    before any launch."""
    fn = Q._kernel("ra_quorum_launch_tiled")
    stream = torch._C._cuda_getCurrentRawStream(dev.index or 0)
    rng = np.random.default_rng(9)
    for p in (1, 3, 4, 6, 7, 8):
        for g in (65, 10237):
            m, v, n = (torch.from_numpy(a).to(dev)
                       for a in _quorum_inputs(rng, g, p))
            want = Q.agreed_commit_plain(m, v, n)
            vbuf = torch.zeros(v.numel() + 3, dtype=torch.bool, device=dev)
            v_off = vbuf[3:].view(v.shape)
            v_off.copy_(v)
            for threads in (32, 64, 96, 128, 256):
                for vv in (v, v_off):
                    out = torch.full((g,), 7, dtype=torch.int32, device=dev)
                    assert fn(m.data_ptr(), vv.data_ptr(), n.data_ptr(),
                              out.data_ptr(), g, p, threads, stream) == 0
                    assert torch.equal(out, want), (p, g, threads)
    for threads in (0, 48, 512):
        assert fn(m.data_ptr(), v.data_ptr(), n.data_ptr(), out.data_ptr(),
                  g, p, threads, stream) != 0


def test_kernel_wrapper_refuses_on_the_card(dev):
    m = torch.zeros((4, 9), dtype=torch.int32, device=dev)
    v = torch.ones((4, 9), dtype=torch.bool, device=dev)
    n = torch.full((4,), 9, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        Q.agreed_commit(m, v, n)
    with pytest.raises(ValueError):
        Q.agreed_commit(m[:, :3], v[:, :3], n)
    with pytest.raises(ValueError):
        Q.agreed_commit(m[:, :3].contiguous(), v[:, :3].contiguous(), n.cpu())
    launches = Q.LAUNCHES
    empty = Q.agreed_commit(m[:0, :3].contiguous(), v[:0, :3].contiguous(), n[:0])
    assert empty.shape == (0,) and empty.device.type == "cuda"
    assert Q.LAUNCHES == launches


def test_fused_step_on_the_card_matches_the_cpu(dev):
    rng = np.random.default_rng(3)
    g, p, k = 512, 3, 16
    st = C.make_group_state(g, p, k, device="cpu")
    last = rng.integers(0, 10, g).astype(np.int32)
    fields = C.state_to_numpy(st)
    fields.update(
        role=np.full(g, C.R_LEADER, np.int32),
        current_term=np.ones(g, np.int32),
        last_index=last, last_term=np.ones(g, np.int32),
        written_index=last, term_suffix=np.ones((g, k), np.int32),
        match_index=np.minimum(rng.integers(0, 10, (g, p)), last[:, None]).astype(np.int32),
        voting=np.ones((g, p), bool), active=np.ones((g, p), bool),
    )
    cpu = C.state_from_numpy(fields, "cpu")
    card = C.state_from_numpy(fields, dev)
    packed = np.zeros((len(C.MBOX_FIELDS) + len(C.MBOX_SCAT_FIELDS), g), np.int32)
    R = {f: i for i, f in enumerate(C.MBOX_FIELDS + C.MBOX_SCAT_FIELDS)}
    packed[R["host_term_idx"]] = -1
    packed[R["host_term_val"]] = -1
    packed[R["msg_type"]] = C.MSG_AER_REPLY
    packed[R["sender_slot"]] = rng.integers(0, p, g)
    packed[R["term"]] = 1
    packed[R["success"]] = 1
    packed[R["reply_last_idx"]] = last
    packed[R["a_gid"]] = g
    packed[R["w_gid"]] = g
    cpu2, eg_cpu = C.consensus_step_packed_scat(cpu, torch.from_numpy(packed))
    card2, eg_card = C.consensus_step_packed_scat(card, torch.from_numpy(packed).to(dev))
    assert torch.equal(eg_card.cpu(), eg_cpu)
    a, b = C.state_to_numpy(card2), C.state_to_numpy(cpu2)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    assert (b["commit_index"] > 0).any()


def _assert_same(st_a, eg_a, st_b, eg_b, where):
    eg_a, eg_b = eg_a.cpu(), eg_b.cpu()
    bad = [f for r, f in enumerate(C.EGRESS_FIELDS)
           if not torch.equal(eg_a[r], eg_b[r])]
    assert not bad, f"{where}: egress rows differ: {bad}"
    a, b = C.state_to_numpy(st_a), C.state_to_numpy(st_b)
    bad = [f for f in a if not np.array_equal(a[f], b[f])]
    assert not bad, f"{where}: state fields differ: {bad}"


@pytest.mark.parametrize("near_max", [False, True])
@pytest.mark.parametrize("p", list(range(1, 17)) + [33])
def test_step_kernels_match_the_plain_step(dev, p, near_max):
    """Full width and active set, K in {8, 32}, at the peer widths with
    register instances (1..8) and of the runtime-width instance (9..16,
    33): the kernel on the card
    equals the plain step on the card and on the CPU, in every state
    field and egress row, over the edge inputs; the quorum kernel is
    not launched on the kernel path."""
    g = 1000
    for k in (8, 32):
        rng = np.random.default_rng(100 * p + k + near_max)
        f = cases.state_fields(rng, g, p, k, near_max=near_max)
        cpu, card = C.state_from_numpy(f, "cpu"), C.state_from_numpy(f, dev)
        packed = cases.packed(rng, f, np.arange(g), g)
        gidx = cases.active_set(rng, g, 300, 512)
        sub = cases.packed(rng, f, gidx, 512)
        runs = (
            ("full", (packed,), C.consensus_step_packed_scat,
             C.consensus_step_packed_scat_plain),
            ("sub", (sub, gidx), C.consensus_step_packed_sub_scat,
             C.consensus_step_packed_sub_scat_plain),
        )
        for kind, args, kernel_fn, plain_fn in runs:
            host = [torch.from_numpy(a) for a in args]
            on_card = [a.to(dev) for a in host]
            counts = (S.LAUNCHES_FULL, S.LAUNCHES_SUB, Q.LAUNCHES)
            got = kernel_fn(card, *on_card)
            torch.cuda.synchronize()
            want = (1, 0) if kind == "full" else (0, 1)
            assert (S.LAUNCHES_FULL - counts[0], S.LAUNCHES_SUB - counts[1],
                    Q.LAUNCHES - counts[2]) == want + (0,)
            where = f"{kind} p={p} k={k} near_max={near_max}"
            _assert_same(*got, *plain_fn(card, *on_card), where + " card")
            _assert_same(*got, *plain_fn(cpu, *host), where + " cpu")
            # the input state is untouched: nothing is updated in place
            kept = C.state_to_numpy(card)
            assert all(np.array_equal(kept[n], f[n]) for n in f), where


def test_step_kernel_refuses_what_it_cannot_take(dev):
    rng = np.random.default_rng(5)
    f = cases.state_fields(rng, 64, 3, 8)
    card = C.state_from_numpy(f, dev)
    packed = torch.from_numpy(cases.packed(rng, f, np.arange(64), 64))
    with pytest.raises(ValueError):  # mailbox left on the host
        C.consensus_step_packed_scat(card, packed)
    with pytest.raises(ValueError):  # a strided mailbox
        wide = torch.zeros((24, 128), dtype=torch.int32, device=dev)
        C.consensus_step_packed_scat(card, wide[:, ::2])


def _offset_ring(st):
    """``st`` with its ring moved to a view 4 bytes past an aligned
    allocation: the kernel's tiles of it take the plain staging path."""
    g, k = st.term_suffix.shape
    ring = torch.empty(g * k + 1, dtype=torch.int32,
                       device=st.term_suffix.device)[1:].view(g, k)
    ring.copy_(st.term_suffix)
    return st._replace(term_suffix=ring)


def _low_run(packed):
    """``packed`` with its first appended run (a real group's) moved to
    the bottom of the int32 range, where the kernel walks every ring slot
    (``lay_run``'s wrapping branch)."""
    packed[cases.R["a_lo"], 0] = -2**31
    packed[cases.R["a_hi"], 0] = -2**31 + 3
    return packed


def _chain(dev, g, p, k, seed, steps=6):
    """``steps`` chained steps from a seeded state (full width and active
    set in turn, each fed the returned state), the first input's ring an
    offset view, one run of each step at the bottom of the int32 range;
    each step held against the plain step on the card. Returns the last
    state."""
    rng = np.random.default_rng(seed)
    st = _offset_ring(C.state_from_numpy(cases.state_fields(rng, g, p, k), dev))
    for i in range(steps):
        host = C.state_to_numpy(st)
        if i % 2 == 0:
            args = (_low_run(cases.packed(rng, host, np.arange(g), g)),)
            kern, plain = (C.consensus_step_packed_scat,
                           C.consensus_step_packed_scat_plain)
        else:
            gidx = cases.active_set(rng, g, min(g // 4, 300), 512)
            args = (_low_run(cases.packed(rng, host, gidx, 512)), gidx)
            kern, plain = (C.consensus_step_packed_sub_scat,
                           C.consensus_step_packed_sub_scat_plain)
        on_card = [torch.from_numpy(a).to(dev) for a in args]
        got = kern(st, *on_card)
        _assert_same(*got, *plain(st, *on_card), f"g={g} k={k} step {i}")
        st = got[0]
    return st


@pytest.mark.parametrize("g,k,wrap", [
    (1000, 32, False), (1001, 32, True), (1001, 7, False), (4099, 8, True),
])
def test_chained_steps_on_one_scratch_match_the_plain_step(dev, g, k, wrap):
    """Six chained steps on one persistent scratch, never cleared between
    them, at an even and an odd G, with K = 7 (unaligned rows) and an
    offset ring: each equals the plain step. ``wrap`` starts the epochs
    two below 2**32, so the third launch zeroes the scratch and counts
    from 1 again. One launch a step, no other scratch made."""
    here = torch.device("cuda", torch.cuda.current_device())
    scratch = S.scratch_for(here, torch.cuda.current_stream(here).cuda_stream, g)
    if wrap:
        scratch.epoch = 0xFFFFFFFF - 2
    e0 = scratch.epoch
    n0 = (S.LAUNCHES_FULL, S.LAUNCHES_SUB, len(S._scratches))
    _chain(dev, g, 3, k, seed=g + k)
    assert (S.LAUNCHES_FULL - n0[0], S.LAUNCHES_SUB - n0[1]) == (3, 3)
    assert len(S._scratches) == n0[2]
    assert scratch.epoch == (4 if wrap else e0 + 6)


def test_two_threads_step_two_states_at_once(dev):
    """Two Python threads step two states of the same G on cuda:0's
    current stream at once (so they share one scratch and its epochs),
    with a short interpreter switch interval: each gets its plain
    result at every step."""
    import sys
    import threading

    errors = []
    start = threading.Barrier(2)

    def worker(seed):
        try:
            start.wait(timeout=60)
            _chain(dev, 2048, 3, 32, seed=seed, steps=20)
        except BaseException as e:  # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(s,)) for s in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors


def test_two_streams_get_two_scratches(dev):
    """A step on another stream takes a scratch of its own, and both
    streams' steps equal the plain step."""
    g = 1000
    side = torch.cuda.Stream(dev)
    main = torch.cuda.current_stream(dev)
    _chain(dev, g, 3, 32, seed=7, steps=2)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        _chain(dev, g, 3, 32, seed=8, steps=2)
    main.wait_stream(side)
    index = torch.cuda.current_device()
    a = S._scratches[(index, main.cuda_stream, g)]
    b = S._scratches[(index, side.cuda_stream, g)]
    assert a is not b and a.buf.data_ptr() != b.buf.data_ptr()


def test_a_refused_launch_raises(dev):
    """A ring too wide for the tile in shared memory (K = 1024: 256 KB a
    block) is refused by the card; the wrapper raises and does not fall
    back to the plain step."""
    rng = np.random.default_rng(11)
    g, k = 128, 1024
    f = cases.state_fields(rng, g, 3, k)
    card = C.state_from_numpy(f, dev)
    packed = torch.from_numpy(cases.packed(rng, f, np.arange(g), g)).to(dev)
    n0 = S.LAUNCHES_FULL
    with pytest.raises(RuntimeError, match="CUDA error"):
        C.consensus_step_packed_scat(card, packed)
    assert S.LAUNCHES_FULL == n0


def test_three_coordinators_commit_through_the_kernel(dev):
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import USR, Command, ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = 64
    coords = [BatchCoordinator(f"cu{i}", capacity=g_n, num_peers=3,
                               idle_sleep_s=0, device=dev) for i in range(3)]
    try:
        for c in coords:
            c.add_groups([
                (f"g{g}", f"cucl{g}", [(f"g{g}", f"cu{i}") for i in range(3)],
                 SimpleMachine(lambda cmd, s: s + cmd, 0), None)
                for g in range(g_n)
            ])

        def step():
            worked = False
            for c in coords:
                worked = c.step_stage() or worked
            for c in coords:
                worked = c.step_finish() or worked
            return worked

        launches = S.LAUNCHES_FULL + S.LAUNCHES_SUB
        coords[0].deliver_many(
            [((f"g{g}", "cu0"), ElectionTimeout(), None) for g in range(g_n)])
        for _ in range(200):
            step()
            if all(coords[0].by_name[f"g{g}"].role == C.R_LEADER
                   for g in range(g_n)):
                break
        for g in range(g_n):
            coords[0].deliver((f"g{g}", "cu0"),
                              Command(kind=USR, data=g, reply_mode="noreply"), None)
        for _ in range(200):
            if not step() and all(
                c.by_name[f"g{g}"].machine_state == g
                for c in coords for g in range(g_n)
            ):
                break
        for c in coords:
            assert [c.by_name[f"g{g}"].machine_state for g in range(g_n)] == list(range(g_n))
            assert c.state.commit_index.device.type == "cuda"
        assert S.LAUNCHES_FULL + S.LAUNCHES_SUB > launches
    finally:
        for c in coords:
            c.stop()


def test_sharded_step_over_four_slices_matches_the_unsharded_kernel(dev):
    """The state cut into four slices on the card, stepped slice by slice
    (one step-kernel launch a slice), equals the unsharded step kernel
    and the plain step (on the card and on the CPU) over six chained
    steps with scatter rows at every slice edge and pads. The slices share one scratch (same card, stream and G/4), whose
    epochs start two below 2**32: the wrap falls inside the first
    sharded step."""
    g, n = 4096, 4
    here = torch.device("cuda", torch.cuda.current_device())
    scratch = S.scratch_for(here, torch.cuda.current_stream(here).cuda_stream,
                            g // n)
    scratch.epoch = 0xFFFFFFFF - 2
    rng = np.random.default_rng(41)
    whole = C.state_from_numpy(cases.state_fields(rng, g, 3, 32), here)
    sharded = C.split_state(whole, [here] * n)
    n0 = (S.LAUNCHES_FULL, S.LAUNCHES_SUB)
    for i in range(6):
        host = C.state_to_numpy(whole)
        packed = cases.shard_edges(
            rng, host, cases.packed(rng, host, np.arange(g), g), n)
        on_dev = torch.from_numpy(packed).to(here)
        plain_dev = C.consensus_step_packed_scat_plain(whole, on_dev)
        plain_cpu = C.consensus_step_packed_scat_plain(
            C.state_from_numpy(host, "cpu"), torch.from_numpy(packed))
        whole, eg = C.consensus_step_packed_scat(whole, on_dev)
        sharded, egs = C.consensus_step_packed_scat_sharded(
            sharded, [torch.from_numpy(p).to(here)
                      for p in C.split_mailbox(packed, n)])
        b = C.state_to_numpy(sharded)
        b_eg = C.join_egress([e.cpu().numpy() for e in egs])
        for name, (st, e) in (("kernel", (whole, eg)), ("plain card", plain_dev),
                              ("plain cpu", plain_cpu)):
            a = C.state_to_numpy(st)
            for k in a:
                np.testing.assert_array_equal(
                    a[k], b[k], err_msg=f"{k} step {i} vs {name}")
            np.testing.assert_array_equal(
                e.cpu().numpy(), b_eg, err_msg=f"egress step {i} vs {name}")
    assert (S.LAUNCHES_FULL - n0[0], S.LAUNCHES_SUB - n0[1]) == (6 * (n + 1), 0)
    assert scratch.epoch == 6 * n - 2


def test_four_slice_coordinators_commit_a_wave(dev):
    """Three coordinators, each over a mesh of four slices on cuda:0,
    elect and commit a wave of commands on every replica: each step
    launches the step kernel once a slice, and never the active set."""
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import USR, Command, ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n, n = 64, 4
    here = torch.device("cuda", torch.cuda.current_device())
    coords = [BatchCoordinator(f"cm{i}", capacity=g_n, num_peers=3,
                               idle_sleep_s=0, mesh=[here] * n)
              for i in range(3)]
    try:
        for c in coords:
            c.add_groups([
                (f"g{g}", f"cmcl{g}", [(f"g{g}", f"cm{i}") for i in range(3)],
                 SimpleMachine(lambda cmd, s: s + cmd, 0), None)
                for g in range(g_n)
            ])

        def step():
            worked = False
            for c in coords:
                worked = c.step_stage() or worked
            for c in coords:
                worked = c.step_finish() or worked
            return worked

        n0 = (S.LAUNCHES_FULL, S.LAUNCHES_SUB, sum(c.steps for c in coords))
        coords[0].deliver_many(
            [((f"g{g}", "cm0"), ElectionTimeout(), None) for g in range(g_n)])
        for _ in range(200):
            step()
            if all(coords[0].by_name[f"g{g}"].role == C.R_LEADER
                   for g in range(g_n)):
                break
        for g in range(g_n):
            coords[0].deliver((f"g{g}", "cm0"),
                              Command(kind=USR, data=g, reply_mode="noreply"), None)
        for _ in range(200):
            if not step() and all(
                c.by_name[f"g{g}"].machine_state == g
                for c in coords for g in range(g_n)
            ):
                break
        for c in coords:
            assert [c.by_name[f"g{g}"].machine_state for g in range(g_n)] == list(range(g_n))
            assert [st.commit_index.device for st in c.state.shards] == [here] * n
            assert c.sub_steps == 0
        steps = sum(c.steps for c in coords) - n0[2]
        assert steps > 0
        assert (S.LAUNCHES_FULL - n0[0], S.LAUNCHES_SUB - n0[1]) == (n * steps, 0)
    finally:
        for c in coords:
            c.stop()


def test_api_drives_started_coordinators_through_the_kernel(dev, tmp_path):
    """Three started coordinators (own step threads) on the card, with
    WAL-backed logs and leases, serve ``ra_tpu_torch.api``: every reply
    and consistent read is the group's sum, replicas agree, and the
    step kernels launched while quorum.cu did not."""
    import os

    from ra_tpu_torch import api, leaderboard
    from ra_tpu_torch.log.log import Log
    from ra_tpu_torch.log.segment_writer import SegmentWriter
    from ra_tpu_torch.log.tables import TableRegistry
    from ra_tpu_torch.log.wal import Wal
    from ra_tpu_torch.machine import SimpleMachine
    from ra_tpu_torch.protocol import ElectionTimeout
    from ra_tpu_torch.runtime.coordinator import BatchCoordinator

    g_n = 48
    names = [f"ca{i}" for i in range(3)]
    leaderboard.clear()
    coords = [BatchCoordinator(n, capacity=g_n, num_peers=3, device=dev,
                               lease=True) for n in names]
    storage = []
    try:
        for n, c in zip(names, coords):
            d = str(tmp_path / n)
            tables = TableRegistry()
            sw = SegmentWriter(os.path.join(d, "data"), tables, c.wal_notify)
            wal = Wal(os.path.join(d, "wal"), tables, c.wal_notify,
                      segment_writer=sw)
            wal.notify_many = c.wal_notify_many
            storage.append((wal, sw))
            c.add_groups([
                (f"g{g}", f"cacl{g}", [(f"g{g}", m) for m in names],
                 SimpleMachine(lambda cmd, s: s + cmd, 0),
                 Log(f"g{g}", os.path.join(d, "data", f"g{g}"), tables, wal))
                for g in range(g_n)
            ])
        launches = (S.LAUNCHES_FULL + S.LAUNCHES_SUB, Q.LAUNCHES)
        for c in coords:
            c.start()
        coords[0].deliver_many(
            [((f"g{g}", "ca0"), ElectionTimeout(), None) for g in range(g_n)])
        for g in range(g_n):
            sid = (f"g{g}", names[g % 3])
            assert api.process_command(sid, g, timeout=30)[0] == g
            assert api.process_command(sid, 1, timeout=30)[0] == g + 1
            out = api.consistent_query((f"g{g}", names[(g + 1) % 3]),
                                       lambda s: s, timeout=30)
            assert out[:2] == ("ok", g + 1)
        for g in range(g_n):
            for n in names:
                for _ in range(300):
                    if api.local_query((f"g{g}", n), lambda s: s)[1] == g + 1:
                        break
                    time.sleep(0.02)
                assert api.local_query((f"g{g}", n), lambda s: s)[1] == g + 1
        for c in coords:
            assert c.state.commit_index.device.type == "cuda"
        assert S.LAUNCHES_FULL + S.LAUNCHES_SUB > launches[0]
        assert Q.LAUNCHES == launches[1]
    finally:
        for c in reversed(coords):  # followers first, then the leader
            c.stop()
        for wal, sw in storage:
            wal.close()
            sw.close()
        leaderboard.clear()


def test_harness_runs_the_batch_backend_on_the_card(dev):
    """The combined-fault harness run of ``tests/test_soak.py`` (seed 2,
    every nemesis dimension, a coordinator crash-restart from the WAL
    and live active-set mode flips) with the coordinators on the card,
    then the live linearizability workload: consistent, linearizable,
    and through the step kernels only."""
    from ra_tpu_torch import kv_harness, linearize

    launches = (S.LAUNCHES_FULL + S.LAUNCHES_SUB, Q.LAUNCHES)
    res = kv_harness.run(seed=2, n_ops=60, backend="tpu_batch",
                         combined=True, device=dev)
    assert res.consistent, res.failures
    assert res.ops.get("coord_restart", 0) > 0
    assert res.nemesis.get("nemesis_modeflip_injected", 0) > 0
    lin = linearize.run_workload(seed=9, backend="tpu_batch", n_clients=4,
                                 ops_per_client=30, device=dev)
    assert lin.ok, lin.violations
    assert S.LAUNCHES_FULL + S.LAUNCHES_SUB > launches[0]
    assert Q.LAUNCHES == launches[1]


def test_decision_loop_on_the_kernel_matches_the_plain_step(dev):
    """The decision bench's loop (``ra_tpu_torch.bench.decisions_loop``)
    through the step kernel against the same loop through the plain
    torch-op step, both on the card: equal final state, field for field,
    and equal per-step success sums; one kernel launch per step."""
    from ra_tpu_torch import bench

    g, t = 1000, 8
    launches = (S.LAUNCHES_FULL, S.LAUNCHES_SUB, Q.LAUNCHES)
    st, sums = bench.decisions_loop(g, t, dev)
    assert (S.LAUNCHES_FULL, S.LAUNCHES_SUB, Q.LAUNCHES) == (
        launches[0] + t, launches[1], launches[2])
    st_p, sums_p = bench.decisions_loop(
        g, t, dev, step=C.consensus_step_packed_scat_plain)
    for name, a, b in zip(C.GroupState._fields, st, st_p):
        assert torch.equal(a, b), name
    assert torch.equal(sums, sums_p)
    assert (sums.cpu() == g).all()
