"""The port's quorum scan (``ra_tpu_torch.ops.quorum``) against the JAX
package's Pallas kernel (interpret mode on the CPU), its sort formulation
and the scalar oracle; the kernel itself runs only on a CUDA card.

The kernel's pick (``csrc/quorum_net.cuh``: the entry at the asked
ascending position found by rank, no sort) is held against both JAX
formulations as a numpy model, and the kernel's own code (``csrc/quorum.cu``
up to its host launchers: the row loads, vector or element by element as
the bases' alignment allows, the mask, the pick) is compiled with the
host's C++ compiler behind a small shim and run thread by thread under
``-fsanitize=undefined`` (a misaligned vector access aborts). That
checks the kernel's arithmetic, not nvcc's code generation: the card tests
do that.
"""

import ctypes
import importlib.util
import os
import shutil
import subprocess

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ra_tpu.ops import consensus as J
from ra_tpu.ops import decisions as dec
from ra_tpu.ops.pallas_quorum import agreed_commit_pallas
from ra_tpu_torch.ops import consensus as T
from ra_tpu_torch.ops import kernels
from ra_tpu_torch.ops import quorum as Q

from torch_parity import assert_egress_equal, assert_state_equal, jax_copy, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(seed, p, g=300):
    rng = np.random.default_rng(seed)
    match = rng.integers(0, 1000, (g, p)).astype(np.int32)
    voting = rng.random((g, p)) < 0.8
    voting[:, 0] = True  # at least one voter per group
    nvoters = voting.sum(axis=1).astype(np.int32)
    return match, voting, nvoters


def _port(match, voting, nvoters):
    return Q.agreed_commit(
        torch.from_numpy(match), torch.from_numpy(voting),
        torch.from_numpy(nvoters),
    ).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("p", [3, 5, 7])
def test_port_matches_pallas_sort_and_oracle(seed, p):
    match, voting, nvoters = _inputs(seed, p)
    launches = Q.LAUNCHES
    got = _port(match, voting, nvoters)
    assert Q.LAUNCHES == launches  # CPU tensors never launch the kernel
    jm, jv, jn = jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters)
    pallas = np.asarray(agreed_commit_pallas(jm, jv, jn, interpret=True))
    sort = np.asarray(J.agreed_commit_sort(jm, jv, jn))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, sort)
    for i in range(match.shape[0]):
        voters = [int(match[i, s]) for s in range(p) if voting[i, s]]
        assert got[i] == dec.agreed_commit(voters), (i, voters)


def test_full_single_and_no_voter_edges():
    match = np.asarray([[5, 9, 7], [3, 0, 0], [4, 8, 6]], np.int32)
    voting = np.asarray([[True, True, True], [True, False, False],
                         [False, False, False]])
    nvoters = voting.sum(axis=1).astype(np.int32)
    got = _port(match, voting, nvoters)
    pallas = np.asarray(agreed_commit_pallas(
        jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters),
        interpret=True,
    ))
    np.testing.assert_array_equal(got, pallas)
    assert got[0] == 7  # median of {5, 9, 7}
    assert got[1] == 3  # a single voter's own match
    assert got[2] == -1  # no voter


@pytest.mark.parametrize("p", [1, 2, 4, 6, 8])
def test_every_kernel_width_matches_sort(p):
    match, voting, nvoters = _inputs(10 + p, p, g=257)
    voting[::5] = False  # rows with no voter
    nvoters = voting.sum(axis=1).astype(np.int32)
    got = _port(match, voting, nvoters)
    want = np.asarray(J.agreed_commit_sort(
        jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters)))
    np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_what_the_kernel_cannot_take():
    m = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.ones((4, 3), dtype=torch.bool)
    n = torch.full((4,), 3, dtype=torch.int32)
    with pytest.raises(ValueError):
        Q.agreed_commit(torch.zeros((4, 9), dtype=torch.int32),
                        torch.ones((4, 9), dtype=torch.bool), n)
    with pytest.raises(TypeError):
        Q.agreed_commit(m.long(), v, n)
    with pytest.raises(ValueError):
        Q.agreed_commit(m, v[:3], n)
    with pytest.raises(ValueError):
        Q.agreed_commit(torch.zeros((3, 4), dtype=torch.int32).t(), v, n)


def test_wrapper_checks_every_call_after_a_good_one():
    """A call whose shapes and devices match the last good call takes the
    short check; the type and contiguity tests still raise there, and a
    tensor on another device still takes the full check."""
    m = torch.zeros((4, 3), dtype=torch.int32)
    v = torch.ones((4, 3), dtype=torch.bool)
    n = torch.full((4,), 3, dtype=torch.int32)
    Q.agreed_commit(m, v, n)
    with pytest.raises(TypeError):
        Q.agreed_commit(m, v.to(torch.uint8), n)
    with pytest.raises(TypeError):
        Q.agreed_commit(m, v, n.long())
    with pytest.raises(ValueError):
        Q.agreed_commit(torch.zeros((3, 4), dtype=torch.int32).t(), v, n)
    with pytest.raises(ValueError):
        Q.agreed_commit(m, torch.ones((3, 4), dtype=torch.bool).t(), n)
    with pytest.raises(ValueError):
        Q.agreed_commit(m, v, torch.full((8,), 3, dtype=torch.int32)[::2])
    with pytest.raises(ValueError):
        Q.agreed_commit(m, v, n.to("meta"))
    with pytest.raises(ValueError):
        Q.agreed_commit(m.to("meta"), v.to("meta"), n.to("meta"))
    np.testing.assert_array_equal(Q.agreed_commit(m, v, n).numpy(), [0] * 4)


# -- the kernel's pick, as a numpy model ---------------------------------------


def _rank_pick(match, voting, nvoters):
    """``quorum_pick``'s rank form over rows: the entry v at ascending
    position pos has #{entries < v} <= pos < #{entries <= v}; with ties
    every passing entry holds one value, and the max over them is it."""
    p = match.shape[1]
    m = np.where(voting, match, -1).astype(np.int64)
    lt = (m[:, None, :] < m[:, :, None]).sum(-1)  # [G, s]: entries below m[s]
    le = (m[:, None, :] <= m[:, :, None]).sum(-1)
    pos = np.clip(p - 1 - np.floor_divide(nvoters, 2), 0, p - 1)[:, None]
    hit = (lt <= pos) & (pos < le)
    return np.where(hit, m, np.iinfo(np.int32).min).max(-1).astype(np.int32)


def _edge_inputs(seed, p, g=700):
    """Seeded rows with ties (values from a small range), every member
    voting, a single voter and no voter, and the rows an nvcc miscompile
    once got wrong (``chip_smoke.miscompile_rows``: the largest entry
    last, a lower position asked)."""
    rng = np.random.default_rng(seed)
    match = rng.integers(0, 4, (g, p)).astype(np.int32)
    match[g // 2:] = rng.integers(-2**31, 2**31 - 1, (g - g // 2, p))
    voting = rng.random((g, p)) < 0.6
    voting[0::5] = True  # all voters
    voting[1::5] = False
    voting[1::5, p - 1] = True  # a single voter
    voting[2::5] = False  # no voter
    nvoters = voting.sum(axis=1).astype(np.int32)
    mm, mv, mn = _chip_smoke().miscompile_rows(p)
    return (np.concatenate([match, mm]), np.concatenate([voting, mv]),
            np.concatenate([nvoters, mn]))


@pytest.mark.parametrize("p", list(range(1, 9)))
def test_rank_pick_model_matches_sort_and_pallas(p):
    match, voting, nvoters = _edge_inputs(20 + p, p)
    jm, jv, jn = jnp.asarray(match), jnp.asarray(voting), jnp.asarray(nvoters)
    sort = np.asarray(J.agreed_commit_sort(jm, jv, jn))
    got = _rank_pick(match, voting, nvoters)
    np.testing.assert_array_equal(got, sort)
    # the Pallas kernel pads the peer axis with -1 entries, so it equals
    # the sort where match indices are >= -1, as log indices are: the
    # rows drawn from [0, 4) and the miscompile rows
    idx = (match >= 0).all(axis=1)
    assert idx.sum() > len(match) // 2
    pallas = np.asarray(agreed_commit_pallas(
        jm[idx], jv[idx], jn[idx], interpret=True))
    np.testing.assert_array_equal(got[idx], pallas)
    mm, _, mn = _chip_smoke().miscompile_rows(p)
    if len(mm):  # the asked position, never the last entry
        want = np.sort(mm, axis=1)[np.arange(len(mm)), p - 1 - mn // 2]
        np.testing.assert_array_equal(got[-len(mm):], want)
        assert (want < mm[:, -1]).all()


# -- the kernel's code on the host ---------------------------------------------

MARKER = "// ---- host launchers (nvcc only)"

SHIM = r"""
#pragma once
#include <algorithm>
#include <cstddef>
#include <cstdint>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(x) __attribute__((aligned(x)))
struct ShimDim { unsigned x; };
static ShimDim blockIdx, threadIdx, blockDim;
struct alignas(16) int4 { int x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) int2 { int x, y; };
struct alignas(8) uint2 { unsigned x, y; };
template <class T> inline T __ldg(const T* p) { return *p; }
inline void __syncthreads() {}
using std::max;
using std::min;
"""

RUNNER = r"""
}  // namespace

// the kernel's threads in turn (it has no barrier), at `threads` a block
extern "C" int host_launch(const void* match, const void* voting,
                           const void* nvoters, void* out, int g, int p,
                           int threads) {
  if (!valid(g, p, threads)) return 1;
  const auto* m = static_cast<const int32_t*>(match);
  const auto* v = static_cast<const uint8_t*>(voting);
  const auto* n = static_cast<const int32_t*>(nvoters);
  auto* o = static_cast<int32_t*>(out);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(n) | reinterpret_cast<uintptr_t>(o)) &
       15) == 0;
  blockDim.x = threads;
  for (int b = 0; b < grid_of(g, threads); ++b) {
    blockIdx.x = b;
    for (int x = 0; x < threads; ++x) {
      threadIdx.x = x;
      const int64_t i = static_cast<int64_t>(b) * threads + x;
      if (i >= g) continue;
      switch (p) {
        case 1: pick_group<1>(m, v, n, o, i, aligned); break;
        case 2: pick_group<2>(m, v, n, o, i, aligned); break;
        case 3: pick_group<3>(m, v, n, o, i, aligned); break;
        case 4: pick_group<4>(m, v, n, o, i, aligned); break;
        case 5: pick_group<5>(m, v, n, o, i, aligned); break;
        case 6: pick_group<6>(m, v, n, o, i, aligned); break;
        case 7: pick_group<7>(m, v, n, o, i, aligned); break;
        default: pick_group<8>(m, v, n, o, i, aligned); break;
      }
    }
  }
  return 0;
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or clang++)")
    d = tmp_path_factory.mktemp("quorum_host")
    with open(os.path.join(kernels.CSRC, "quorum.cu")) as f:
        src = f.read()
    assert src.count(MARKER) == 1, "quorum.cu lost its host-launcher marker"
    (d / "cuda_runtime.h").write_text(SHIM)
    (d / "quorum_host.cpp").write_text(src[:src.index(MARKER)] + RUNNER)
    lib = d / "quorum_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fsanitize=undefined",
         "-fno-sanitize-recover=all", "-fPIC", "-shared", "-w",
         f"-I{d}", f"-I{kernels.CSRC}", "-o", str(lib),
         str(d / "quorum_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i = ctypes.c_void_p, ctypes.c_int
    dll.host_launch.restype = ctypes.c_int
    dll.host_launch.argtypes = [vp, vp, vp, vp, i, i, i]
    return dll


def _at_offset(a, off):
    """A copy of ``a`` as a view ``off`` elements into a larger buffer,
    so its base is not 16-byte aligned for off > 0."""
    buf = torch.zeros(a.numel() + off, dtype=a.dtype)
    view = buf[off:off + a.numel()].view(a.shape)
    view.copy_(a)
    return view


# sizes around a tile of 32 and 64 rows, a large ragged one, G = 1
KERNEL_GS = (1, 63, 64, 65, 1001, 10237)
# block sizes the kernel takes
THREADS = (32, 128, 256)


@pytest.mark.parametrize("p", list(range(1, 9)))
def test_kernel_code_matches_plain(host_lib, p):
    """At every G of ``KERNEL_GS`` and block size of ``THREADS``, with
    each input at an aligned base (the vector loads) and at offsets that
    leave it 4-byte or byte aligned (the element loads), the kernel's code
    equals the plain version bit for bit, the miscompile rows included."""
    m, v, n = _edge_inputs(40 + p, p, g=max(KERNEL_GS))
    for g in KERNEL_GS:
        rows = slice(0, g) if g < 1001 else slice(len(m) - g, len(m))
        tm, tv, tn = (torch.from_numpy(np.ascontiguousarray(a[rows]))
                      for a in (m, v, n))
        want = Q.agreed_commit_plain(tm, tv, tn)
        for threads in THREADS:
            for off in ((0, 0, 0), (1, 1, 1), (2, 3, 3), (3, 5, 2)):
                ins = [_at_offset(t, o) for t, o in zip((tm, tv, tn), off)]
                out = torch.full((g,), 7, dtype=torch.int32)
                rc = host_lib.host_launch(*(t.data_ptr() for t in ins),
                                          out.data_ptr(), g, p, threads)
                assert rc == 0
                assert torch.equal(out, want), (g, threads, off)


def test_full_step_with_kernel_backend_matches_pallas_backend():
    """The whole fused step with the port's default (kernel) quorum
    backend equals the JAX step with its Pallas backend, field by field;
    ``configure(quorum_backend="sort")`` gives the same result."""
    rng = np.random.default_rng(5)
    g = 64
    st = J.make_group_state(g, 3)
    st = st._replace(
        role=jnp.full((g,), J.R_LEADER, jnp.int32),
        current_term=jnp.ones((g,), jnp.int32),
        written_index=jnp.asarray(rng.integers(0, 10, g), jnp.int32),
        match_index=jnp.asarray(rng.integers(0, 10, (g, 3)), jnp.int32),
        last_index=jnp.full((g,), 10, jnp.int32),
        last_term=jnp.ones((g,), jnp.int32),
        term_suffix=jnp.ones_like(st.term_suffix),
    )
    port_in = to_torch(st)
    try:
        J.configure(quorum_backend="pallas")
        j_st, j_eg = J.consensus_step(jax_copy(st), J.empty_mailbox(g))
    finally:
        J.configure(quorum_backend="sort")
    mb = T.empty_mailbox(g, device="cpu")
    t_st, t_eg = T.consensus_step(port_in, mb)
    assert_state_equal(j_st, t_st, "kernel backend")
    assert_egress_equal(j_eg, t_eg, "kernel backend")
    assert (np.asarray(j_st.commit_index) > 0).any()  # the scan advanced
    try:
        T.configure(quorum_backend="sort")
        s_st, s_eg = T.consensus_step(port_in, mb)
    finally:
        T.configure(quorum_backend="kernel")
    assert_state_equal(j_st, s_st, "sort backend")
    with pytest.raises(ValueError):
        T.configure(quorum_backend="pallas")


def test_wide_groups_take_the_sort_formulation_and_count_it():
    """P > 8 exceeds the kernel's register network: the step uses the
    sort formulation (the JAX package's own rule) and counts it."""
    st = J.make_group_state(8, 9)
    st = st._replace(role=jnp.full((8,), J.R_LEADER, jnp.int32),
                     written_index=jnp.full((8,), 3, jnp.int32))
    before = T.WIDE_SORT_STEPS
    t_st, _ = T.consensus_step(to_torch(st), T.empty_mailbox(8, device="cpu"))
    assert T.WIDE_SORT_STEPS == before + 1
    j_st, _ = J.consensus_step(jax_copy(st), J.empty_mailbox(8))
    assert_state_equal(j_st, t_st)
