"""The step kernel's code (``csrc/step.cu``) on the CPU, against the plain
torch-op step.

A CUDA kernel has no CPU mode, so this test compiles the kernel source up
to its host launchers with the host's C++ compiler behind a small shim
(``__global__``/``__device__`` empty, ``blockIdx``/``threadIdx``/``gridDim``
globals, sequential atomics, and its own ``step_async.cuh``: a bulk copy
is a ``memcpy``, the mbarrier, block and grid barriers are no-ops) and
with ``-fsanitize=undefined`` (a signed overflow, an out-of-bounds shift
or a misaligned vector access aborts). A host loop runs the cooperative
kernel's order by hand: phase A (the scatter index) for every thread of
every block, then phase B block by block, each block's tiles in turn and
each tile's sub-phases (stage, compute, write back) thread by thread.
The wrapper's own host code (``ops.step.run``: the output buffer and its
views, the pointer arrays, the persistent ``Scratch`` and its epochs)
drives it over CPU tensors; the result must equal the plain step in
every state field and egress row, over the edge inputs of
``torch_step_cases``. Both the register instances (P = 1..8) and the
runtime-width instance (any P) run. It checks the kernel's arithmetic,
not nvcc's code generation: the card tests do that.
"""

import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from ra_tpu_torch.ops import consensus as C
from ra_tpu_torch.ops import kernels
from ra_tpu_torch.ops import step as S

import torch_step_cases as cases

MARKER = "// ---- host launchers (nvcc only)"

SHIM = r"""
#pragma once
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(x) __attribute__((aligned(x)))
struct ShimDim { unsigned x; };
static ShimDim blockIdx, threadIdx, blockDim, gridDim;
struct alignas(16) int4 { int x, y, z, w; };
using std::max;
using std::min;
template <class T> inline T atomicMax(T* a, T v) { T o = *a; if (v > o) *a = v; return o; }
"""

ASYNC_SHIM = r"""
#pragma once
#include <cstdint>
#include <cstring>
// the runner orders the phases and sub-phases itself
inline void bar_init(uint64_t*, unsigned) {}
inline void bar_arrive(uint64_t*) {}
inline void bulk_copy(void* dst, const void* src, unsigned bytes, uint64_t*) {
  std::memcpy(dst, src, bytes);
}
inline void bar_wait(uint64_t*, uint32_t) {}
inline void block_sync() {}
inline void grid_sync() {}
template <class T> inline T load_cg(const T* p) { return *p; }
"""

RUNNER = r"""
}  // namespace

#include <vector>

namespace {

// one block's share of phase B: its tiles in turn, each sub-phase for
// every thread before the next (the prologue, which reads nothing of
// the maps, runs after phase A here and before it on the card)
template <int P>
void host_items(const Args& a, unsigned block, int32_t* tile,
                int32_t* dst_row) {
  uint64_t bar = 0;
  uint32_t parity = 0;
  std::vector<Pre<P>> pre(kThreads);
  blockIdx.x = block;
  for (int item = block; item < a.items; item += gridDim.x) {
    const Tile t = tile_of(a, item);
    for (unsigned x = 0; x < kThreads; ++x) {
      threadIdx.x = x;
      stage_tile(a, t, tile, &bar);
      pre[x] = prologue<P>(a, t);
    }
    for (unsigned x = 0; x < kThreads; ++x) {
      threadIdx.x = x;
      if (t.step) {
        step_column<P>(a, t, pre[x], tile, dst_row, &bar, parity);
      } else {
        pass_group<P>(a, t, pre[x], tile, dst_row, &bar, parity);
      }
    }
    for (unsigned x = 0; x < kThreads; ++x) {
      threadIdx.x = x;
      write_back(a, t, tile, dst_row);
    }
    parity ^= 1;
  }
}

}  // namespace

// the cooperative launch of launch_all, on `grid` blocks, thread by
// thread; runtime_width forces the runtime-width instance at any p
extern "C" int host_launch(const void* const* in, void** next_in, void* out,
                           const void* packed, const void* gidx,
                           void* scratch, unsigned epoch, int g, int p,
                           int k, int s, int grid, int runtime_width) {
  Args a = make_args(in, next_in, out, packed, gidx, scratch, epoch, g, p, k,
                     s);
  blockDim.x = kThreads;
  gridDim.x = grid;
  for (int b = 0; b < grid; ++b) {
    blockIdx.x = b;
    for (unsigned x = 0; x < kThreads; ++x) {
      threadIdx.x = x;
      scatter_index(a);
    }
  }
  std::vector<int4> store(kThreads * static_cast<size_t>(k) / 4 + 1);
  int32_t* tile = reinterpret_cast<int32_t*>(store.data());
  int32_t dst_row[kThreads];
  for (int b = 0; b < grid; ++b) {
    switch (runtime_width ? 0 : p) {
      case 1: host_items<1>(a, b, tile, dst_row); break;
      case 2: host_items<2>(a, b, tile, dst_row); break;
      case 3: host_items<3>(a, b, tile, dst_row); break;
      case 4: host_items<4>(a, b, tile, dst_row); break;
      case 5: host_items<5>(a, b, tile, dst_row); break;
      case 6: host_items<6>(a, b, tile, dst_row); break;
      case 7: host_items<7>(a, b, tile, dst_row); break;
      case 8: host_items<8>(a, b, tile, dst_row); break;
      default: host_items<0>(a, b, tile, dst_row); break;
    }
  }
  return 0;
}

extern "C" void host_out_offsets(int g, int p, int k, int s, long long* off) {
  out_offsets(g, p, k, s, off);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("needs a host C++ compiler (g++ or clang++)")
    d = tmp_path_factory.mktemp("step_host")
    with open(os.path.join(kernels.CSRC, "step.cu")) as f:
        src = f.read()
    assert src.count(MARKER) == 1, "step.cu lost its host-launcher marker"
    (d / "cuda_runtime.h").write_text(SHIM)
    # found beside the source before -I: it stands in for csrc's own
    (d / "step_async.cuh").write_text(ASYNC_SHIM)
    (d / "step_host.cpp").write_text(src[:src.index(MARKER)] + RUNNER)
    lib = d / "step_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fsanitize=undefined",
         "-fno-sanitize-recover=all", "-fPIC", "-shared", "-w",
         f"-I{d}", f"-I{kernels.CSRC}", "-o", str(lib),
         str(d / "step_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    dll = ctypes.CDLL(str(lib))
    vp, i, u = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    ptrs = ctypes.POINTER(ctypes.c_void_p)
    dll.host_launch.restype = ctypes.c_int
    dll.host_launch.argtypes = [ptrs, ptrs, vp, vp, vp, vp, u, i, i, i, i, i, i]
    dll.host_out_offsets.restype = None
    dll.host_out_offsets.argtypes = [i, i, i, i, ctypes.POINTER(ctypes.c_longlong)]
    return dll


def _launcher(lib, full, grid, runtime_width):
    """A stand-in for ``ra_step_full_launch`` / ``ra_step_sub_launch``
    with their signatures, running the host loop on ``grid`` blocks."""
    if full:
        def fn(ins, nxt, out, packed, scratch, epoch, g, p, k, stream):
            return lib.host_launch(ins, nxt, out, packed, None, scratch, epoch,
                                   g, p, k, g, grid, int(runtime_width))
    else:
        def fn(ins, nxt, out, packed, gidx, scratch, epoch, g, p, k, s, stream):
            return lib.host_launch(ins, nxt, out, packed, gidx, scratch, epoch,
                                   g, p, k, s, grid, int(runtime_width))
    return fn


def _host_step(lib, state, packed, gidx, scratch, runtime_width, grid=3):
    """One step through the wrapper's host code and the kernel's code on
    CPU tensors: (state, egress)."""
    S.check(state, packed, gidx)
    fn = _launcher(lib, gidx is None, grid, runtime_width)
    return S.run(fn, state, packed, gidx, scratch, 0)


def _assert_same(got, want, where):
    (sa, ea), (sb, eb) = got, want
    bad = [f for r, f in enumerate(C.EGRESS_FIELDS) if not torch.equal(ea[r], eb[r])]
    assert not bad, f"{where}: egress rows differ: {bad}"
    bad = [f for f, a, b in zip(C.GroupState._fields, sa, sb) if not torch.equal(a, b)]
    assert not bad, f"{where}: state fields differ: {bad}"


@pytest.mark.parametrize("p,runtime_width", [
    (1, False), (2, False), (3, False), (5, False), (8, False),
    (1, True), (3, True), (8, True), (9, True), (16, True), (33, True),
])
def test_kernel_code_matches_the_plain_step(host_lib, p, runtime_width):
    """Two chained rounds of a full-width then an active-set step, at
    K in {8, 32}, near 2**31-1 or not: the kernel's code equals the plain
    step exactly. ``runtime_width`` runs the runtime-width instance (the
    only one for P > 8) also at widths that have a register instance."""
    g = 96
    for k in (8, 32):
        for near_max in (False, True):
            rng = np.random.default_rng(10 * p + k + near_max)
            st = C.state_from_numpy(
                cases.state_fields(rng, g, p, k, near_max=near_max), "cpu")
            scratch = S.Scratch(g, "cpu")
            for rnd in range(2):
                where = f"p={p} k={k} near_max={near_max} round {rnd}"
                full = torch.from_numpy(
                    cases.packed(rng, C.state_to_numpy(st), np.arange(g), g))
                want = C.consensus_step_packed_scat_plain(st, full)
                _assert_same(_host_step(host_lib, st, full, None, scratch,
                                        runtime_width), want, where + " full")
                st = want[0]
                gidx = cases.active_set(rng, g, 40, 64)
                sub = torch.from_numpy(
                    cases.packed(rng, C.state_to_numpy(st), gidx, 64))
                gidx = torch.from_numpy(gidx)
                want = C.consensus_step_packed_sub_scat_plain(st, sub, gidx)
                _assert_same(_host_step(host_lib, st, sub, gidx, scratch,
                                        runtime_width), want, where + " sub")
                st = want[0]


def _low_run(packed):
    """``packed`` with its first appended run (a real group's) moved to
    the bottom of the int32 range, where the kernel walks every ring slot
    (``lay_run``'s wrapping branch)."""
    packed[cases.R["a_lo"], 0] = -2**31
    packed[cases.R["a_hi"], 0] = -2**31 + 3
    return packed


def _offset_ring(st):
    """``st`` with its ring moved to a view 4 bytes past an aligned
    allocation: no tile of it is 16-byte aligned."""
    g, k = st.term_suffix.shape
    ring = torch.empty(g * k + 1, dtype=torch.int32)[1:].view(g, k)
    ring.copy_(st.term_suffix)
    return st._replace(term_suffix=ring)


@pytest.mark.parametrize("g,p,k,grid,runtime_width,wrap", [
    (96, 3, 32, 2, False, False),
    (96, 3, 32, 2, False, True),   # across the epoch wrap
    (77, 3, 7, 3, False, False),   # odd G and K: the plain staging path
    (77, 3, 8, 1, False, True),    # odd G, one block, across the wrap
    (77, 9, 7, 4, True, True),     # runtime width, odd G and K, the wrap
])
def test_chained_steps_reuse_one_scratch(host_lib, g, p, k, grid,
                                         runtime_width, wrap):
    """Six chained steps (full width and active set in turn, each fed the
    returned state) on one scratch that is never cleared between them:
    every step equals the plain step (one run of each step sits at the
    bottom of the int32 range). ``wrap`` starts the epochs two
    below 2**32, so the third launch wraps: the scratch is zeroed once
    and the count starts again at 1. The first input's ring is an offset
    view, so the first tiles take the plain (unaligned) staging path."""
    rng = np.random.default_rng(1000 * g + 10 * p + k + wrap)
    st = _offset_ring(C.state_from_numpy(cases.state_fields(rng, g, p, k), "cpu"))
    scratch = S.Scratch(g, "cpu")
    if wrap:
        scratch.epoch = 0xFFFFFFFF - 2
    epochs = []
    for i in range(6):
        host = C.state_to_numpy(st)
        if i % 2 == 0:
            args = (torch.from_numpy(
                _low_run(cases.packed(rng, host, np.arange(g), g))),)
            plain = C.consensus_step_packed_scat_plain
        else:
            gidx = cases.active_set(rng, g, 30, 64)
            args = (torch.from_numpy(_low_run(cases.packed(rng, host, gidx, 64))),
                    torch.from_numpy(gidx))
            plain = C.consensus_step_packed_sub_scat_plain
        want = plain(st, *args)
        got = _host_step(host_lib, st, args[0], args[1] if len(args) > 1 else None,
                         scratch, runtime_width, grid)
        _assert_same(got, want, f"step {i}")
        epochs.append(scratch.epoch)
        st = got[0]
    if wrap:
        assert epochs == [0xFFFFFFFE, 0xFFFFFFFF, 1, 2, 3, 4]
    else:
        assert epochs == [1, 2, 3, 4, 5, 6]


def test_outputs_share_one_buffer_at_the_kernels_offsets(host_lib):
    """``out_views`` cuts the fields where ``csrc/step.cu``'s
    ``out_offsets`` puts them, the ring first (aligned as the buffer)."""
    g, p, k, s = 77, 5, 7, 64
    buf = torch.empty(S.out_words(g, p, k, s), dtype=torch.int32)
    outs, egress = S.out_views(buf, g, p, k, s)
    off = (ctypes.c_longlong * 16)()
    host_lib.host_out_offsets(g, p, k, s, off)
    base = buf.data_ptr()
    assert [t.data_ptr() - base for t in outs + (egress,)] == list(off)
    assert off[S.OUT_FIELDS.index("term_suffix")] == 0
    end = max(o + t.numel() * t.element_size() for o, t in zip(off, outs + (egress,)))
    assert end <= buf.numel() * 4
    shapes = {"match_index": (g, p), "next_index": (g, p), "votes": (g, p),
              "pre_votes": (g, p), "term_suffix": (g, k)}
    for f, t in zip(S.OUT_FIELDS, outs):
        assert t.shape == shapes.get(f, (g,)) and t.is_contiguous(), f
    assert egress.shape == (17, s)
