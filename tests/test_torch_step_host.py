"""The step kernel's code (``csrc/step.cu``) on the CPU, against the plain
torch-op step.

A CUDA kernel has no CPU mode, so this test compiles the kernel source up
to its host launchers with the host's C++ compiler behind a small shim
(``__global__``/``__device__`` empty, ``blockIdx``/``threadIdx`` globals,
a sequential ``atomicMax``) and with ``-fsanitize=undefined`` (a signed
overflow or an out-of-bounds shift aborts). A host loop runs the memset,
the scatter pre-pass, the scattered copy and the step thread by thread in
launch order, over CPU tensors; the result must equal the plain step in
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
struct ShimDim { unsigned x; };
static ShimDim blockIdx, threadIdx, blockDim;
using std::max;
using std::min;
inline int atomicMax(int32_t* a, int32_t v) { int32_t o = *a; if (v > o) *a = v; return o; }
inline unsigned atomicMax(uint32_t* a, uint32_t v) { uint32_t o = *a; if (v > o) *a = v; return o; }
"""

RUNNER = r"""
template <int P>
void host_step(const StateIn& in, const StateOut& out, const int32_t* packed,
               const int32_t* gidx, int s, const int32_t* row_of,
               const uint32_t* wmax, int g, int p, int k, int32_t* egress) {
  blockDim.x = kThreads;
  for (int j = 0; j < s; ++j) {
    blockIdx.x = j / kThreads;
    threadIdx.x = j % kThreads;
    step_kernel<P>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress);
  }
}

}  // namespace

// the launch sequence of launch_all, thread by thread; runtime_width
// forces the runtime-width instance at any p
extern "C" int host_launch_all(const void* const* in_ptrs,
                               void* const* out_ptrs, const void* packed_v,
                               const void* gidx_v, void* egress_v,
                               void* maps_v, int g, int p, int k, int s,
                               int runtime_width) {
  const StateIn in = state_in(in_ptrs);
  const StateOut out = state_out(out_ptrs);
  const int32_t* packed = static_cast<const int32_t*>(packed_v);
  const int32_t* gidx = static_cast<const int32_t*>(gidx_v);
  int32_t* egress = static_cast<int32_t*>(egress_v);
  int32_t* row_of = static_cast<int32_t*>(maps_v);
  uint32_t* wmax = reinterpret_cast<uint32_t*>(row_of + g);
  memset(maps_v, 0, sizeof(int32_t) * 2 * static_cast<size_t>(g));
  blockDim.x = kThreads;
  for (int j = 0; j < s; ++j) {
    blockIdx.x = j / kThreads;
    threadIdx.x = j % kThreads;
    scatter_index_kernel(packed, s, g, row_of, wmax);
  }
  blockDim.x = kApplyThreads;
  for (int64_t t = 0; t < static_cast<int64_t>(g) * k; ++t) {
    blockIdx.x = static_cast<unsigned>(t / kApplyThreads);
    threadIdx.x = static_cast<unsigned>(t % kApplyThreads);
    apply_scatters_kernel(in, out, packed, s, row_of, wmax, g, p, k,
                          gidx != nullptr);
  }
  const int w = runtime_width ? 0 : p;
  switch (w) {
    case 1: host_step<1>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 2: host_step<2>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 3: host_step<3>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 4: host_step<4>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 5: host_step<5>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 6: host_step<6>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 7: host_step<7>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    case 8: host_step<8>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
    default: host_step<0>(in, out, packed, gidx, s, row_of, wmax, g, p, k, egress); break;
  }
  return 0;
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
    (d / "step_host.cpp").write_text(src[:src.index(MARKER)] + RUNNER)
    lib = d / "step_host.so"
    proc = subprocess.run(
        [cxx, "-std=c++17", "-O1", "-fsanitize=undefined",
         "-fno-sanitize-recover=all", "-fPIC", "-shared", "-w",
         f"-I{d}", f"-I{kernels.CSRC}", "-o", str(lib),
         str(d / "step_host.cpp")],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).host_launch_all
    fn.restype = ctypes.c_int
    return fn


def _host_step(fn, state, packed, gidx, runtime_width):
    """The kernel's launch sequence on CPU tensors: (state, egress)."""
    g, p = state.match_index.shape
    k = state.term_suffix.shape[1]
    s = packed.shape[1]
    out = {f: torch.empty_like(getattr(state, f)) for f in S.OUT_FIELDS}
    egress = torch.empty((len(C.EGRESS_FIELDS), s), dtype=torch.int32)
    maps = torch.empty(2 * g, dtype=torch.int32)
    vp = ctypes.c_void_p
    ins = (vp * len(S.STATE_FIELDS))(*[t.data_ptr() for t in state])
    outs = (vp * len(S.OUT_FIELDS))(*[out[f].data_ptr() for f in S.OUT_FIELDS])
    rc = fn(ins, outs, vp(packed.data_ptr()),
            vp(gidx.data_ptr() if gidx is not None else 0),
            vp(egress.data_ptr()), vp(maps.data_ptr()), g, p, k, s,
            int(runtime_width))
    assert rc == 0
    return state._replace(**out), egress


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
            for rnd in range(2):
                where = f"p={p} k={k} near_max={near_max} round {rnd}"
                full = torch.from_numpy(
                    cases.packed(rng, C.state_to_numpy(st), np.arange(g), g))
                want = C.consensus_step_packed_scat_plain(st, full)
                _assert_same(_host_step(host_lib, st, full, None, runtime_width),
                             want, where + " full")
                st = want[0]
                gidx = cases.active_set(rng, g, 40, 64)
                sub = torch.from_numpy(
                    cases.packed(rng, C.state_to_numpy(st), gidx, 64))
                gidx = torch.from_numpy(gidx)
                want = C.consensus_step_packed_sub_scat_plain(st, sub, gidx)
                _assert_same(_host_step(host_lib, st, sub, gidx, runtime_width),
                             want, where + " sub")
                st = want[0]
