// Quorum scan: the agreed commit index of every raft group.
//
// Replaces the Pallas TPU kernel ra_tpu/ops/pallas_quorum.py::_quorum_kernel
// (reached through agreed_commit_pallas). For each group it returns the
// (nvoters/2)-th largest entry of the voter-masked match vector: non-voters
// count as -1, and the entry at ascending position
// clamp(P - 1 - floor(nvoters / 2), 0, P - 1) of the sorted row is picked.
// This is exactly ra_tpu_torch.ops.quorum.agreed_commit_plain.
//
// What bounds it on an H100 SXM. The kernel reads G*P int32 matches, G*P
// bool bytes and G int32 voter counts and writes G int32 results: G*(5P+8)
// bytes, a few dozen integer operations a group.
// - At the main path's shape, G = 10240, P = 3 (235,520 bytes), the byte
//   bound is 0.07 us, far below the time of any launch: the card's
//   empty-launch floor (an empty kernel at this grid) bounds it, plus one
//   chain of dependent latencies a thread (its loads, the pick, its
//   store); the host's part of a call (the wrapper, ops/quorum.py)
//   dwarfs both.
// - At a shape whose bytes exceed the 50 MB L2 (G = 4,194,304, P = 3:
//   96.5 MB, 28.8 us at 3.35 TB/s) the bytes bound it.
//
// Design, against each (scripts/quorum_sweep.py times the choices;
// PERF.md section 6 has the numbers):
// - One thread a group, every load independent: the thread issues its P
//   match words, its P voting bytes and its voter count at once and
//   applies the voting mask when they have arrived, so its chain is one
//   load latency, the pick and one store (a match load guarded by its
//   voting byte would wait for that byte first). Where the bases are
//   16-byte aligned a row of P int32 goes in 16-byte loads when 4 | P and
//   8-byte loads when 2 | P, its voting bytes in one 8- or 4-byte load
//   when 8 | P or 4 | P; P = 3, 5, 7 take word and byte loads, which L1
//   coalesces across a warp's neighbouring rows.
// - Blocks of kThreads = 128, 80 blocks at G = 10240: against 32, 64 and
//   256 threads, and against 2 or 4 consecutive groups a thread with wider
//   loads, it was the fastest or within noise at G = 10240 with P = 3, 5,
//   7 and at the scaling shape.
// - No shared memory. Blocks that staged their tile of rows in shared
//   memory with 16-byte loads and then read each row from there measured
//   slower at every shape: the store, barrier and reload lengthen a chain
//   that is latency-bound at the main path, and at the scaling shape L1
//   already coalesces the narrow row loads. For the same reasons neither
//   a 1-D bulk copy nor a TMA tensor map (rows of 4 to 32 bytes are too
//   narrow for a 2-D box to pay) was taken.
// - A pick in registers (quorum_net.cuh): the rank form, no sort and no
//   per-thread array; ptxas reports no stack and no spills, and the SASS
//   has no STL/LDL (chip_smoke.py checks it at every build).
// - The host part: one C entry with fixed ctypes argument types, the
//   stream's raw handle, and a check that costs one tuple comparison for
//   inputs of the shapes and devices seen last (ops/quorum.py).
//
// Exported (plain C, loaded with ctypes):
// - ra_quorum_launch: the scan at kThreads a block;
// - ra_quorum_launch_tiled: the same at a given block size (the sweep's
//   entry);
// - ra_quorum_empty_launch: an empty kernel at the scan's grid for G (the
//   card's launch floor beside the kernel's card time).

#include <cuda_runtime.h>
#include <stdint.h>

#include "quorum_net.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxThreads = 256;

// the arguments the kernel takes: G >= 1, P in 1..8, a block of 32..256
// threads in whole warps
bool valid(int g, int p, int threads) {
  return g > 0 && p >= 1 && p <= 8 && threads >= 32 &&
         threads <= kMaxThreads && threads % 32 == 0;
}

// blocks of the grid for G groups at `threads` a block
int grid_of(int g, int threads) {
  return static_cast<int>((static_cast<int64_t>(g) + threads - 1) / threads);
}

// Group i: its row into registers, every load issued before any is used,
// the voting mask applied, the pick stored. `aligned`: all four bases are
// 16-byte aligned, so the row's P int32 are 16-byte aligned when 4 | P
// and 8-byte aligned when 2 | P, and its P voting bytes 8-byte aligned
// when 8 | P and 4-byte aligned when 4 | P.
template <int P>
__device__ __forceinline__ void pick_group(const int32_t* match,
                                           const uint8_t* voting,
                                           const int32_t* nvoters,
                                           int32_t* out, int64_t i,
                                           bool aligned) {
  const int32_t* row = match + i * P;
  const uint8_t* vrow = voting + i * P;
  int32_t m[P];
  uint32_t vote[P];
  if (P % 2 == 0 && aligned) {
    if constexpr (P % 4 == 0) {
#pragma unroll
      for (int q = 0; q < P / 4; ++q) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(row) + q);
        m[4 * q] = v.x;
        m[4 * q + 1] = v.y;
        m[4 * q + 2] = v.z;
        m[4 * q + 3] = v.w;
      }
      uint32_t w[P / 4];
      if constexpr (P == 8) {
        const uint2 v = __ldg(reinterpret_cast<const uint2*>(vrow));
        w[0] = v.x;
        w[1] = v.y;
      } else {
        w[0] = __ldg(reinterpret_cast<const uint32_t*>(vrow));
      }
#pragma unroll
      for (int s = 0; s < P; ++s) vote[s] = (w[s / 4] >> (8 * (s % 4))) & 0xFF;
    } else {
#pragma unroll
      for (int q = 0; q < P / 2; ++q) {
        const int2 v = __ldg(reinterpret_cast<const int2*>(row) + q);
        m[2 * q] = v.x;
        m[2 * q + 1] = v.y;
      }
#pragma unroll
      for (int s = 0; s < P; ++s) vote[s] = __ldg(vrow + s);
    }
  } else {
#pragma unroll
    for (int s = 0; s < P; ++s) {
      m[s] = __ldg(row + s);
      vote[s] = __ldg(vrow + s);
    }
  }
  const int32_t nv = __ldg(nvoters + i);
#pragma unroll
  for (int s = 0; s < P; ++s) m[s] = vote[s] ? m[s] : -1;
  out[i] = quorum_pick<P>(m, nv);
}

template <int P>
__global__ void __launch_bounds__(kMaxThreads)
    quorum_kernel(const int32_t* __restrict__ match,
                  const uint8_t* __restrict__ voting,
                  const int32_t* __restrict__ nvoters,
                  int32_t* __restrict__ out, int g, int aligned) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < g) pick_group<P>(match, voting, nvoters, out, i, aligned != 0);
}

// ---- host launchers (nvcc only)

__global__ void empty_kernel() {}

template <int P>
void launch(const void* match, const void* voting, const void* nvoters,
            void* out, int g, int threads, cudaStream_t stream) {
  const int aligned =
      ((reinterpret_cast<uintptr_t>(match) | reinterpret_cast<uintptr_t>(voting) |
        reinterpret_cast<uintptr_t>(nvoters) | reinterpret_cast<uintptr_t>(out)) &
       15) == 0;
  quorum_kernel<P><<<grid_of(g, threads), threads, 0, stream>>>(
      static_cast<const int32_t*>(match), static_cast<const uint8_t*>(voting),
      static_cast<const int32_t*>(nvoters), static_cast<int32_t*>(out), g,
      aligned);
}

}  // namespace

// Launch on `stream` at `threads` a block; no synchronisation, no
// allocation. Returns cudaGetLastError() after the launch (0 on success),
// or cudaErrorInvalidValue, before any launch, for arguments the kernel
// does not take (G = 0 among them: chip_smoke.py times the host part of a
// call through that return).
extern "C" int ra_quorum_launch_tiled(const void* match, const void* voting,
                                      const void* nvoters, void* out, int g,
                                      int p, int threads, void* stream) {
  if (!valid(g, p, threads)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: launch<1>(match, voting, nvoters, out, g, threads, s); break;
    case 2: launch<2>(match, voting, nvoters, out, g, threads, s); break;
    case 3: launch<3>(match, voting, nvoters, out, g, threads, s); break;
    case 4: launch<4>(match, voting, nvoters, out, g, threads, s); break;
    case 5: launch<5>(match, voting, nvoters, out, g, threads, s); break;
    case 6: launch<6>(match, voting, nvoters, out, g, threads, s); break;
    case 7: launch<7>(match, voting, nvoters, out, g, threads, s); break;
    default: launch<8>(match, voting, nvoters, out, g, threads, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// The scan at kThreads a block.
extern "C" int ra_quorum_launch(const void* match, const void* voting,
                                const void* nvoters, void* out, int g, int p,
                                void* stream) {
  return ra_quorum_launch_tiled(match, voting, nvoters, out, g, p, kThreads,
                                stream);
}

// An empty kernel at the grid and block of ra_quorum_launch at G.
extern "C" int ra_quorum_empty_launch(int g, void* stream) {
  if (g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  empty_kernel<<<grid_of(g, kThreads), kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
