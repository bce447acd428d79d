// The scatter probe's HLL register scatter-max variants, for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of the TPU probe tool
// tools/scatter_probe.py:
//
//   P1  make_pallas_two_stream  -> probe_two_stream_kernel<SKIP>
//   P2  make_pallas_packed      -> probe_packed_kernel<SKIP>
//   P3  make_pallas_gmin        -> probe_gmin_kernel
//
// All three compute one column's register file
//
//     reg[k] = max over i with idx[i] == k of rho[i]
//
// for idx in [0, M) and rho in [0, 64) (HLL ranks are <= 33). P1 reads
// idx and rho as two int32 streams; P2 and P3 read one stream of packed
// words w = idx << 6 | rho and unpack with >> 6 and & 63. P1 and P2 fold
// into a zeroed output; P3 folds into a copy of warm registers regs_in,
// so its output is max(regs_in, scatter). Max is commutative and
// associative, so every variant is deterministic and bit-identical to
// the plain scatter_reduce("amax") beside its wrapper
// (deequ_tpu_torch/tools/probe_kernels.py).
//
// What carries over from the TPU, and what does not. The Pallas kernels
// walk SMEM chunks on the TPU's scalar unit (CHUNK, the unroll loop, the
// gmin refresh every 16 chunks); none of that structure exists here.
// What each variant computes, and the gate it applies, is kept:
// - SKIP (P1, P2): an element reads its register first and does the
//   shared-memory atomicMax only when rho is above it; without SKIP
//   every element does the atomicMax.
// - P2's unroll becomes 16-byte int4 loads of four packed words, where
//   the wrapper found the stream 16-byte aligned.
// - P3's gmin is the minimum of regs_in, computed once per block at its
//   start. Registers only grow, so a gmin taken before any update is a
//   lower bound of every later register: an element with rho <= gmin
//   can never raise one, and skips both the load and the atomic.
//
// Bound on an H100 SXM: each kernel must read its input stream once and
// write the register file once; the arithmetic is a compare or two per
// element, far below any compute roof, so it is bound by bytes. At the
// probe's shape (B = 2^21, M = 2^14): P1 reads 16.78 MB and writes
// 64 KB, ~5.0 us at 3.35 TB/s; P2 reads 8.39 MB, ~2.5 us; P3 reads
// 8.39 MB plus 64 KB of regs_in, ~2.5 us. A kernel launch alone costs a
// few microseconds, so at this shape none can reach its bound.
//
// Design (simple and correct first), shared by the three kernels:
// - a 1-D grid of S blocks over the rows (the wrapper picks S as it
//   does for K1: at least MAX_REGISTERS rows a block, so B = 2^21 gives
//   128 blocks, one per SM on 128 of the 132 SMs);
// - each block keeps a private register file in dynamic shared memory
//   (M * 4 = 64 KB), walks its rows grid-strided so a warp's loads are
//   coalesced, and updates with shared-memory atomicMax;
// - the block then folds its registers into the global output with
//   global atomicMax, skipping registers that cannot raise it.

#include <cuda_runtime.h>
#include <climits>

namespace {

__device__ __forceinline__ void update_skip(int* regs, int k, int r, int m) {
  // the wrapper validated the ranges; the bounds test only keeps a bad
  // pointer from ever writing outside the shared register file
  if (static_cast<unsigned>(k) < static_cast<unsigned>(m) && r > regs[k]) {
    atomicMax(&regs[k], r);
  }
}

__device__ __forceinline__ void update_always(int* regs, int k, int r,
                                              int m) {
  if (static_cast<unsigned>(k) < static_cast<unsigned>(m)) {
    atomicMax(&regs[k], r);
  }
}

template <bool SKIP>
__device__ __forceinline__ void update(int* regs, int k, int r, int m) {
  if (SKIP) {
    update_skip(regs, k, r, m);
  } else {
    update_always(regs, k, r, m);
  }
}

__device__ __forceinline__ void zero_registers(int* regs, int m) {
  for (int j = threadIdx.x; j < m; j += blockDim.x) regs[j] = 0;
  __syncthreads();
}

// fold the block's registers into out; a register at or below `floor`
// (0 for a zeroed output, regs_in[j] for P3) cannot raise it
__device__ __forceinline__ void fold(const int* regs, int* out,
                                     const int* floor, int m) {
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int v = regs[j];
    const int f = floor == nullptr ? 0 : __ldg(floor + j);
    if (v > f) atomicMax(out + j, v);
  }
}

template <bool SKIP>
__global__ void probe_two_stream_kernel(const int* __restrict__ idx,
                                        const int* __restrict__ rho,
                                        int* __restrict__ out,
                                        long long rows, int m) {
  extern __shared__ int regs[];
  zero_registers(regs, m);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows; i += stride) {
    update<SKIP>(regs, __ldg(idx + i), __ldg(rho + i), m);
  }
  fold(regs, out, nullptr, m);
}

// The packed stream, walked grid-strided: `vec` words as int4 where the
// wrapper found the base 16-byte aligned, the rest one word at a time.
// `gate` drops elements whose rank cannot raise any register (P3's
// gmin; 0 elsewhere, so only rank-0 words are dropped, which are no-ops
// against a zeroed file).
template <bool SKIP>
__device__ __forceinline__ void scan_packed(int* regs,
                                            const int* __restrict__ packed,
                                            long long rows, int m, int vec,
                                            int gate) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long head = 0;
  if (vec) {
    const int4* packed4 = reinterpret_cast<const int4*>(packed);
    const long long n4 = rows >> 2;
    for (long long i = tid; i < n4; i += stride) {
      const int4 w = __ldg(packed4 + i);
      const int ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ws[u] & 63;
        if (r > gate) {
          update<SKIP>(regs, static_cast<int>(
                                 static_cast<unsigned>(ws[u]) >> 6),
                       r, m);
        }
      }
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < rows; i += stride) {
    const int w = __ldg(packed + i);
    const int r = w & 63;
    if (r > gate) {
      update<SKIP>(regs, static_cast<int>(static_cast<unsigned>(w) >> 6), r,
                   m);
    }
  }
}

template <bool SKIP>
__global__ void probe_packed_kernel(const int* __restrict__ packed,
                                    int* __restrict__ out, long long rows,
                                    int m, int vec) {
  extern __shared__ int regs[];
  zero_registers(regs, m);
  scan_packed<SKIP>(regs, packed, rows, m, vec, 0);
  fold(regs, out, nullptr, m);
}

__global__ void probe_gmin_kernel(const int* __restrict__ regs_in,
                                  const int* __restrict__ packed,
                                  int* __restrict__ out, long long rows,
                                  int m, int vec) {
  extern __shared__ int regs[];
  __shared__ int gmin;
  if (threadIdx.x == 0) gmin = INT_MAX;
  __syncthreads();
  int local = INT_MAX;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int v = __ldg(regs_in + j);
    regs[j] = v;
    local = min(local, v);
  }
  atomicMin(&gmin, local);
  __syncthreads();
  scan_packed<true>(regs, packed, rows, m, vec, gmin);
  fold(regs, out, regs_in, m);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int smem) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

extern "C" {

// P1. idx, rho: (rows,) int32; out: (m,) int32, already zeroed.
// Returns the cudaError_t of the launch.
int probe_two_stream_launch(const void* idx, const void* rho, void* out,
                            long long rows, int m, int skip, int splits,
                            int threads, void* stream) {
  const int smem = m * static_cast<int>(sizeof(int));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (skip) {
    err = allow_smem(probe_two_stream_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_two_stream_kernel<true><<<splits, threads, smem, s>>>(
        static_cast<const int*>(idx), static_cast<const int*>(rho),
        static_cast<int*>(out), rows, m);
  } else {
    err = allow_smem(probe_two_stream_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_two_stream_kernel<false><<<splits, threads, smem, s>>>(
        static_cast<const int*>(idx), static_cast<const int*>(rho),
        static_cast<int*>(out), rows, m);
  }
  return static_cast<int>(cudaGetLastError());
}

// P2. packed: (rows,) int32 words idx << 6 | rho; out: (m,) int32,
// already zeroed; vec != 0 only if packed is 16-byte aligned.
int probe_packed_launch(const void* packed, void* out, long long rows, int m,
                        int skip, int vec, int splits, int threads,
                        void* stream) {
  const int smem = m * static_cast<int>(sizeof(int));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (skip) {
    err = allow_smem(probe_packed_kernel<true>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_packed_kernel<true><<<splits, threads, smem, s>>>(
        static_cast<const int*>(packed), static_cast<int*>(out), rows, m,
        vec);
  } else {
    err = allow_smem(probe_packed_kernel<false>, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    probe_packed_kernel<false><<<splits, threads, smem, s>>>(
        static_cast<const int*>(packed), static_cast<int*>(out), rows, m,
        vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// P3. regs_in: (m,) int32 warm registers; packed as for P2; out: (m,)
// int32 holding a copy of regs_in.
int probe_gmin_launch(const void* regs_in, const void* packed, void* out,
                      long long rows, int m, int vec, int splits,
                      int threads, void* stream) {
  const int smem = m * static_cast<int>(sizeof(int));
  cudaError_t err = allow_smem(probe_gmin_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  probe_gmin_kernel<<<splits, threads, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(regs_in), static_cast<const int*>(packed),
      static_cast<int*>(out), rows, m, vec);
  return static_cast<int>(cudaGetLastError());
}

const char* probe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
