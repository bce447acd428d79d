// HLL register scatter-max for Hopper (sm_90a).
//
// Replaces the TPU kernel deequ_tpu/sketches/pallas_scatter.py::_make_call
// (the Pallas SMEM kernel driven by _scatter_max_call and scatter_max).
// It computes, per column c of a (C, B) block,
//
//     reg[c, idx[c, i]] = max over i of rho[c, i]
//
// into a zero-initialised (C, M) int32 register file. idx is in [0, M),
// rho in [0, 64) (HLL ranks are <= 33); masked rows arrive as
// (idx, rho) = (0, 0), a no-op against the zeroed file. Max is
// commutative and associative, so the result is deterministic and
// bit-identical to the plain scatter_reduce("amax") beside the wrapper
// (deequ_tpu_torch/sketches/scatter_max.py).
//
// Bound on an H100 SXM: the kernel must read idx and rho once,
// C*B*8 bytes, and write the register file once, C*M*4 bytes, at
// 3.35 TB/s; its arithmetic is one compare per element, far below any
// compute roof, so it is bound by bytes. At the main path's shape
// (C=4, B=2^21, M=2^14) that is 67.4 MB, about 20 us.
//
// Design (simple and correct first):
// - grid (S, C): blockIdx.y picks the column, S blocks split its rows so
//   the card holds at least two blocks per SM (the wrapper picks S, and
//   gives no block fewer rows than it has registers to zero and fold);
// - each block keeps a private copy of its column's register file in
//   shared memory (M*4 = 64 KB, dynamic shared memory), zeroes it, and
//   walks its rows grid-strided so a warp's loads are coalesced;
// - an element updates its register with a shared-memory atomicMax, and
//   skips the atomic when rho is not above the value it reads first
//   (collisions on a hot register then cost a load, not an atomic);
// - the block then folds its non-zero registers into the global output
//   with global atomicMax; the wrapper zeroes the output beforehand.
// The bytes bound is met only if the rows stream at full rate; the fold
// costs S*M*4 extra bytes of atomics per column, which a later version
// can cut (fewer, larger blocks; warm-register gating as in the TPU
// probe tool's gmin variant; fusing the hash into this kernel).

#include <cuda_runtime.h>

namespace {

__global__ void hll_scatter_max_kernel(const int* __restrict__ idx,
                                       const int* __restrict__ rho,
                                       int* __restrict__ out,
                                       long long rows, int m) {
  extern __shared__ int regs[];
  const int c = blockIdx.y;
  for (int j = threadIdx.x; j < m; j += blockDim.x) regs[j] = 0;
  __syncthreads();

  const long long base = static_cast<long long>(c) * rows;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < rows; i += stride) {
    const int r = __ldg(rho + base + i);
    const int k = __ldg(idx + base + i);
    // the wrapper validated the ranges; the bounds test only keeps a
    // bad pointer from ever writing outside the shared register file
    if (r > 0 && static_cast<unsigned>(k) < static_cast<unsigned>(m) &&
        r > regs[k]) {
      atomicMax(&regs[k], r);
    }
  }
  __syncthreads();

  int* dst = out + static_cast<long long>(c) * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int v = regs[j];
    if (v > 0) atomicMax(dst + j, v);
  }
}

}  // namespace

extern "C" {

// Launch on `stream`: idx, rho are (cols, rows) int32, out is (cols, m)
// int32 and already zeroed. Returns the cudaError_t of the launch.
int hll_scatter_max_launch(const void* idx, const void* rho, void* out,
                           int cols, long long rows, int m, int splits,
                           int threads, void* stream) {
  const int smem = m * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      hll_scatter_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(splits, cols);
  hll_scatter_max_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int*>(rho),
      static_cast<int*>(out), rows, m);
  return static_cast<int>(cudaGetLastError());
}

const char* hll_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
