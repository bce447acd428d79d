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
//     out[k] = max(regs[k], max over i with idx[i] == k of rho[i])
//
// for idx in [0, m), m <= 16384, and rho in [0, 64) (HLL ranks are
// <= 33). P1 reads idx and rho as two int32 streams; P2 and P3 read one
// stream of packed words w = idx << 6 | rho and unpack with >> 6 and
// & 63. Max is commutative and associative, so every variant is
// deterministic and bit-identical to the plain scatter_reduce("amax")
// beside its wrapper (deequ_tpu_torch/tools/probe_kernels.py).
//
// What carries over from the TPU, and what does not. The Pallas kernels
// walk SMEM chunks on the TPU's scalar unit (CHUNK, the unroll loop, the
// gmin refresh every 16 chunks); none of that structure exists here.
// What each variant computes, and the gate it applies, is kept:
// - SKIP (P1, P2): a row reads its register first and does the
//   atomicMax only when rho is above it; without SKIP every row does
//   the atomicMax. P2 drops rank-0 words, which are no-ops.
// - P2's unrolled loop becomes int4 loads where the words are 16-byte
//   aligned (vec), and a plain loop where they are not.
// - P3's gmin is the minimum of regs_in, computed once per block at its
//   start. Registers only grow, so a gmin taken before any update is a
//   lower bound of every later register: an element with rho <= gmin
//   can never raise one, and skips both the load and the atomic.
//
// Bound on an H100 SXM: each kernel must read its input stream and
// regs once and write the register file once; the arithmetic is a
// compare or two per row, far below any compute roof, so it is bound by
// bytes. At the probe's shape (B = 2^21, M = 2^14): P1 reads 16.78 MB,
// ~5.0 us at 3.35 TB/s; P2 and P3 read 8.39 MB, ~2.5 us.
// On the card (PERF.md) P1 and P2 are bound by neither: each row costs
// a random 4-byte read and often an atomic in another SM's shared
// memory, and those remote requests, not the stream, set their time,
// several times the bytes bound.
//
// P1 and P2 (probe_cluster_scatter below): one register file per
// thread-block cluster, one launch.
// - A 1-D grid of whole clusters of kCluster = 16 blocks (the
//   non-portable size). Block `rank` of a cluster owns the registers
//   [rank << span_log2, (rank + 1) << span_log2) of the cluster's file,
//   in its shared memory. The file starts at zero, so SKIP gates
//   against what the cluster itself has seen (P2's cold gate on the
//   TPU); regs enters only at the merge.
// - Block b of the grid reads rows [b * share, (b + 1) * share) (the
//   wrapper's planner picks share, a multiple of 4, so each share starts
//   16-byte aligned). Where vec is set, every thread reads int4s of
//   each stream, the last ragged words (fewer than 4) one at a time;
//   where it is not, every row one at a time. (TMA bulk copies into a
//   ring of stages were measured 6% slower than plain loads: the
//   scatter, not the stream, sets the time; PERF.md.)
// - A row goes to its owner, block k >> span_log2 of the cluster,
//   through distributed shared memory (map_shared_rank): the skip test
//   reads the owner's register and the atomicMax happens there. Four
//   rows' owner registers are read before any of their atomics, so the
//   remote reads are in flight together.
// - Two cluster-wide barriers: after the zeroing (before any remote
//   access), and after the last remote access (before a block reads its
//   slice for the merge, or exits while a peer may still write into its
//   shared memory).
// - The merge into max(regs, .) happens in the same launch: out holds a
//   copy of regs, and each block folds the registers of its slice that
//   are above regs[k] with a global atomicMax.
// - The launcher sets each kernel's function attributes once per device
//   and launches with cudaLaunchKernelEx and a cluster dimension.
//
// P3 (probe_gmin_kernel) keeps the design of its first port:
// - a 1-D grid of S blocks over the rows (the wrapper picks S as it
//   does for K1: at least MAX_REGISTERS rows a block, so B = 2^21 gives
//   128 blocks, one per SM on 128 of the 132 SMs);
// - each block keeps a private register file in dynamic shared memory
//   (M * 4 = 64 KB), walks its rows grid-strided so a warp's loads are
//   coalesced, and updates with shared-memory atomicMax;
// - the block then folds its registers into the global output with
//   global atomicMax, skipping registers that cannot raise it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

// -- P1 and P2: the cluster kernels -----------------------------------------

// The wrapper's planner (probe_kernels.py: CLUSTER, BLOCK_SMEM) holds
// copies of these two; a CPU test holds the copies equal.
constexpr int kCluster = 16;
// A block's slice of the file takes at most 64 KB / kCluster = 4 KB,
// but a block asks for more than half an SM's 228 KB of shared memory,
// so that each SM holds one block: where two fit, the cluster scheduler
// put two blocks of one cluster on an SM and left others idle, 1.7x
// slower (PERF.md).
constexpr int kBlockSmem = 120 * 1024;
constexpr int kThreads = 512;
constexpr int kMaxDevices = 64;
constexpr int kMaxRegisters = 16384;

// A row's (register, rank); false for a row that does nothing: a rank-0
// packed word, a no-op on a zeroed file.
template <bool TWO>
__device__ __forceinline__ bool unpack(int a, int b, int& k, int& r) {
  if (TWO) {
    k = a;
    r = b;
    return true;
  }
  r = a & 63;
  k = static_cast<int>(static_cast<unsigned>(a) >> 6);
  return r != 0;
}

// The row's owner register in the cluster's file, or null for a row
// that does nothing or whose idx lies outside [0, m). The wrapper
// validated the ranges; the bounds test only keeps a bad word from ever
// writing outside the file.
template <bool TWO>
__device__ __forceinline__ int* owner(int* const* peer, int a, int b, int m,
                                      int span_log2, int& r) {
  int k;
  if (!unpack<TWO>(a, b, k, r)) return nullptr;
  if (static_cast<unsigned>(k) >= static_cast<unsigned>(m)) return nullptr;
  return peer[k >> span_log2] + (k & ((1 << span_log2) - 1));
}

template <bool TWO, bool SKIP>
__device__ __forceinline__ void push1(int* const* peer, int a, int b, int m,
                                      int span_log2) {
  int r;
  int* p = owner<TWO>(peer, a, b, m, span_log2, r);
  if (p != nullptr && (!SKIP || r > *p)) atomicMax(p, r);
}

// four rows: every owner register is read before any atomic, so the
// four remote reads are in flight together
template <bool TWO, bool SKIP>
__device__ __forceinline__ void push4(int* const* peer, int4 a, int4 b, int m,
                                      int span_log2) {
  const int as[4] = {a.x, a.y, a.z, a.w};
  const int bs[4] = {b.x, b.y, b.z, b.w};
  int* p[4];
  int r[4];
  int cur[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) p[u] = owner<TWO>(peer, as[u], bs[u], m, span_log2, r[u]);
#pragma unroll
  for (int u = 0; u < 4; ++u) cur[u] = (SKIP && p[u] != nullptr) ? *p[u] : -1;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (p[u] != nullptr && r[u] > cur[u]) atomicMax(p[u], r[u]);
  }
}

// The body of P1 (TWO: a = idx, b = rho) and P2 (a = packed words, b
// unused); see the note at the top of the file.
template <bool TWO, bool SKIP>
__device__ __forceinline__ void probe_cluster_scatter(
    const int* __restrict__ a, const int* __restrict__ b,
    const int* __restrict__ regs, int* __restrict__ out, long long rows,
    int m, long long share, int span_log2, int vec) {
  extern __shared__ __align__(16) int file[];
  __shared__ int* peer[kCluster];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int lo = min(rank << span_log2, m);
  const int owned = min((rank + 1) << span_log2, m) - lo;

  for (int j = threadIdx.x; j < owned; j += blockDim.x) file[j] = 0;
  if (threadIdx.x < kCluster) peer[threadIdx.x] = cluster.map_shared_rank(file, threadIdx.x);
  cluster.sync();  // every slice zeroed before any remote access

  const long long begin = min(static_cast<long long>(blockIdx.x) * share, rows);
  const long long end = min(begin + share, rows);
  const long long vec_end = vec ? begin + ((end - begin) & ~3LL) : begin;
  for (long long i = begin + 4LL * threadIdx.x; i < vec_end; i += 4LL * blockDim.x) {
    const int4 wa = __ldg(reinterpret_cast<const int4*>(a + i));
    const int4 wb = TWO ? __ldg(reinterpret_cast<const int4*>(b + i)) : wa;
    push4<TWO, SKIP>(peer, wa, wb, m, span_log2);
  }
  for (long long i = vec_end + threadIdx.x; i < end; i += blockDim.x) {
    push1<TWO, SKIP>(peer, __ldg(a + i), TWO ? __ldg(b + i) : 0, m, span_log2);
  }
  cluster.sync();  // every remote access done before a slice is read

  for (int j = threadIdx.x; j < owned; j += blockDim.x) {
    const int v = file[j];
    if (v > __ldg(regs + lo + j)) atomicMax(out + lo + j, v);
  }
}

template <bool SKIP>
__global__ void __launch_bounds__(kThreads)
    probe_two_stream_kernel(const int* __restrict__ idx,
                            const int* __restrict__ rho,
                            const int* __restrict__ regs, int* __restrict__ out,
                            long long rows, int m, long long share,
                            int span_log2, int vec) {
  probe_cluster_scatter<true, SKIP>(idx, rho, regs, out, rows, m, share,
                                    span_log2, vec);
}

template <bool SKIP>
__global__ void __launch_bounds__(kThreads)
    probe_packed_kernel(const int* __restrict__ packed,
                        const int* __restrict__ regs, int* __restrict__ out,
                        long long rows, int m, long long share, int span_log2,
                        int vec) {
  probe_cluster_scatter<false, SKIP>(packed, nullptr, regs, out, rows, m,
                                     share, span_log2, vec);
}

// the kernel's address, for its attributes and the occupancy query
template <bool TWO, bool SKIP>
const void* cluster_kernel() {
  if (TWO) return reinterpret_cast<const void*>(probe_two_stream_kernel<SKIP>);
  return reinterpret_cast<const void*>(probe_packed_kernel<SKIP>);
}

// the function attributes of one kernel, set once per device: room for
// kBlockSmem, and clusters of kCluster blocks
template <bool TWO, bool SKIP>
cudaError_t configure_once() {
  static bool configured[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  const void* kernel = cluster_kernel<TWO, SKIP>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kBlockSmem);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr,
                    int clusters, cudaStream_t stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kCluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.gridDim = dim3(clusters * kCluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kBlockSmem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

template <bool TWO, bool SKIP>
cudaError_t launch_cluster(const int* a, const int* b, const int* regs,
                           int* out, long long rows, int m, int vec,
                           int clusters, long long share, int span_log2,
                           cudaStream_t stream) {
  if (m < 1 || m > kMaxRegisters || clusters < 1 || share < 4 ||
      share % 4 != 0 || span_log2 < 0 || span_log2 > 14 ||
      ((m - 1) >> span_log2) >= kCluster ||
      (4LL << span_log2) > kBlockSmem) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = configure_once<TWO, SKIP>();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, clusters, stream);
  if (TWO) {
    err = cudaLaunchKernelEx(&cfg, probe_two_stream_kernel<SKIP>, a, b, regs,
                             out, rows, m, share, span_log2, vec);
  } else {
    err = cudaLaunchKernelEx(&cfg, probe_packed_kernel<SKIP>, a, regs, out,
                             rows, m, share, span_log2, vec);
  }
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool TWO, bool SKIP>
int max_active_clusters() {
  cudaError_t err = configure_once<TWO, SKIP>();
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cluster_config(cfg, attr, 1, nullptr);
  int n = 0;
  err = cudaOccupancyMaxActiveClusters(&n, cluster_kernel<TWO, SKIP>(), &cfg);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

using Query = int (*)();
using Launch = cudaError_t (*)(const int*, const int*, const int*, int*,
                               long long, int, int, int, long long, int,
                               cudaStream_t);

// -- P3: the gmin kernel, as first ported ------------------------------------

__device__ __forceinline__ void update_skip(int* regs, int k, int r, int m) {
  // the wrapper validated the ranges; the bounds test only keeps a bad
  // pointer from ever writing outside the shared register file
  if (static_cast<unsigned>(k) < static_cast<unsigned>(m) && r > regs[k]) {
    atomicMax(&regs[k], r);
  }
}

// fold the block's registers into out; a register at or below
// regs_in[j] cannot raise it
__device__ __forceinline__ void fold(const int* regs, int* out,
                                     const int* floor, int m) {
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += blockDim.x) {
    const int v = regs[j];
    const int f = __ldg(floor + j);
    if (v > f) atomicMax(out + j, v);
  }
}

// The packed stream, walked grid-strided: `vec` words as int4 where the
// wrapper found the base 16-byte aligned, the rest one word at a time.
// `gate` drops elements whose rank cannot raise any register (gmin).
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
          update_skip(regs, static_cast<int>(static_cast<unsigned>(ws[u]) >> 6),
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
      update_skip(regs, static_cast<int>(static_cast<unsigned>(w) >> 6), r, m);
    }
  }
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
  scan_packed(regs, packed, rows, m, vec, gmin);
  fold(regs, out, regs_in, m);
}

}  // namespace

extern "C" {

// P1. idx, rho: (rows,) int32; regs: (m,) int32; out: (m,) int32, a
// copy of regs. vec != 0 only if idx and rho are 16-byte aligned. The
// plan (clusters, share, span_log2) comes from the wrapper's planner.
// Returns the cudaError_t of the launch.
int probe_two_stream_launch(const void* idx, const void* rho,
                            const void* regs, void* out, long long rows,
                            int m, int skip, int vec, int clusters,
                            long long share, int span_log2, void* stream) {
  Launch launch = skip ? launch_cluster<true, true> : launch_cluster<true, false>;
  return static_cast<int>(launch(
      static_cast<const int*>(idx), static_cast<const int*>(rho),
      static_cast<const int*>(regs), static_cast<int*>(out), rows, m, vec,
      clusters, share, span_log2, static_cast<cudaStream_t>(stream)));
}

// P2. packed: (rows,) int32 words idx << 6 | rho; the rest as for P1;
// vec != 0 only if packed is 16-byte aligned.
int probe_packed_launch(const void* packed, const void* regs, void* out,
                        long long rows, int m, int skip, int vec,
                        int clusters, long long share, int span_log2,
                        void* stream) {
  Launch launch = skip ? launch_cluster<false, true> : launch_cluster<false, false>;
  return static_cast<int>(launch(
      static_cast<const int*>(packed), nullptr, static_cast<const int*>(regs),
      static_cast<int*>(out), rows, m, vec, clusters, share, span_log2,
      static_cast<cudaStream_t>(stream)));
}

// How many clusters of P1 (if two) or P2 the current device holds at
// once; a negative value is a cudaError_t.
int probe_max_active_clusters(int two, int skip) {
  Query query = two ? (skip ? max_active_clusters<true, true> : max_active_clusters<true, false>)
                    : (skip ? max_active_clusters<false, true> : max_active_clusters<false, false>);
  return query();
}

// P3. regs_in: (m,) int32 warm registers; packed as for P2; out: (m,)
// int32 holding a copy of regs_in.
int probe_gmin_launch(const void* regs_in, const void* packed, void* out,
                      long long rows, int m, int vec, int splits,
                      int threads, void* stream) {
  const int smem = m * static_cast<int>(sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      probe_gmin_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
