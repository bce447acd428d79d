// HLL register scatter-max for Hopper (sm_90a): three entry points.
//
// All replace the TPU kernel deequ_tpu/sketches/pallas_scatter.py::_make_call
// (the Pallas SMEM kernel driven by _scatter_max_call and scatter_max).
//
// 1. hll_scatter_max_launch takes precomputed (idx, rho): the direct
//    counterpart of the Pallas kernel (scatter_max, scatter_max_derived).
// 2. hll_update_launch takes the raw numeric values and fuses the whole
//    register update; see the note above hll_update_kernel below.
// 3. hll_update_codes_launch takes dictionary codes and the dictionary's
//    hash words and fuses the presence (or gather) path of string
//    columns; see the note above hll_codes_bitmap_kernel below.
//
// A launcher whose kernel asks for more than the default 48 KB of dynamic
// shared memory raises that kernel's limit once per device
// (set_smem_once), not on every launch.
//
// The (idx, rho) entry computes, per column c of a (C, B) block,
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
//   with global atomicMax; the launcher zeroes the output beforehand,
//   on the stream.
// The bytes bound is met only if the rows stream at full rate; the fold
// costs S*M*4 extra bytes of atomics per column, which a later version
// can cut (fewer, larger blocks; warm-register gating as in the TPU
// probe tool's gmin variant; fusing the hash into this kernel).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int kMaxDevices = 64;
constexpr int kMaxFileBytes = 16384 * static_cast<int>(sizeof(int));

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// device, once: `configured` is the caller's per-kernel flag array.
cudaError_t set_smem_once(const void* kernel, int bytes, bool* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) configured[dev] = true;
  return err;
}

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


// ---------------------------------------------------------------------------
// The fused entry: raw numeric values -> the carried HLL registers.
//
// Per column c of a (C, B) block of int64, int32, float64 or float32
// values, and for every row i with mask[c, i] (and row_mask[i], when
// given), it computes the function of deequ_tpu/sketches/hll.py
// (hash_pair_numeric, fmix32, _index_and_rank) and the max-merge of
// deequ_tpu/engine/vectorize.py's HLL group:
//
//     (hi, lo)  = 32-bit words of the value (below)
//     h1 = fmix32(lo ^ fmix32(hi ^ 0x9E3779B9))
//     h2 = fmix32(hi ^ fmix32(lo ^ 0x85EBCA6B))
//     out[c, h1 >> (32 - p)] = max(registers_in[c, .], clz(h2) + 1)
//
// in native uint32 with wrapping multiplies. Words: an integer is
// sign-extended to int64 and split into its high and low 32 bits; a
// float is widened to double, -0.0 becomes +0.0, hi = (float)x rounded
// to nearest, lo = (float)(x - hi) with -0.0f -> +0.0f. NaN pins both
// words to 0x7FC00000 and +-inf the residual word to 0xFFC00000, the
// bits the JAX package yields on the CPU; subnormals follow it there
// too, where XLA reads subnormal inputs as zero and flushes subnormal
// results to zero (an input subnormal in its own dtype hashes as +0.0;
// a word below kFtzLimit is a zero). The plain version in
// deequ_tpu_torch/sketches/hll_hash.py does the same. The flush is
// written out, so the build needs neither --use_fast_math nor
// -ftz=true, and has neither.
//
// Bound on an H100 SXM: the kernel must read every value and mask byte
// once, the row mask and registers_in once, and write the int8 registers
// once: C*B*(itemsize+1) + B + 2*C*M bytes, 77.6 MB at the main path's
// shape (C=4, B=2^21, int64), 23 us at 3.35 TB/s. The hash is about 41
// 32-bit operations a row (8 of them multiplies), 0.34 G operations
// there: 5 us at the card's 67 T/s float32 rate, 21 us even at the
// 16.7 T/s its INT32 units give. So it is bound by bytes, and the
// design keeps the hash's intermediates in registers and streams the
// values once. On the card it takes about twice that bound, and an
// int32 column as long as an int64 one (PERF.md): it runs at the SMs'
// integer issue rate, so a faster version must cut instructions a row
// (the seed and fold, the mask handling), not bytes.
//
// Design:
// - grid (S, C), kThreadsFused threads a block: blockIdx.y picks the
//   column, S blocks split its rows grid-strided (the wrapper picks S
//   so the card runs kBlocksPerSmFused blocks an SM, in one wave);
// - each block seeds a private int32 copy of its column's registers in
//   shared memory (64 KB) from registers_in, not from zeros. The skip
//   test "no atomic unless rho > regs[idx]" then gates each row against
//   everything earlier batches established: once the registers are
//   warm, most rows cost a shared load and no atomic;
// - values and masks stream through 16-byte loads (two int64 or four
//   32-bit values, and their 2 or 4 mask bytes), kUnroll loads in flight
//   a thread; a column whose rows are not 16-byte aligned takes a
//   scalar loop (the wrapper checks);
// - the output starts as a copy of registers_in (the launcher copies
//   it on the stream). The block folds only the registers it raised above
//   registers_in, four int8 registers to a 32-bit word, with an
//   atomicCAS loop of a bytewise signed max (__vmaxs4): there is no
//   8-bit atomicMax, and an int32 output would need a widening and a
//   narrowing pass. Max is commutative and associative, so the result
//   is deterministic and bit-identical to the plain version.

constexpr uint32_t kC1 = 0x85EBCA6Bu;
constexpr uint32_t kC2 = 0xC2B2AE35u;
constexpr uint32_t kGolden = 0x9E3779B9u;
constexpr uint32_t kNanBits = 0x7FC00000u;
constexpr uint32_t kInfResidualBits = 0xFFC00000u;
// float64 magnitudes below this round to a float32 that x86 calls tiny
// (FLT_MIN minus half its lower ulp): such a word flushes to zero
constexpr double kFtzLimit = 0x1p-126 - 0x1p-151;
constexpr int kThreadsFused = 256;
constexpr int kBlocksPerSmFused = 3;  // 3 x 64 KB of shared memory an SM
constexpr int kUnroll = 4;

struct Words {
  uint32_t hi;
  uint32_t lo;
};

__device__ __forceinline__ Words int_words(long long v) {
  const unsigned long long u = static_cast<unsigned long long>(v);
  return {static_cast<uint32_t>(u >> 32), static_cast<uint32_t>(u)};
}

__device__ __forceinline__ Words float_words(double x) {
  if (isnan(x)) return {kNanBits, kNanBits};
  if (x == 0.0) x = 0.0;  // -0.0 -> +0.0
  // a word that would be subnormal flushes to zero, the hi word keeping
  // the value's sign
  const float hi = fabs(x) < kFtzLimit ? (signbit(x) ? -0.0f : 0.0f)
                                       : __double2float_rn(x);
  const double rest = x - static_cast<double>(hi);
  float lo = fabs(rest) < kFtzLimit ? 0.0f : __double2float_rn(rest);
  if (lo == 0.0f) lo = 0.0f;  // -0.0f -> +0.0f
  return {__float_as_uint(hi), isinf(x) ? kInfResidualBits : __float_as_uint(lo)};
}

template <typename T>
__device__ __forceinline__ Words words_of(T v) {
  if constexpr (std::is_same<T, float>::value) {
    return float_words(fabsf(v) < 0x1p-126f ? 0.0 : static_cast<double>(v));
  } else if constexpr (std::is_same<T, double>::value) {
    return float_words(fabs(v) < 0x1p-1022 ? 0.0 : v);
  } else {
    return int_words(static_cast<long long>(v));
  }
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= kC1;
  h ^= h >> 13;
  h *= kC2;
  h ^= h >> 16;
  return h;
}

// (register index, rank) of one row; a masked row gets rank 0, which
// raises no register (registers hold ranks >= 0)
template <typename T>
__device__ __forceinline__ void rank_row(T v, bool valid, int shift, int& k,
                                         int& r) {
  const Words w = words_of(v);
  const uint32_t h1 = fmix32(w.lo ^ fmix32(w.hi ^ kGolden));
  const uint32_t h2 = fmix32(w.hi ^ fmix32(w.lo ^ kC1));
  k = static_cast<int>(h1 >> shift);
  r = valid ? min(__clz(static_cast<int>(h2)) + 1, 33) : 0;  // __clz(0) == 32
}

__device__ __forceinline__ void raise_register(int* regs, int k, int r) {
  if (r > regs[k]) atomicMax(regs + k, r);
}

// out[word] = bytewise max(out[word], mine), four int8 registers at a
// time: there is no 8-bit atomicMax. out only grows, so a stale read
// only costs one more CAS round, and a max it already holds costs none.
__device__ __forceinline__ void fold_word(uint32_t* dst, uint32_t mine) {
  uint32_t old = *dst;
  for (;;) {
    const uint32_t want = __vmaxs4(old, mine);
    if (want == old) break;
    const uint32_t seen = atomicCAS(dst, old, want);
    if (seen == old) break;
    old = seen;
  }
}

// Fold a block's int32 register file into the int8 output, one 32-bit
// word (four registers) at a time, skipping the words the block did not
// raise above `seed` (the registers it started from).
__device__ __forceinline__ void fold_file(const int* regs, const int8_t* seed,
                                          int8_t* out, int m) {
  uint32_t* dst = reinterpret_cast<uint32_t*>(out);
  for (int w = threadIdx.x; w < m / 4; w += blockDim.x) {
    uint32_t mine = 0;
    uint32_t base = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      mine |= static_cast<uint32_t>(static_cast<uint8_t>(regs[4 * w + b])) << (8 * b);
      base |= static_cast<uint32_t>(static_cast<uint8_t>(seed[4 * w + b])) << (8 * b);
    }
    if (mine != base) fold_word(dst + w, mine);
  }
}

// the mask bytes of one 16-byte vector of values: 2 or 4 bools
template <typename T>
using MaskWord =
    typename std::conditional<sizeof(T) == 8, uint16_t, uint32_t>::type;

// ranks of the kVec rows of one 16-byte vector, into k[0..kVec), r[..]
template <typename T>
__device__ __forceinline__ void rank_vector(const uint4& raw, uint32_t valid,
                                            int shift, int* k, int* r) {
  constexpr int kVec = 16 / sizeof(T);
  T vals[kVec];
  memcpy(vals, &raw, sizeof(vals));
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    rank_row(vals[j], ((valid >> (8 * j)) & 0xFFu) != 0, shift, k[j], r[j]);
  }
}

template <typename T, bool kVectorLoads>
__global__ void __launch_bounds__(kThreadsFused, kBlocksPerSmFused)
    hll_update_kernel(const T* __restrict__ values,
                      const uint8_t* __restrict__ mask,
                      const uint8_t* __restrict__ row_mask,
                      const int8_t* __restrict__ regs_in,
                      int8_t* __restrict__ out, long long rows, int p) {
  extern __shared__ int regs[];
  const int m = 1 << p;
  const int shift = 32 - p;
  const int c = blockIdx.y;
  const int8_t* seed = regs_in + static_cast<long long>(c) * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) regs[j] = seed[j];
  __syncthreads();

  const T* col = values + static_cast<long long>(c) * rows;
  const uint8_t* col_mask = mask + static_cast<long long>(c) * rows;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (kVectorLoads) {
    // rows is a multiple of the vector width and every pointer is
    // aligned to it (the wrapper checks)
    constexpr int kVec = 16 / sizeof(T);
    using Mask = MaskWord<T>;
    const long long n = rows / kVec;
    const uint4* vv = reinterpret_cast<const uint4*>(col);
    const Mask* mv = reinterpret_cast<const Mask*>(col_mask);
    const Mask* rv = reinterpret_cast<const Mask*>(row_mask);
    for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
      uint4 v[kUnroll];
      uint32_t valid[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __ldcs(vv + i + u * stride);
        valid[u] = __ldcs(mv + i + u * stride);
        if (rv != nullptr) valid[u] &= rv[i + u * stride];
      }
      // every hash first, with no shared-memory access between them, so
      // the kUnroll * kVec independent chains interleave; then the
      // gated atomics
      int k[kUnroll * kVec];
      int r[kUnroll * kVec];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        rank_vector<T>(v[u], valid[u], shift, k + u * kVec, r + u * kVec);
      }
#pragma unroll
      for (int t = 0; t < kUnroll * kVec; ++t) raise_register(regs, k[t], r[t]);
    }
    for (; i < n; i += stride) {
      uint32_t valid = __ldcs(mv + i);
      if (rv != nullptr) valid &= rv[i];
      int k[kVec];
      int r[kVec];
      rank_vector<T>(__ldcs(vv + i), valid, shift, k, r);
#pragma unroll
      for (int t = 0; t < kVec; ++t) raise_register(regs, k[t], r[t]);
    }
  } else {
    for (; i < rows; i += stride) {
      int k;
      int r;
      rank_row(col[i], col_mask[i] && (row_mask == nullptr || row_mask[i]), shift, k, r);
      raise_register(regs, k, r);
    }
  }
  __syncthreads();

  // fold the registers this block raised above registers_in; out was a
  // copy of registers_in
  fold_file(regs, seed, out + static_cast<long long>(c) * m, m);
}

template <typename T, bool kVectorLoads>
cudaError_t launch_update_kernel(const void* values, const void* mask,
                          const void* row_mask, const void* regs_in, void* out,
                          int cols, long long rows, int p, int splits,
                          cudaStream_t stream) {
  const int smem = (1 << p) * static_cast<int>(sizeof(int));
  if (smem > kMaxFileBytes) return cudaErrorInvalidValue;
  auto kernel = hll_update_kernel<T, kVectorLoads>;
  static bool configured[kMaxDevices] = {};
  cudaError_t err =
      set_smem_once(reinterpret_cast<const void*>(kernel), kMaxFileBytes, configured);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(splits, cols), kThreadsFused, smem, stream>>>(
      static_cast<const T*>(values), static_cast<const uint8_t*>(mask),
      static_cast<const uint8_t*>(row_mask), static_cast<const int8_t*>(regs_in),
      static_cast<int8_t*>(out), rows, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_update(const void* values, const void* mask,
                          const void* row_mask, const void* regs_in, void* out,
                          int cols, long long rows, int p, int vec, int splits,
                          cudaStream_t stream) {
  return vec ? launch_update_kernel<T, true>(values, mask, row_mask, regs_in,
                                             out, cols, rows, p, splits, stream)
             : launch_update_kernel<T, false>(values, mask, row_mask, regs_in,
                                              out, cols, rows, p, splits, stream);
}

// ---------------------------------------------------------------------------
// The codes entry: dictionary codes -> the carried HLL registers.
//
// Per column c of a (C, B) block of int32 dictionary codes (-1 = null),
// with the (C, B) column mask, the (B,) row mask of a where= filter (or
// none), the (C, D) int64 hash words h1, h2 of the column's dictionary
// entries (values in [0, 2^32)) and the carried (C, M) int8 registers,
// it computes deequ_tpu_torch/sketches/hll_hash.py::code_index_and_rank,
// the scatter-max and the max with the carry, i.e. the JAX package's
// registers_from_code_presence / LUT gather (deequ_tpu/sketches/hll.py)
// followed by the max-merge of its HLL group:
//
//     valid[c, i] = mask[c, i] && row_mask[i]
//     D <= 4096 (presence branch): entry e is present if some valid row
//         has code e (codes outside [0, D) count for nothing)
//     D >  4096 (gather branch):   entry clamp(code, 0, D - 1) of every
//         valid row is present
//     out[c, h1[e] >> (32 - p)] = max(registers_in[c, .], clz(h2[e]) + 1)
//         over the present entries e
//
// A register is the max rank over the DISTINCT entries present, so
// ranking each present entry once is bit-identical to ranking every row
// (deequ_tpu/sketches/hll.py:183-200).
//
// Bound on an H100 SXM: the codes and masks are read once and the
// registers read and written once, C*B*5 (+ B with a row mask) + 2*C*M
// bytes, plus 16 bytes of hash words a present entry: 10.5 MB at the
// main path's shape (C=1, B=2^21, D=16), 3.1 us at 3.35 TB/s. A row
// costs a compare and a shared-memory load, so it is bound by bytes.
//
// The launcher takes the bitmap up to kMaxBitmapEntries = 4096 entries
// (PRESENCE_DICT_CAP, where the presence branch ends) and the per-row
// file past it, so D alone picks the form and its rule.
//
// Design (hll_codes_bitmap_kernel), the presence branch:
// - grid (S, C): blockIdx.y picks the column, S blocks split its rows
//   grid-strided (the wrapper's planner picks S: kCodesBlocksPerSm
//   blocks an SM, none with too few rows to pay for its bitmap);
// - each block keeps a presence bitmap of D bits in shared memory (at
//   most 512 B, under the default limit). Codes stream as int4 (four
//   rows) with their four mask bytes as one 32-bit load, kUnroll loads
//   in flight a thread, where the column's pointers allow it, and one
//   row at a time for the ragged tail and for unaligned columns (the
//   kernel checks each column's pointers itself);
// - a valid row reads its bit before it sets it with atomicOr: the few
//   hot entries of a real column cost a broadcast shared load, not an
//   atomic (lanes that read one word are served together, so a warp
//   needs no __match_any_sync dedupe first);
// - after the stream each block walks its set bits, ranks each present
//   entry from h1, h2 (top p bits of h1; clz(h2) + 1, 33 for h2 = 0) and
//   max-folds it into out, a copy of registers_in, with fold_word's
//   int8x4 CAS: at most D folds a block, no (C, D, B) intermediate, no
//   zeroed file, no cast, no host sync.
// The gather branch (hll_codes_rows_kernel): past 4096 entries a block
// sees thousands of distinct entries, and S blocks folding each of them
// into out cost more than ranking every row where it lies (measured at
// D = 100,000: PERF.md). Every valid row ranks its entry from the
// gathered hash words into a private int32 file seeded from
// registers_in, folded as hll_update_kernel folds.

constexpr int kThreadsCodes = 256;
constexpr int kCodesBlocksPerSm = 4;  // 2, 3, 4 and 8 an SM measured: PERF.md
constexpr int kMaxBitmapEntries = 1 << 12;  // a 512 B bitmap

__device__ __forceinline__ bool aligned(const void* ptr, int bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % bytes == 0;
}

// The dictionary slot a row counts for, or -1 for a row that counts for
// nothing: a masked row, or (presence branch) a code outside [0, d). The
// gather branch (kClamp) clamps codes into [0, d).
template <bool kClamp>
__device__ __forceinline__ int code_slot(int code, bool valid, int d) {
  if (!valid) return -1;
  if (kClamp) return min(max(code, 0), d - 1);
  return static_cast<unsigned>(code) < static_cast<unsigned>(d) ? code : -1;
}

// (register, rank) of dictionary entry e
__device__ __forceinline__ void entry_rank(const long long* __restrict__ h1,
                                           const long long* __restrict__ h2, int e,
                                           int shift, int& k, int& r) {
  k = static_cast<int>(static_cast<uint32_t>(__ldg(h1 + e)) >> shift);
  r = __clz(static_cast<int>(static_cast<uint32_t>(__ldg(h2 + e)))) + 1;  // __clz(0) == 32
}

// Every row of column c that this thread covers goes to visit(slot).
template <bool kClamp, typename Visit>
__device__ __forceinline__ void stream_codes(const int* __restrict__ col,
                                             const uint8_t* __restrict__ col_mask,
                                             const uint8_t* __restrict__ row_mask,
                                             long long rows, int d, Visit&& visit) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long head = 0;
  if (aligned(col, 16) && aligned(col_mask, 4) && aligned(row_mask, 4)) {
    const long long n = rows >> 2;
    const int4* cv = reinterpret_cast<const int4*>(col);
    const unsigned int* mv = reinterpret_cast<const unsigned int*>(col_mask);
    const unsigned int* rv = reinterpret_cast<const unsigned int*>(row_mask);
    auto visit4 = [&](const int4& v, unsigned int ok) {
      const int cs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) visit(code_slot<kClamp>(cs[j], (ok >> (8 * j)) & 0xFFu, d));
    };
    long long i = tid;
    for (; i + (kUnroll - 1) * stride < n; i += kUnroll * stride) {
      int4 v[kUnroll];
      unsigned int ok[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __ldcs(cv + i + u * stride);
        ok[u] = __ldcs(mv + i + u * stride);
        if (rv != nullptr) ok[u] &= __ldg(rv + i + u * stride);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) visit4(v[u], ok[u]);
    }
    for (; i < n; i += stride) {
      unsigned int ok = __ldcs(mv + i);
      if (rv != nullptr) ok &= __ldg(rv + i);
      visit4(__ldcs(cv + i), ok);
    }
    head = n << 2;
  }
  for (long long i = head + tid; i < rows; i += stride) {
    visit(code_slot<kClamp>(col[i], col_mask[i] && (row_mask == nullptr || row_mask[i]), d));
  }
}

__global__ void __launch_bounds__(kThreadsCodes)
    hll_codes_bitmap_kernel(const int* __restrict__ codes,
                            const uint8_t* __restrict__ mask,
                            const uint8_t* __restrict__ row_mask,
                            const long long* __restrict__ lut1,
                            const long long* __restrict__ lut2,
                            int8_t* __restrict__ out, long long rows, int d, int p) {
  extern __shared__ unsigned int bits[];
  const int words = (d + 31) >> 5;
  for (int j = threadIdx.x; j < words; j += blockDim.x) bits[j] = 0;
  __syncthreads();

  const int c = blockIdx.y;
  const long long at = static_cast<long long>(c) * rows;
  stream_codes<false>(codes + at, mask + at, row_mask, rows, d, [&](int slot) {
    if (slot < 0) return;
    unsigned int* w = bits + (slot >> 5);
    const unsigned int b = 1u << (slot & 31);
    if ((*w & b) == 0) atomicOr(w, b);
  });
  __syncthreads();

  const int shift = 32 - p;
  const long long* h1 = lut1 + static_cast<long long>(c) * d;
  const long long* h2 = lut2 + static_cast<long long>(c) * d;
  uint32_t* dst = reinterpret_cast<uint32_t*>(out + (static_cast<long long>(c) << p));
  for (int j = threadIdx.x; j < words; j += blockDim.x) {
    for (unsigned int w = bits[j]; w != 0; w &= w - 1) {
      int k;
      int r;
      entry_rank(h1, h2, (j << 5) + __ffs(w) - 1, shift, k, r);
      fold_word(dst + (k >> 2), static_cast<uint32_t>(r) << (8 * (k & 3)));
    }
  }
}

__global__ void __launch_bounds__(kThreadsCodes)
    hll_codes_rows_kernel(const int* __restrict__ codes,
                          const uint8_t* __restrict__ mask,
                          const uint8_t* __restrict__ row_mask,
                          const long long* __restrict__ lut1,
                          const long long* __restrict__ lut2,
                          const int8_t* __restrict__ regs_in,
                          int8_t* __restrict__ out, long long rows, int d, int p) {
  extern __shared__ int regs[];
  const int m = 1 << p;
  const int shift = 32 - p;
  const int c = blockIdx.y;
  const int8_t* seed = regs_in + static_cast<long long>(c) * m;
  for (int j = threadIdx.x; j < m; j += blockDim.x) regs[j] = seed[j];
  __syncthreads();

  const long long at = static_cast<long long>(c) * rows;
  const long long* h1 = lut1 + static_cast<long long>(c) * d;
  const long long* h2 = lut2 + static_cast<long long>(c) * d;
  stream_codes<true>(codes + at, mask + at, row_mask, rows, d, [&](int slot) {
    if (slot < 0) return;
    int k;
    int r;
    entry_rank(h1, h2, slot, shift, k, r);
    raise_register(regs, k, r);
  });
  __syncthreads();
  fold_file(regs, seed, out + static_cast<long long>(c) * m, m);
}

// out = regs_in, (cols, 2^p) int8, on the stream: the entries fold into
// a copy of the carry
cudaError_t copy_carry(void* out, const void* regs_in, int cols, int p, cudaStream_t stream) {
  return cudaMemcpyAsync(out, regs_in, static_cast<size_t>(cols) << p,
                         cudaMemcpyDeviceToDevice, stream);
}

cudaError_t launch_codes(const void* codes, const void* mask, const void* row_mask,
                         const void* lut1, const void* lut2, const void* regs_in,
                         void* out, int cols, long long rows, int d, int p, int splits,
                         cudaStream_t stream) {
  if (cols < 1 || rows < 0 || d < 1 || p < 2 || p > 14 || splits < 1) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(splits, cols);
  cudaError_t err = copy_carry(out, regs_in, cols, p, stream);
  if (err != cudaSuccess) return err;
  if (d <= kMaxBitmapEntries) {
    const int smem = ((d + 31) >> 5) * static_cast<int>(sizeof(unsigned int));
    hll_codes_bitmap_kernel<<<grid, kThreadsCodes, smem, stream>>>(
        static_cast<const int*>(codes), static_cast<const uint8_t*>(mask),
        static_cast<const uint8_t*>(row_mask), static_cast<const long long*>(lut1),
        static_cast<const long long*>(lut2), static_cast<int8_t*>(out), rows, d, p);
  } else {
    static bool configured[kMaxDevices] = {};
    err = set_smem_once(reinterpret_cast<const void*>(hll_codes_rows_kernel),
                        kMaxFileBytes, configured);
    if (err != cudaSuccess) return err;
    hll_codes_rows_kernel<<<grid, kThreadsCodes, (1 << p) * static_cast<int>(sizeof(int)),
                            stream>>>(
        static_cast<const int*>(codes), static_cast<const uint8_t*>(mask),
        static_cast<const uint8_t*>(row_mask), static_cast<const long long*>(lut1),
        static_cast<const long long*>(lut2), static_cast<const int8_t*>(regs_in),
        static_cast<int8_t*>(out), rows, d, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`: idx, rho are (cols, rows) int32, out is (cols, m)
// int32; the launcher zeroes it on the stream first (one memset, not a
// PyTorch launch around the kernel). Returns the cudaError_t of the
// launch.
int hll_scatter_max_launch(const void* idx, const void* rho, void* out,
                           int cols, long long rows, int m, int splits,
                           int threads, void* stream) {
  const int smem = m * static_cast<int>(sizeof(int));
  if (m < 1 || smem > kMaxFileBytes) return static_cast<int>(cudaErrorInvalidValue);
  static bool configured[kMaxDevices] = {};
  cudaError_t err = set_smem_once(reinterpret_cast<const void*>(hll_scatter_max_kernel),
                                  kMaxFileBytes, configured);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(out, 0, static_cast<size_t>(cols) * smem,
                        static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(splits, cols);
  hll_scatter_max_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(idx), static_cast<const int*>(rho),
      static_cast<int*>(out), rows, m);
  return static_cast<int>(cudaGetLastError());
}

// The fused update, launched on `stream`. values is (cols, rows) of
// dtype code 0 = int64, 1 = int32, 2 = float64, 3 = float32; mask is
// (cols, rows) bool; row_mask is (rows,) bool or null; regs_in and out
// are (cols, 2^p) int8; the launcher copies regs_in into out on the
// stream first. vec != 0 takes
// the 16-byte loads (rows a multiple of 16 / itemsize, every pointer
// aligned). Returns the cudaError_t of the launch.
int hll_update_launch(const void* values, int dtype, const void* mask,
                      const void* row_mask, const void* regs_in, void* out,
                      int cols, long long rows, int p, int vec, int splits,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = copy_carry(out, regs_in, cols, p, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (dtype) {
    case 0:
      return launch_update<long long>(values, mask, row_mask, regs_in, out,
                                      cols, rows, p, vec, splits, s);
    case 1:
      return launch_update<int>(values, mask, row_mask, regs_in, out, cols,
                                rows, p, vec, splits, s);
    case 2:
      return launch_update<double>(values, mask, row_mask, regs_in, out, cols,
                                   rows, p, vec, splits, s);
    case 3:
      return launch_update<float>(values, mask, row_mask, regs_in, out, cols,
                                  rows, p, vec, splits, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int hll_update_blocks_per_sm() { return kBlocksPerSmFused; }

// The codes entry, launched on `stream`. codes is (cols, rows) int32
// (-1 = null); mask is (cols, rows) bool; row_mask is (rows,) bool or
// null; lut1, lut2 are (cols, d) int64 hash words in [0, 2^32);
// regs_in and out are (cols, 2^p) int8; the launcher copies regs_in into
// out on the stream first. d <= 4096 takes the presence branch (a
// bitmap a block), a larger d the gather branch (a per-row file a
// block). splits comes from the wrapper's planner. Returns the
// cudaError_t of the launch.
int hll_update_codes_launch(const void* codes, const void* mask,
                            const void* row_mask, const void* lut1,
                            const void* lut2, const void* regs_in, void* out,
                            int cols, long long rows, int d, int p, int splits,
                            void* stream) {
  return static_cast<int>(launch_codes(codes, mask, row_mask, lut1, lut2, regs_in,
                                       out, cols, rows, d, p, splits,
                                       static_cast<cudaStream_t>(stream)));
}

const char* hll_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
