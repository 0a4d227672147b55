// Hopper (sm_90a) counterparts of the eight Pallas TPU design probes.
//
// Replaces tools/probe_pallas.py::probe1/probe2/probe3 and
// tools/probe_pallas_rates.py::probe_A..probe_E. Each kernel computes
// what its TPU kernel computes, on the layout that suits this card, and
// measures the primitive that the TPU probe measured: the cost of a
// launch, dependent row loads from shared memory, L2 and HBM, the row
// copy rate at a given number of copies in flight, and a lane gather.
// Those are the numbers the SMEM seeding kernel's design rests on; the
// fused occ checkpoint row of the port is [8] int32 (32 bytes,
// bwa_mem_scale_tpu_torch/ops/occ.py), so every table probe also takes
// W = 8 beside the TPU's W = 128.
//
// Every launch function has a plain C interface (bound with ctypes by
// bwa_mem_scale_tpu_torch/ops/probe_kernels.py), launches on the stream
// it is given, allocates nothing, and returns cudaGetLastError() after
// its launch, so a refused launch (too much shared memory, too many
// threads) is reported and cleared. Integer sums and products wrap like
// JAX's int32: they are taken in uint32_t (signed overflow is undefined
// in C++), and the floored modulo of JAX and PyTorch is written out
// (C's % truncates, and probe B's is a multiply, below). Row indices are
// clamped into the table, as a JAX gather clamps them, so no input reads
// out of bounds.
//
// What bounds each on an H100, and what the design does about it:
// - probe1, C, D are a few microseconds of device work: the launch
//   bounds them (and the host, which enqueues slower than the card runs).
//   probe1's time is that launch floor, the number it exists to measure,
//   so no design of its body can lower it.
//   D is one warp and one TMA bulk copy that completes on an mbarrier,
//   the counterpart of the TPU's async copy and DMA semaphore, so its
//   cost is the launch plus one copy, not a loop of loads and a barrier.
// - probe2 is bound by staging the table into shared memory: 16-byte
//   loads by 1024 threads, column slices across blocks.
// - probe3 waits one row latency a step: the next row's copy is issued
//   before the current one is summed.
// - probe B (replaces probe_pallas_rates.py::probe_B) is one dependent
//   load latency per tick plus the index arithmetic: lanes are
//   independent, so no grid barrier; tables that fit are staged in
//   shared memory, others are read through the read-only path, one lane
//   a thread in 32-thread blocks so the lanes spread over the SMs. The
//   floored modulo by NB is a multiply (Lemire's fastmod, constants
//   computed once on the host), not a runtime division on the chain.
// - probe E (replaces probe_pallas_rates.py::probe_E) is bound by the
//   copies' latency: each block owns a contiguous run of rows and keeps
//   D of them in flight, issued and waited on by up to 32 lanes side by
//   side, each slot of the ring completing on its own mbarrier (the TPU
//   kernel's async copies and DMA semaphore array), and the grid fills
//   the card. A row of up to 32 bytes goes by cp.async, a longer one by
//   one TMA bulk copy, whichever measured faster; the launch picks the
//   kernel built for its engine by W. D is copies in flight per block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
// the most rows a probe E block owns (its row indices sit in shared
// memory); T above the card's SMs times this takes more blocks than SMs
constexpr int kMaxBlockRows = 2048;

__device__ __forceinline__ int clamp_row(int v, int n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

__device__ __forceinline__ uint32_t sum4(int4 v) {
  return (uint32_t)v.x + (uint32_t)v.y + (uint32_t)v.z + (uint32_t)v.w;
}

// The floored modulo of an int32 by nb in [1, 2^31 - 1] without a
// division. u = v + 2^31 (as uint32) ranks v over the whole int32 range;
// u mod nb is Lemire's fastmod, the high word of (m * u) * nb with m =
// ceil(2^64 / nb), exact for every 32-bit u and divisor; then v mod nb =
// (u mod nb - 2^31 mod nb) mod nb. At nb = 1, m wraps to 0 and the
// formula gives 0, which is u mod 1.
struct FastMod {
  uint64_t m;                                   // ceil(2^64 / nb)
  uint32_t nb;
  uint32_t c;                                   // 2^31 mod nb
};

FastMod fastmod_of(int nb) {
  FastMod f;
  f.nb = (uint32_t)nb;
  f.m = nb == 1 ? 0 : UINT64_MAX / f.nb + 1;
  f.c = (1u << 31) % f.nb;
  return f;
}

__device__ __forceinline__ int floor_mod(int32_t v, FastMod f) {
  const uint32_t u = (uint32_t)v ^ 0x80000000u;
  const int r = (int)__umul64hi(f.m * u, f.nb) - (int)f.c;
  return r < 0 ? r + (int)f.nb : r;
}

// next lane index of probe B: (sum of the row's first 8 words) *
// 1103515245, wrapped to int32, floored modulo the table's rows
__device__ __forceinline__ int next_index(uint32_t s, FastMod f) {
  return floor_mod((int32_t)(s * 1103515245u), f);
}

// a 16-byte read-only load of a table row the compiler may not drop (at
// W = 128 only the first 8 words of a row feed the chain, yet the probe
// has to move the whole row, as the TPU kernel did). An L2 evict_last
// policy on it bought nothing on an H100: the tables stay in L2 unhinted
// while nothing else runs.
__device__ __forceinline__ int4 ld_row(const int4* p) {
  int4 v;
  asm volatile("ld.global.nc.v4.s32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// cp.async.wait_group takes an immediate, hence the template
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

__device__ __forceinline__ void store4(int32_t* out, int4 v) {
  out[0] = v.x;
  out[1] = v.y;
  out[2] = v.z;
  out[3] = v.w;
}

// ---- probe1: out = x * 2 + 1, one thread per element --------------------
__global__ void affine_kernel(const int32_t* __restrict__ x,
                              int32_t* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = (int32_t)((uint32_t)x[i] * 2u + 1u);
}

// ---- probe2: out[c] = sum_i tab[idx[i], c], table in shared memory -----
// Block b stages the column slice [c0, c0 + cw) of all R rows, 16 bytes
// a thread (W and cw are multiples of 4); each output column is
// independent, so the slices need no cross-block sum.
__global__ void smem_sum_kernel(const int32_t* __restrict__ tab,
                                const int32_t* __restrict__ idx,
                                int32_t* __restrict__ out, int R, int W,
                                int N, int cw) {
  extern __shared__ int32_t slice[];            // [R, cw]
  const int c0 = blockIdx.x * cw, q = cw >> 2, wq = W >> 2;
  const int4* g = reinterpret_cast<const int4*>(tab) + (c0 >> 2);
  int4* s = reinterpret_cast<int4*>(slice);
  for (int e = threadIdx.x; e < R * q; e += blockDim.x)
    s[e] = g[(size_t)(e / q) * wq + e % q];
  __syncthreads();
  const int c = threadIdx.x;
  if (c >= cw) return;
  uint32_t acc = 0;
  for (int i = 0; i < N; ++i)
    acc += (uint32_t)slice[clamp_row(idx[i], R) * cw + c];
  out[c0 + c] = (int32_t)acc;
}

// ---- probe3: the same sum, rows copied from HBM through a 2-slot ring --
// One block of W/4 <= 32 threads; thread t copies and sums the 16 bytes
// at words [4t, 4t + 4) of each row, so it reads only what it copied.
// Row i + 1's copy is in flight while row i is summed.
__global__ void hbm_sum_kernel(const int32_t* __restrict__ idx,
                               const int32_t* __restrict__ tab,
                               int32_t* __restrict__ out, int R, int W,
                               int N) {
  extern __shared__ int4 ring[];                // [2, W/4]
  const int q = W >> 2, t = threadIdx.x;
  const unsigned live = q >= 32 ? kFull : (1u << q) - 1u;
  const int4* rows = reinterpret_cast<const int4*>(tab);
  uint32_t a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  if (N > 0) cp_async16(&ring[t], rows + (size_t)clamp_row(idx[0], R) * q + t);
  cp_async_commit();
  for (int i = 0; i < N; ++i) {
    if (i + 1 < N)
      cp_async16(&ring[((i + 1) & 1) * q + t],
                 rows + (size_t)clamp_row(idx[i + 1], R) * q + t);
    cp_async_commit();                          // empty on the last row
    cp_async_wait<1>();                         // row i has landed
    const int4 v = ring[(i & 1) * q + t];
    a0 += (uint32_t)v.x;
    a1 += (uint32_t)v.y;
    a2 += (uint32_t)v.z;
    a3 += (uint32_t)v.w;
    __syncwarp(live);                           // read before the refill
  }
  store4(out + 4 * t, make_int4((int32_t)a0, (int32_t)a1, (int32_t)a2,
                                (int32_t)a3));
}

// ---- probe A: a dynamic shared-memory scratch of n_rows x W words ------
// The TPU kernel read row n-1 without writing it. Here rows 0 and n-1
// both receive x, so the output is the defined 2 * x.
__global__ void smem_capacity_kernel(const int32_t* __restrict__ x,
                                     int32_t* __restrict__ out, int n_rows,
                                     int W) {
  extern __shared__ int32_t scratch[];          // [n_rows, W]
  int32_t* last = scratch + (size_t)(n_rows - 1) * W;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    scratch[j] = x[j];
    last[j] = x[j];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < W; j += blockDim.x)
    out[j] = (int32_t)((uint32_t)last[j] + (uint32_t)scratch[j]);
}

// ---- probe B: NT chained ticks over T lanes ----------------------------
// Each lane's chain is independent of every other lane's, so one launch
// runs all NT ticks with no grid-wide barrier. A tick is one dependent
// row load, a sum, a multiply and the fastmod above.
// W = 8 (the port's occ row): one thread per lane, the row as two int4.
// With SMEM, every block first stages the whole table in shared memory;
// without, the rows come through the read-only path (ld_row).
template <bool SMEM>
__global__ void chain8_kernel(const int32_t* __restrict__ tab,
                              const int32_t* __restrict__ idx0,
                              int32_t* __restrict__ out, FastMod f, int T,
                              int NT) {
  extern __shared__ int4 stab[];                // [NB, 2] when SMEM
  const int NB = (int)f.nb;
  const int4* g = reinterpret_cast<const int4*>(tab);
  if (SMEM) {
    for (int e = threadIdx.x; e < 2 * NB; e += blockDim.x) stab[e] = g[e];
    __syncthreads();
  }
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= T) return;
  int ix = clamp_row(idx0[lane], NB);
  int4 r0 = make_int4(0, 0, 0, 0), r1 = r0;
  for (int t = 0; t < NT; ++t) {
    if (SMEM) {
      r0 = stab[2 * ix];
      r1 = stab[2 * ix + 1];
    } else {
      r0 = ld_row(g + 2 * (size_t)ix);
      r1 = ld_row(g + 2 * (size_t)ix + 1);
    }
    ix = next_index(sum4(r0) + sum4(r1), f);
  }
  if (lane == 0) {
    store4(out, r0);
    store4(out + 4, r1);
  }
}

// W = 128 (the TPU's row): one warp per lane, 16 bytes a thread; words
// 0-7 sit in threads 0 and 1, whose sum every thread receives by shuffle.
__global__ void chain128_kernel(const int32_t* __restrict__ tab,
                                const int32_t* __restrict__ idx0,
                                int32_t* __restrict__ out, FastMod f, int T,
                                int NT) {
  const int lane = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int l = threadIdx.x & 31;
  if (lane >= T) return;                        // whole warps only
  const int4* g = reinterpret_cast<const int4*>(tab);
  int ix = clamp_row(idx0[lane], (int)f.nb);
  int4 v = make_int4(0, 0, 0, 0);
  for (int t = 0; t < NT; ++t) {
    v = ld_row(g + (size_t)ix * 32 + l);
    uint32_t s = l < 2 ? sum4(v) : 0u;
    s += __shfl_xor_sync(kFull, s, 1);
    s = __shfl_sync(kFull, s, 0);
    ix = next_index(s, f);
  }
  if (lane == 0) store4(out + 4 * l, v);
}

// ---- probe C: out[t, j] = x[t, idx[t, j]] ------------------------------
// A row of W words spans W/4 threads (4 words each); the gather is four
// shuffles within that segment and a select of the word.
__global__ void lane_gather_kernel(const int32_t* __restrict__ x,
                                   const int32_t* __restrict__ idx,
                                   int32_t* __restrict__ out, int T,
                                   int W) {
  const int q = W >> 2;
  const long g = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = g < (long)T * q;            // every lane shuffles
  const int4 zero = make_int4(0, 0, 0, 0);
  const int4 xv = live ? reinterpret_cast<const int4*>(x)[g] : zero;
  const int4 iv = live ? reinterpret_cast<const int4*>(idx)[g] : zero;
  const int src[4] = {iv.x, iv.y, iv.z, iv.w};
  int res[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = clamp_row(src[k], W);
    const int from = s >> 2, word = s & 3;
    const int a = __shfl_sync(kFull, xv.x, from, q);
    const int b = __shfl_sync(kFull, xv.y, from, q);
    const int c = __shfl_sync(kFull, xv.z, from, q);
    const int d = __shfl_sync(kFull, xv.w, from, q);
    res[k] = word == 0 ? a : (word == 1 ? b : (word == 2 ? c : d));
  }
  if (live)
    reinterpret_cast<int4*>(out)[g] = make_int4(res[0], res[1], res[2],
                                                res[3]);
}

// ---- probe D: an address vector handed to one thread -------------------
// The TPU kernel starts one async copy of the vector into scalar memory,
// waits on its DMA semaphore and reads one scalar. Here: one warp; thread
// 0 sets up an mbarrier, arms it for the copy's bytes and issues one TMA
// bulk copy (global -> shared) that completes on it; the warp waits on
// the barrier's phase, then thread 0 reads element k. A bulk copy moves a
// multiple of 16 bytes from and to 16-byte-aligned addresses (the wrapper
// checks the source), so the last T % 4 words, if any, are loaded by
// plain loads of lanes 1-3 beside it.
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// mbarriers and TMA bulk copies (probes D and E). A barrier initialised
// with one arrival completes its phase when that arrival has come and
// the bytes it was armed with have landed.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(bar)
               : "memory");
}

// after the inits: make them visible to the async proxy (the TMA unit)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// arm `bar` for `bytes` and copy them from global `src` to shared `dst`
// (16-byte aligned, a multiple of 16 bytes); the copy completes on `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
         "r"(bar)
      : "memory");
}

// The same copy as 16-byte cp.async copies of the calling thread, whose
// completion is the arrival on `bar` (noinc: the barrier's one expected
// arrival).
__device__ __forceinline__ void lsu_copy(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  const char* g = reinterpret_cast<const char*>(src);
  for (uint32_t o = 0; o < bytes; o += 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
                 :: "r"(dst + o), "l"(g + o) : "memory");
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];"
               :: "r"(bar) : "memory");
}

// Probe E copies a row of at most this many bytes with the lane's
// cp.async copies, a longer one with one TMA bulk copy: on an H100 the
// cp.async ring was the faster at 32-byte rows (the occ row), the TMA
// ring at 512-byte rows. The launch picks the engine by W, at compile
// time (row_copy_kernel's BULK).
constexpr uint32_t kLsuRowBytes = 32;

template <bool BULK>
__device__ __forceinline__ void row_copy(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  if (BULK)
    bulk_copy(dst, src, bytes, bar);
  else
    lsu_copy(dst, src, bytes, bar);
}

// spin until the phase of `bar` with parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

__global__ void handoff_kernel(const int32_t* __restrict__ v,
                               int32_t* __restrict__ out, int T, int k) {
  extern __shared__ __align__(16) int32_t vec[];    // [T]
  __shared__ __align__(8) uint64_t bar;
  const uint32_t b = smem_addr(&bar);
  const int bulk_words = T & ~3;
  const int l = threadIdx.x;
  if (l == 0) {
    mbar_init(b);
    mbar_init_fence();
  }
  __syncwarp();
  if (l == 0) {
    bulk_copy(smem_addr(vec), v, (uint32_t)bulk_words * 4u, b);
  } else if (bulk_words + l - 1 < T) {
    vec[bulk_words + l - 1] = v[bulk_words + l - 1];
  }
  mbar_wait(b, 0);
  __syncwarp();                                 // the tail's plain stores
  if (l == 0) out[0] = vec[k];
}

// ---- probe E: row copies with D in flight, NT ticks of T rows ----------
// Block b of G owns rows [b * T / G, (b + 1) * T / G) of every tick (G
// <= T, so every block owns at least one row; block_rows) and a ring of
// D row slots in shared memory, each with its own mbarrier. Each row (W *
// 4 bytes: 32 at W = 8, 512 at W = 128) is copied by row_copy<BULK>, the
// lane's 16-byte cp.async copies or one TMA bulk copy, into slot k % D,
// where k counts the block's copies over rows and ticks, so slot s's
// n-th use is copy s + n * D and completes its barrier's phase of
// parity n & 1.
// Lane l of the block's one warp owns slots l and l + 32 (those below
// D): it issues its slots' first rows of a tick, then waits on each of
// its rows in turn and refills the slot with the row D further on. So
// min(D, 32) lanes issue and wait side by side (one issuing thread took
// ~115 ns a row on an H100, whatever D), a slot is refilled only by the
// lane that waited on it, and the warp meets at the end of a tick, which
// drains before the next starts, as the TPU kernel's did. The block's row
// indices are staged in shared memory first, as the TPU kernel held them
// in scalar memory. All ticks copy the same rows; the lane that waits on
// row 0 in the last tick writes it out, then fences the async proxy
// before that slot's next copy.
__host__ __device__ __forceinline__ int2 block_rows(int b, int G, int T) {
  const int first = (int)((int64_t)b * T / G);
  return make_int2(first, (int)((int64_t)(b + 1) * T / G) - first);
}

template <int D, bool BULK>
__global__ void row_copy_kernel(const int32_t* __restrict__ idx,
                                const int32_t* __restrict__ tab,
                                int32_t* __restrict__ out, int NB, int W,
                                int T, int NT) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t row_bytes = (uint32_t)W * 4u;
  unsigned char* ring = smem;                         // [D, W] words
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + D * row_bytes);
  int* rix = reinterpret_cast<int*>(bars + D);        // [rows]
  const int l = threadIdx.x;
  const int2 own = block_rows(blockIdx.x, gridDim.x, T);
  const int first = own.x, rows = own.y;
  for (int e = l; e < rows; e += 32) rix[e] = clamp_row(idx[first + e], NB);
  for (int s = l; s < D; s += 32) mbar_init(smem_addr(bars + s));
  mbar_init_fence();
  __syncwarp();
  if (l >= D) return;
  const unsigned live = D >= 32 ? kFull : (1u << (D % 32)) - 1u;
  const unsigned char* src = reinterpret_cast<const unsigned char*>(tab);
  const uint32_t ring0 = smem_addr(ring), bar0 = smem_addr(bars);
  uint32_t k0 = 0;                              // copies of earlier ticks
  for (int t = 0; t < NT; ++t, k0 += rows) {
    const int shift = (int)(k0 % D);            // row j sits in slot
    for (int s = l; s < D; s += 32) {           // (shift + j) % D
      const int j = (s - shift + D) % D;
      if (j < rows)
        row_copy<BULK>(ring0 + s * row_bytes,
                       src + (size_t)rix[j] * row_bytes, row_bytes,
                       bar0 + 8 * s);
    }
    for (int s = l; s < D; s += 32) {
      for (int j = (s - shift + D) % D; j < rows; j += D) {
        const uint32_t k = k0 + j;
        mbar_wait(bar0 + 8 * s, (k / D) & 1u);
        if (t == NT - 1 && first + j == 0) {
          const int4* row =
              reinterpret_cast<const int4*>(ring + s * row_bytes);
          for (int q = 0; q < W / 4; ++q) store4(out + 4 * q, row[q]);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        }
        if (j + D < rows)
          row_copy<BULK>(ring0 + s * row_bytes,
                         src + (size_t)rix[j + D] * row_bytes, row_bytes,
                         bar0 + 8 * s);
      }
    }
    __syncwarp(live);                           // the tick has drained
  }
}

cudaError_t allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

int smem_optin() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return bytes;
}

int sm_count() {
  int dev = 0, n = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  return n;
}

// probe E's grid for T >= 1 rows on `sms` SMs: one block a SM where T
// allows (min(T, SMs)), more where a block would own more than
// kMaxBlockRows rows; block b owns block_rows(b, blocks, T), floor or
// ceil of T / blocks rows, so the largest owns `most`
struct RowPlan {
  int blocks, most;
};

RowPlan plan_rows(int T, int sms) {
  RowPlan p;
  p.blocks = T < sms ? T : sms;
  const int need = (T + kMaxBlockRows - 1) / kMaxBlockRows;
  if (p.blocks < need) p.blocks = need;
  p.most = (T + p.blocks - 1) / p.blocks;
  return p;
}

template <int D, bool BULK>
int launch_ring(const int32_t* idx, const int32_t* tab, int32_t* out,
                int NB, int W, int T, int NT, cudaStream_t s) {
  const RowPlan p = plan_rows(T, sm_count());
  const size_t bytes = (size_t)D * W * 4 + (size_t)D * sizeof(uint64_t) +
                       (size_t)p.most * sizeof(int);
  const void* fn = (const void*)row_copy_kernel<D, BULK>;
  const cudaError_t e = allow_smem(fn, bytes);
  if (e != cudaSuccess) return (int)e;
  row_copy_kernel<D, BULK><<<p.blocks, 32, bytes, s>>>(idx, tab, out, NB, W,
                                                       T, NT);
  return (int)cudaGetLastError();
}

template <int D>
int launch_row_copy(const int32_t* idx, const int32_t* tab, int32_t* out,
                    int NB, int W, int T, int NT, cudaStream_t s) {
  if (T < 1) return (int)cudaErrorInvalidValue;
  if ((uint32_t)W * 4u > kLsuRowBytes)
    return launch_ring<D, true>(idx, tab, out, NB, W, T, NT, s);
  return launch_ring<D, false>(idx, tab, out, NB, W, T, NT, s);
}

}  // namespace

extern "C" {

// cudaDevAttrMaxSharedMemoryPerBlockOptin of the current device, bytes
int probe_smem_optin() { return smem_optin(); }

int probe1_launch(const int32_t* x, int32_t* out, int n, void* stream) {
  const int block = 256;
  affine_kernel<<<(n + block - 1) / block, block, 0,
                  (cudaStream_t)stream>>>(x, out, n);
  return (int)cudaGetLastError();
}

// k, the number of column slices, is the least divisor of W whose slice
// of R rows fits the opt-in shared memory of one block
int probe2_launch(const int32_t* tab, const int32_t* idx, int32_t* out,
                  int R, int W, int N, void* stream) {
  const size_t optin = (size_t)smem_optin();
  int k = 1;
  while (k <= W && (W % k != 0 || (W / k) % 4 != 0 ||
                    (size_t)R * (W / k) * 4 > optin))
    ++k;
  if (k > W || W / k > 1024) return (int)cudaErrorInvalidValue;
  const int cw = W / k;
  const size_t bytes = (size_t)R * cw * 4;
  const cudaError_t e = allow_smem((const void*)smem_sum_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  smem_sum_kernel<<<k, 1024, bytes, (cudaStream_t)stream>>>(tab, idx, out,
                                                            R, W, N, cw);
  return (int)cudaGetLastError();
}

int probe3_launch(const int32_t* idx, const int32_t* tab, int32_t* out,
                  int R, int W, int N, void* stream) {
  const int q = W >> 2;
  hbm_sum_kernel<<<1, q, 2 * q * sizeof(int4), (cudaStream_t)stream>>>(
      idx, tab, out, R, W, N);
  return (int)cudaGetLastError();
}

// The attribute is asked for n_rows * W * 4 bytes; past the opt-in
// limit the request fails, the attribute keeps its last value and the
// launch itself is refused. Both errors are cleared here.
int probe_a_launch(const int32_t* x, int32_t* out, int n_rows, int W,
                   void* stream) {
  const size_t bytes = (size_t)n_rows * W * 4;
  cudaFuncSetAttribute((const void*)smem_capacity_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  (void)cudaGetLastError();
  smem_capacity_kernel<<<1, 128, bytes, (cudaStream_t)stream>>>(x, out,
                                                                n_rows, W);
  return (int)cudaGetLastError();
}

// W = 8 stages the table in shared memory whenever it fits one block's
// opt-in limit (128 threads a block share the staging); otherwise, and
// at W = 128, it reads the table from global memory (L2 or HBM), one
// warp a block at W = 8 so the lanes spread over the SMs
int probe_b_launch(const int32_t* tab, const int32_t* idx0, int32_t* out,
                   int NB, int W, int T, int NT, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (NB < 1) return (int)cudaErrorInvalidValue;
  const FastMod f = fastmod_of(NB);
  if (W == 128) {
    const int warps_per_block = 8;
    chain128_kernel<<<(T + warps_per_block - 1) / warps_per_block,
                      32 * warps_per_block, 0, s>>>(tab, idx0, out, f, T,
                                                    NT);
    return (int)cudaGetLastError();
  }
  if (W != 8) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)NB * 8 * 4;
  if (bytes <= (size_t)smem_optin()) {
    const int block = 128;
    const cudaError_t e = allow_smem((const void*)chain8_kernel<true>, bytes);
    if (e != cudaSuccess) return (int)e;
    chain8_kernel<true><<<(T + block - 1) / block, block, bytes, s>>>(
        tab, idx0, out, f, T, NT);
  } else {
    chain8_kernel<false><<<(T + 31) / 32, 32, 0, s>>>(tab, idx0, out, f, T,
                                                      NT);
  }
  return (int)cudaGetLastError();
}

int probe_c_launch(const int32_t* x, const int32_t* idx, int32_t* out,
                   int T, int W, void* stream) {
  const long threads = (long)T * (W >> 2);
  const int block = 256;
  lane_gather_kernel<<<(int)((threads + block - 1) / block), block, 0,
                       (cudaStream_t)stream>>>(x, idx, out, T, W);
  return (int)cudaGetLastError();
}

int probe_d_launch(const int32_t* v, int32_t* out, int T, int k,
                   void* stream) {
  // the bulk copy needs at least 16 bytes; the tail loads need lanes 1-3
  if (T < 4 || k < 0 || k >= T) return (int)cudaErrorInvalidValue;
  const size_t bytes = (size_t)T * 4;
  const cudaError_t e = allow_smem((const void*)handoff_kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  handoff_kernel<<<1, 32, bytes, (cudaStream_t)stream>>>(v, out, T, k);
  return (int)cudaGetLastError();
}

int probe_e_launch(const int32_t* idx, const int32_t* tab, int32_t* out,
                   int NB, int W, int T, int NT, int D, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 4: return launch_row_copy<4>(idx, tab, out, NB, W, T, NT, s);
    case 16: return launch_row_copy<16>(idx, tab, out, NB, W, T, NT, s);
    case 64: return launch_row_copy<64>(idx, tab, out, NB, W, T, NT, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// probe_e_launch's grid for T rows on a card of `sms` SMs: out[0] =
// blocks, out[1] = rows of the largest block, out[2] = copies in flight
// across the card at depth D (the sum over blocks of min(D, its rows))
int probe_e_plan(int T, int D, int sms, int* out) {
  if (T < 1 || D < 1 || sms < 1) return (int)cudaErrorInvalidValue;
  const RowPlan p = plan_rows(T, sms);
  long flight = 0;
  for (int b = 0; b < p.blocks; ++b) {
    const int rows = block_rows(b, p.blocks, T).y;
    flight += rows < D ? rows : D;
  }
  out[0] = p.blocks;
  out[1] = p.most;
  out[2] = (int)flight;
  return 0;
}

}  // extern "C"
