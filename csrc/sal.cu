// The SA lookup stage for Hopper (sm_90a): the whole of expand_and_lookup
// (every SMEM's SA interval sampled into at most max_occ coordinates, each
// coordinate resolved by the LF walk) in two launches on the caller's
// stream, with no host synchronisation and no tensor operation between
// them.
//
// Replaces bwa_mem_scale_tpu/ops/sal.py:116 expand_and_lookup and the walk
// of bwa_mem_scale_tpu/ops/sal.py:23 sa_lookup, through
// ops/sal.py::expand_and_lookup_plain (the port's earlier stage: its tensor
// glue around csrc/smem.cu's sa_walk_kernel). Every output slot equals the
// plain version's, slots that are not valid included:
// - an SMEM's step is s // max_occ for s > max_occ, else 1; its count is
//   min(ceil(s / step), max_occ), or min(s, max_occ); SMEMs at or past a
//   read's cnt count 0;
// - starts are the exclusive running sum of the counts; total =
//   min(sum, C) and overflow = sum > C;
// - seed_idx[b, c] is the last SMEM with a nonzero count whose start is at
//   or before c (forward-filled past total), 0 where there is none;
//   coord_valid = c < total;
// - a coordinate's row is k + (c - start) * step; rbeg is its walk's value
//   where walked, 0 elsewhere;
// - with B * C <= K (K = flat_k, or B * C / 16 rounded up to 1024 and at
//   least 4096) every valid slot is walked (the grid path); else the valid
//   slots of all reads, read after read, form a flat list of which the
//   first K are walked, and a read with a coordinate past K and total > 0
//   overflows.
//
// What bounds it on this card. Bytes: the SMEM records read once (cnt, and
// s of each SMEM below its read's count, for the counts; k of each SMEM
// that owns a walked slot), the five outputs written
// once (rbeg at the positions' width, seed_idx 4 bytes, coord_valid 1, a
// slot; total 4 and overflow 1 a read), and the walk's 32-byte checkpoint
// rows and samples: at B = C = 512, int32, ~2.4 MB of outputs and ~0.6 MB
// of rows, ~0.0009 ms at 3.35 TB/s. Latency: the walk is geometric (a row
// is sampled with p = 2^-compx), and its longest lane's rows are a chain
// of dependent L2 trips (0.224 us each on the 4.6 Mbp table, probe B,
// PERF.md section 6: ~72 rows, 0.016 ms, on the main path's batch), after
// the first launch (its look-back included). That chain, not bytes, is the
// floor. The stage before this kernel was 74 tensor operations a batch
// around one walk launch (~1.2-1.5 ms of host dispatch against 0.023 ms of
// walk), so the design's first aim is that nothing but the two launches
// and the outputs' allocations happen on the host.
//
// Design.
// - sal_count_kernel, a warp a read (4 reads a 128-thread block, fewer
//   where M is large): the read's SMEMs 32 at a time, each lane one SMEM's
//   step and count; a shuffle scan of the counts gives the starts (kept in
//   shared memory and in a [B][M] scratch for the walk), a ballot the last
//   SMEM with a nonzero count. Then the read's C slots, a lane a slot:
//   seed_idx by a binary search of the starts for c < total (the last start
//   at or before c; its count is nonzero, since the next start lies past
//   c), the last nonzero SMEM for c >= total (every start lies at or before
//   such a slot); coord_valid; and 0 into rbeg for c >= total, which no walk
//   writes. Lane 0 writes total and overflow.
// - On the flat path the same launch places every valid slot in the flat
//   list, so that the walk needs no search over reads: a single-pass scan
//   of the blocks' totals by decoupled look-back (a block publishes its sum,
//   and warp 0 sums its predecessors' published words, 32 a step, back to
//   the nearest inclusive one, then publishes its own inclusive sum; blocks
//   are dispatched in index order, so a block waits only on running ones).
//   Each warp then knows its read's first entry: entry j < K gets the slot
//   (b * C + c) in a [K] map, a valid slot at j >= K gets rbeg 0, and a read
//   with an entry past K and total > 0 overflows; the last block writes the
//   list's length. The look-back's words live in a per-stream buffer that
//   persists across calls (ops/sal_cuda.py, zeroed once when made) and
//   carry the call's epoch, so a word from an earlier call reads as not
//   yet published and nothing is zeroed between calls: no third launch,
//   no memset, no host operation.
//   The scan is linear in B, so the stage takes any batch (B * C < 2^31).
// - sal_walk_kernel, a thread a coordinate of the flat list (the grid path:
//   a thread a slot), 128-thread blocks, so the longest lane's rows stay the
//   floor and a thread retires as it finds its sample. Which coordinates
//   are live is known only on the device, so the grid is the list's K
//   threads (as the bare walk's launch) and a thread past the list's length
//   exits at once; at the main path's ~2,700 live coordinates of 16,384 the
//   blocks past them take no SM time that the live ones wait for (all 128
//   blocks are one wave). A thread loads its slot from the map, its SMEM
//   from the seed_idx the first launch wrote (one dependent L2 trip, where a
//   search of the read's starts would take log2 M), then k, s and the start
//   side by side, and walks (csrc/sal_walk.cuh).
// - sa_compx 0 (the full SA resident) is the walk's first step, a gather.
// - Each thread writes its steps ([N]: N = K, or B * C on the grid path; 0
//   where nothing is walked), and each warp's longest goes to `longest` by
//   atomicMax (the first launch zeroes it).
// Forms: P = int (int32 positions) and long long (the int64 layout,
// sal_lookup_launch64); the index as csrc/fmi_step.cuh's Fmi<P>.

#include "sal_walk.cuh"

namespace {

constexpr int SAL_READS = 4;           // reads (warps) a counting block
constexpr int SAL_THREADS = 128;       // coordinates (threads) a walk block

// an SMEM's sampled coordinates (its count) and its step, as
// expand_and_lookup_plain computes them at the positions' width
template <typename P>
__device__ __forceinline__ P sal_step(P s, P max_occ) {
  return s > max_occ ? s / max_occ : (P)1;
}

template <typename P>
__device__ __forceinline__ int sal_count(P s, P max_occ) {
  if (s > max_occ) {
    const long long step = (long long)(s / max_occ);
    const long long n = ((long long)s + step - 1) / step;
    return (int)(n < max_occ ? n : max_occ);
  }
  return (int)(s < max_occ ? s : max_occ);
}

// A look-back word: the call's epoch (bits 63-33), 1 for an inclusive sum
// or 0 for the block's own (bit 32), the sum (bits 31-0). A word of another
// epoch is not published yet.
__device__ __forceinline__ unsigned long long lb_word(unsigned epoch,
                                                      bool inc, int v) {
  return ((unsigned long long)epoch << 33)
         | ((unsigned long long)inc << 32) | (unsigned)v;
}

__device__ __forceinline__ void lb_publish(unsigned long long* flags, int i,
                                           unsigned long long w) {
  atomicExch(flags + i, w);
}

// Warp 0's look-back for block i (> 0): the sum of every earlier block's
// reads, from the published words of blocks i - 1, i - 2, ..., 32 a step
// (lane l reads block i - 1 - l - 32 * step), to the nearest inclusive one.
__device__ int lb_exclusive(const unsigned long long* flags, int i,
                            unsigned epoch) {
  const int lane = threadIdx.x % WARP;
  int excl = 0;
  for (int top = i - 1;; top -= WARP) {
    const int p = top - lane;
    unsigned long long w = lb_word(epoch, true, 0);        // before block 0
    if (p >= 0) {
      for (;;) {
        w = *(volatile const unsigned long long*)(flags + p);
        if ((unsigned)(w >> 33) == epoch) break;
        __nanosleep(32);
      }
    }
    __syncwarp();
    const unsigned inc = __ballot_sync(FULL, (w >> 32) & 1);
    const int first = inc ? __ffs(inc) - 1 : WARP - 1;     // nearest one
    int v = lane <= first ? (int)(unsigned)w : 0;
#pragma unroll
    for (int d = WARP / 2; d > 0; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
    excl += v;
    if (inc) return excl;
  }
}

template <typename P>
__global__ void __launch_bounds__(SAL_READS * WARP)
sal_count_kernel(const P* __restrict__ s, long long s_b, long long s_m,
                 const int32_t* __restrict__ cnt, long long cnt_b, int B,
                 int M, int C, P max_occ, int R,
                 int K,                       // the flat list; 0: the grid
                 unsigned epoch,
                 unsigned long long* __restrict__ flags,  // [>= blocks]
                 int32_t* __restrict__ starts,            // [B][M]
                 int32_t* __restrict__ slot_of,           // [K]
                 int32_t* __restrict__ grand,             // [1]
                 P* __restrict__ rbeg,                    // [B][C]
                 int32_t* __restrict__ seed_idx,          // [B][C]
                 uint8_t* __restrict__ coord_valid,       // [B][C]
                 int32_t* __restrict__ total,             // [B]
                 uint8_t* __restrict__ overflow,          // [B]
                 int32_t* __restrict__ longest) {         // [1]
  // [R][M] starts, then [R] totals and the flat entries before this
  // block's reads: all dynamic, so that the bytes the launch asks for are
  // the block's whole shared memory
  extern __shared__ int32_t sh_starts[];
  int32_t* sh_tot = sh_starts + (size_t)R * M;
  int32_t& sh_base = sh_tot[R];
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  if (blockIdx.x == 0 && threadIdx.x == 0) *longest = 0;
  const int b = blockIdx.x * R + w;
  const bool live = b < B;
  int32_t* st = sh_starts + (size_t)w * M;
  int nv = 0, carry = 0, last = -1;
  if (live) {
    const int cb = __ldg(cnt + b * cnt_b);
    nv = cb < 0 ? 0 : (cb > M ? M : cb);
  }
  for (int m0 = 0; m0 < nv; m0 += WARP) {
    const int m = m0 + lane;
    const int n = m < nv ? sal_count(__ldg(s + b * s_b + m * s_m), max_occ)
                         : 0;
    int inc = n;                                  // the warp's scan
#pragma unroll
    for (int d = 1; d < WARP; d <<= 1) {
      const int u = __shfl_up_sync(FULL, inc, d);
      if (lane >= d) inc += u;
    }
    if (m < nv) {
      st[m] = carry + inc - n;
      starts[(size_t)b * M + m] = carry + inc - n;
    }
    const unsigned nz = __ballot_sync(FULL, n > 0);
    if (nz) last = m0 + WARP - 1 - __clz(nz);
    carry += __shfl_sync(FULL, inc, WARP - 1);
  }
  __syncwarp();
  const int tot = carry < C ? carry : C;
  if (K) {                                        // publish, look back
    if (lane == 0) sh_tot[w] = tot;
    __syncthreads();
    if (w == 0) {
      int agg = 0;
      for (int i = 0; i < R; ++i) agg += sh_tot[i];
      if (blockIdx.x == 0) {
        if (lane == 0) {
          lb_publish(flags, 0, lb_word(epoch, true, agg));
          sh_base = 0;
        }
      } else {
        if (lane == 0) lb_publish(flags, blockIdx.x, lb_word(epoch, false,
                                                             agg));
        const int excl = lb_exclusive(flags, blockIdx.x, epoch);
        if (lane == 0) {
          lb_publish(flags, blockIdx.x, lb_word(epoch, true, excl + agg));
          sh_base = excl;
        }
      }
      if (lane == 0 && blockIdx.x == gridDim.x - 1) *grand = sh_base + agg;
    }
  }
  if (live) {
    const int fill = last < 0 ? 0 : last;
    for (int c = lane; c < C; c += WARP) {
      const size_t o = (size_t)b * C + c;
      int sid = fill;
      if (c < tot) {                               // the last start <= c
        int lo = 0, hi = nv;
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (st[mid] <= c) lo = mid + 1;
          else hi = mid;
        }
        sid = lo - 1;
      } else {
        rbeg[o] = 0;
      }
      seed_idx[o] = sid;
      coord_valid[o] = c < tot;
    }
  }
  bool past_k = false;
  if (K) {                                         // place in the flat list
    __syncthreads();
    int first = sh_base;
    for (int i = 0; i < w; ++i) first += sh_tot[i];
    past_k = tot > 0 && first + tot > K;
    for (int c = lane; c < tot; c += WARP) {
      const int j = first + c;
      if (j < K) slot_of[j] = b * C + c;
      else rbeg[(size_t)b * C + c] = 0;
    }
  }
  if (live && lane == 0) {
    total[b] = tot;
    overflow[b] = carry > C || past_k;
  }
}

template <typename P>
__global__ void __launch_bounds__(SAL_THREADS)
sal_walk_kernel(Fmi<P> f, const P* __restrict__ samples, P n_samples,
                int compx, const P* __restrict__ k, long long k_b,
                long long k_m, const P* __restrict__ s, long long s_b,
                long long s_m, P max_occ, int B, int M, int C,
                int K,                       // the flat list; 0: the grid
                const int32_t* __restrict__ starts,       // [B][M]
                const int32_t* __restrict__ slot_of,      // [K]
                const int32_t* __restrict__ grand,        // [1]
                const int32_t* __restrict__ seed_idx,     // [B][C]
                const int32_t* __restrict__ total,        // [B]
                P* __restrict__ rbeg,                     // [B][C]
                int32_t* __restrict__ steps_out,          // [N]
                int32_t* __restrict__ longest) {          // [1]
  const int t = blockIdx.x * SAL_THREADS + threadIdx.x;
  int b = 0, c = 0;
  bool walk;
  if (K == 0) {                                   // the grid path
    b = t / C;
    c = t - b * C;
    walk = b < B && c < __ldg(total + b);
  } else {
    walk = t < K && t < __ldg(grand);
    if (walk) {
      const int o = __ldg(slot_of + t);
      b = o / C;
      c = o - b * C;
    }
  }
  int steps = 0;
  if (walk) {
    const size_t o = (size_t)b * C + c;
    const int m = __ldg(seed_idx + o);
    const int start = __ldg(starts + (size_t)b * M + m);
    const P kv = __ldg(k + b * k_b + m * k_m);
    const P step = sal_step(__ldg(s + b * s_b + m * s_m), max_occ);
    rbeg[o] = sa_walk(f, samples, n_samples, compx,
                      kv + (P)(c - start) * step, steps);
  }
  const int N = K ? K : B * C;
  if (t < N) steps_out[t] = steps;
  int most = steps;
#pragma unroll
  for (int d = WARP / 2; d > 0; d >>= 1)
    most = max(most, __shfl_xor_sync(FULL, most, d));
  if (threadIdx.x % WARP == 0 && most > 0) atomicMax(longest, most);
}

template <typename P>
int sal_lookup_launch_t(const Fmi<P>& f, const void* samples, P n_samples,
                        int compx, const void* k, long long k_b,
                        long long k_m, const void* s, long long s_b,
                        long long s_m, const void* cnt, long long cnt_b,
                        int B, int M, int C, int K, P max_occ,
                        unsigned epoch, void* flags, long long n_flags,
                        void* starts, void* slot_of, void* grand,
                        void* rbeg, void* seed_idx, void* coord_valid,
                        void* total, void* overflow, void* steps,
                        void* longest, void* stream) {
  if (B <= 0) return 0;
  const size_t row_bytes = (size_t)M * sizeof(int32_t);
  const long long N = K ? (long long)K : (long long)B * C;
  if (!fmi_ok(f) || n_samples <= 0 || compx < 0 || compx > 30 || M <= 0
      || C <= 0 || K < 0 || max_occ <= 0
      || row_bytes + (SAL_READS + 1) * sizeof(int32_t) > SMEM_MAX
      || (long long)B * C > 0x7fffffffLL
      || N > 0x7fffffffLL - SAL_THREADS || epoch == 0 || epoch >> 31)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t tail_bytes = (SAL_READS + 1) * sizeof(int32_t);
  int R = (int)((SMEM_MAX - tail_bytes) / row_bytes);
  R = R < SAL_READS ? R : SAL_READS;
  const int blocks = (B + R - 1) / R;
  if (K && n_flags < blocks) return (int)cudaErrorInvalidValue;
  const size_t bytes = R * row_bytes + tail_bytes;
  cudaError_t e = allow_smem(sal_count_kernel<P>, bytes);
  if (e != cudaSuccess) return (int)e;
  sal_count_kernel<P><<<blocks, R * WARP, bytes, st>>>(
      (const P*)s, s_b, s_m, (const int32_t*)cnt, cnt_b, B, M, C, max_occ,
      R, K, epoch, (unsigned long long*)flags, (int32_t*)starts,
      (int32_t*)slot_of, (int32_t*)grand, (P*)rbeg, (int32_t*)seed_idx,
      (uint8_t*)coord_valid, (int32_t*)total, (uint8_t*)overflow,
      (int32_t*)longest);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sal_walk_kernel<P><<<(int)((N + SAL_THREADS - 1) / SAL_THREADS),
                       SAL_THREADS, 0, st>>>(
      f, (const P*)samples, n_samples, compx, (const P*)k, k_b, k_m,
      (const P*)s, s_b, s_m, max_occ, B, M, C, K, (const int32_t*)starts,
      (const int32_t*)slot_of, (const int32_t*)grand,
      (const int32_t*)seed_idx, (const int32_t*)total, (P*)rbeg,
      (int32_t*)steps, (int32_t*)longest);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the SA lookup stage on `stream`: sal_count_kernel then
// sal_walk_kernel. k and s are [B][M] at element strides (k_b, k_m),
// (s_b, s_m), cnt [B] at stride cnt_b; K is the flat list's length, or 0
// for the grid path (B * C <= the list). `flags` holds n_flags look-back
// words (at least B on the flat path) that only this stream's calls write,
// and `epoch` (1 to 2^31 - 1) is larger than any earlier call's on them;
// a fresh buffer is zeroed. The caller allocates every other buffer: the
// starts scratch [B][M] int32, the flat list's map [K] int32 and length
// [1] int32, rbeg [B][C] of the positions' type, seed_idx [B][C] int32,
// coord_valid [B][C] bool, total [B] int32, overflow [B] bool, steps
// [K or B * C] int32 and longest [1] int32; the kernels write every
// element of the outputs. Returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a shape it cannot take; nothing here
// synchronises.
extern "C" int sal_lookup_launch(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* samples, int n_samples, int compx,
    const void* k, long long k_b, long long k_m, const void* s,
    long long s_b, long long s_m, const void* cnt, long long cnt_b, int B,
    int M, int C, int K, int max_occ, unsigned epoch, void* flags,
    long long n_flags, void* starts, void* slot_of, void* grand, void* rbeg,
    void* seed_idx, void* coord_valid, void* total, void* overflow,
    void* steps, void* longest, void* stream) {
  return sal_lookup_launch_t(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), samples,
      n_samples, compx, k, k_b, k_m, s, s_b, s_m, cnt, cnt_b, B, M, C, K,
      max_occ, epoch, flags, n_flags, starts, slot_of, grand, rbeg, seed_idx,
      coord_valid, total, overflow, steps, longest, stream);
}

// sal_lookup_launch's int64 form: the index as one_pos_launch64 takes it
// (csrc/smem.cu), int64 samples, k, s and rbeg.
extern "C" int sal_lookup_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* samples,
    long long n_samples, int compx, const void* k, long long k_b,
    long long k_m, const void* s, long long s_b, long long s_m,
    const void* cnt, long long cnt_b, int B, int M, int C, int K,
    long long max_occ, unsigned epoch, void* flags, long long n_flags,
    void* starts, void* slot_of, void* grand, void* rbeg, void* seed_idx,
    void* coord_valid, void* total, void* overflow, void* steps,
    void* longest, void* stream) {
  return sal_lookup_launch_t(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      samples, n_samples, compx, k, k_b, k_m, s, s_b, s_m, cnt, cnt_b, B, M,
      C, K, max_occ, epoch, flags, n_flags, starts, slot_of, grand, rbeg,
      seed_idx, coord_valid, total, overflow, steps, longest, stream);
}
