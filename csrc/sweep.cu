// The position-parallel sweep seeding engine for Hopper (sm_90a): its
// per-lane forward extension and pass 3's merged stage, each whole in one
// launch with no host synchronisation inside.
// - sweep_extend_kernel: the forward extension from every (read, start
//   column) lane, optionally started from the FMA ladder table;
// - seed_strategy_merged_kernel: pass 3 from those records, its column
//   glue and its restart chain together.
// Each replaces code of bwa_mem_scale_tpu/ops/smem.py, through the port's
// plain versions in ops/smem.py (lockstep loops with a host
// synchronisation every 8 ticks, tens of small PyTorch launches a tick,
// and the merged stage's glue as torch operations). Every output equals
// the plain version's, bit for bit.
//
// What bounds the sweep on this card: chains of dependent loads, as for
// every FM walk of the port (csrc/smem.cu's note). A lane's steps depend
// on one another (each step's checkpoint rows come from the previous
// interval), 0.224 us a dependent row load on the 4.6 Mbp table in L2 on
// an NVIDIA H100 80GB HBM3 at 700 W (probe B, PERF.md section 6). The
// sweep does many more steps than the one-hot machine (each start column
// walks to the first mismatch after it), but its lanes are independent:
// there is no interval stack and no restart chain inside the walk, so the
// longest lane (at most L - K steps) sets the floor and the rest run side
// by side. The bytes a launch moves (64 a step) take microseconds at 3.35
// TB/s. So the design keeps every other load off the chain: the read's
// codes are staged into shared memory once a block, and each lane's FMA
// start is one read of its K-mer's ladder row.
//
// ---- sweep_extend_kernel
// Replaces bwa_mem_scale_tpu/ops/smem.py:109 extend_all_positions (its
// loop at :295, body :196) with ops/fma.py:128 fast_forward as each
// lane's start, through ops/smem.py::extend_all_positions. Lane (b, p), p
// < NP: without the table, from the 1-bp interval of column p (with
// check_initial it must hold >= mi[b] occurrences); with it, the first
// K_eff steps from row km of the ladders, km the K-mer at p (N bases and
// columns past L clipped to 3): j* is the leading ladder entries >= mi
// (check_initial) among the first `cap` columns that are bases inside the
// read, E = p + j*, the interval the ladder's entry j* - 1, and the lane
// goes on only if j* = K_eff and p + K_eff < len; a lane with j* < cap
// stopped on a size (died_s). Then one forward step a column j = p + off
// + t (off = K_eff - 1, or 0): an N or the read's end retires the lane
// with no record; a size below mi (with stop_min_len, only once j - p + 1
// >= stop_min_len) retires it with the failing interval recorded
// (fail_*, and died_s when merged); otherwise E = j + 1. Merged with pass
// 3 (p3_max_intv, p3_stop > 0), the first step with off + t + 1 >=
// p3_stop whose size falls below p3_max_intv is recorded (f3_*), whether
// the lane goes on or not. The lockstep advances every lane by one shared
// t; here each lane runs its own t, which gives each lane the same j and
// the same records, since no lane's state reads another's. The k-step
// form (KS = 2, int32 layout only; the JAX loop's `body2`, :236-290, with
// a k-gram table, csrc/fmi_step.cuh ext_k) takes two columns a row fetch
// after the FMA start: the second only where the first keeps the lane,
// every record (fail, f3, died, E) evaluated at the depth where it falls;
// a fourth int plane holds each lane's row fetches.
// Design: one block a read (row), its codes staged into dynamic shared
// memory as bytes (stage_codes), one thread a start column, min(256,
// NP rounded up to 32) threads a block striding over the columns. A
// warp's lanes are 32 neighbouring columns: lanes before a mismatch stop
// near it, lanes after it run on, so a warp runs as long as its longest
// lane (the divergence the per-lane steps show; a later redesign can pack
// lanes by length). Outputs [3][B][NP] int (E, f3_E, steps), [9][B][NP] P
// (k, l, s, fail_k, fail_l, fail_ss, f3_k, f3_l, f3_ss) and [4][B][NP]
// bytes (fail_s, f3_s, died_s, valid), every slot written.
//
// ---- seed_strategy_merged_kernel
// Replaces bwa_mem_scale_tpu/ops/smem.py:468 smems_seed_strategy_merged
// whole: its column glue (:479-505: first_inv by a cummin, limit, s1 from
// the C array, died / zombie / zfail, E3, emit_col, nxt) and its restart
// chain (the loop at :527), through ops/smem.py::
// smems_seed_strategy_merged, whose body on CPU tensors is the plain
// version (the glue as torch operations, then ops/smem.py::strategy_chase).
// A warp a read, MERGED_WARPS warps a block (fewer where a long read's
// shared memory needs it), no barrier between warps:
// 1. The warp stages the C array (five values; bit a of `empty` says base
//    a occurs nowhere, s1 == 0) and two masks of the read's columns, one
//    32-bit word each 32 columns by __ballot_sync: invalid (a code >= 4,
//    or at or past len, or past L) and zero-count (a valid base that
//    occurs nowhere). first_inv(p), the cummin's value, is the first set
//    bit at or after p: __ffs on the masked word, then the next words.
// 2. From column 0, while pos < len and pos < P, the warp evaluates at
//    the column it visits what the glue evaluates there (base_ok from the
//    mask, died, f3, zombie, limit only for a zombie, zfail, E3, emit_col,
//    fail3, hit_n, nxt with max(nxt, pos + 1)) and moves to nxt. It loads
//    that column's five records from device memory, all at once. Each emission keeps its column in shared memory; the
//    count grows past M, and an emission past M is dropped.
// 3. The warp writes the read's M slots of the five fields, each slot
//    once, lanes on neighbouring slots: slot j < min(cnt, M) gets (col,
//    f3_E, f3_k, f3_l, f3_ss) of its column (E3 is f3_E where a column
//    emits), every later slot zero. Then cnt and steps (the lockstep's
//    count of chase iterations).
// With stats, each block adds its reads' longest and total steps to two
// device counters (chase_steps, chase_total) through a running maximum
// and a self-resetting ticket: the grid's last block adds the launch's
// longest, so no operation is needed outside the launch.
// What bounds it: the bytes (the codes read once, each visited column's
// records, the five [B, M] planes and cnt / steps written once) over 3.35
// TB/s are about a microsecond at phase 9's batch; above that sits a
// latency floor of one device-memory trip for the read's data and then
// the longest read's chase steps, each at least a warp's dependent round
// (tools/round_cost.py). Each step here waits on a trip for its column's
// records, but a chase is a few steps (5 on phase 5's batch) and reads no
// column it does not visit. A form that first staged the read's P
// columns' records in shared memory (a round a step) took the same time
// at int32 and more at int64 on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md
// section 6), and was dropped. The shared memory (the masks and
// min(M, P) emitted columns a warp) fits any read below ~55,000 columns.
//
// ---- the int64 forms
// Each kernel is a template on its position type P (int, long long), and
// the sweep also on its bases a fetch KS, as in csrc/smem.cu; the launch
// functions ending in 64 launch the long long forms on the int64 layout
// of ops/occ.py (the ladders at int64 too).

#include "fmi_step.cuh"

namespace {

constexpr int SWEEP_BLOCK = 256;     // the most threads a sweep block takes
constexpr int MERGED_WARPS = 8;      // reads (warps) a merged-stage block

template <int KS, typename P>
__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_extend_kernel(Fmi<P> f, Kfmi g,
                    const int32_t* __restrict__ codes,         // [B, L]
                    const int32_t* __restrict__ lens,           // [B]
                    const int32_t* __restrict__ mis,            // [B]
                    int B, int L, int NP, int check_initial,
                    int stop_min_len, int p3_max_intv, int p3_stop,
                    const P* __restrict__ lad_k,   // [4^K, K] or null
                    const P* __restrict__ lad_l,
                    const P* __restrict__ lad_s, int K, int K_eff,
                    int32_t* __restrict__ out_i,   // [3 | 4][B][NP]
                    P* __restrict__ out_p,         // [9][B][NP]
                    uint8_t* __restrict__ out_b) {  // [4][B][NP]
  extern __shared__ int4 smem[];
  int8_t* q = reinterpret_cast<int8_t*>(smem);     // the read's codes
  const int b = blockIdx.x;
  const int len = lens[b];
  const P mi = (P)mis[b];
  const bool merge = p3_max_intv > 0 && p3_stop > 0;
  stage_codes(codes + (size_t)b * L, L, q, threadIdx.x, blockDim.x);
  __syncthreads();
  auto code = [&](int i) { return i < L ? (int)q[i] : 4; };
  auto clip = [](int c) { return c < 0 ? 0 : (c > 3 ? 3 : c); };
  const size_t plane = (size_t)B * NP;
  for (int p = threadIdx.x; p < NP; p += blockDim.x) {
    const int c0 = code(p);
    const bool base_ok = p < len && c0 < 4;
    P k = 0, l = 0, s = 0;
    int E, off, steps = 0;
    bool act, died = false;
    if (K_eff) {                     // the FMA start: the K-mer's row
      int cap = 0;
      bool lead = true;
      size_t km = 0;
      for (int i = 0; i < K; ++i) {
        const int c = code(p + i);
        if (i < K_eff) {
          lead = lead && c >= 0 && c < 4 && p + i < len;
          cap += lead;
        }
        km = 4 * km + clip(c);
      }
      const size_t row = km * K;
      int jstar = cap;
      if (check_initial) {
        jstar = 0;
        while (jstar < cap && __ldg(lad_s + row + jstar) >= mi) ++jstar;
      }
      if (jstar > 0) {
        k = __ldg(lad_k + row + jstar - 1);
        l = __ldg(lad_l + row + jstar - 1);
        s = __ldg(lad_s + row + jstar - 1);
      }
      E = p + jstar;
      act = jstar == K_eff && p + K_eff < len;
      died = merge && jstar < cap;
      off = K_eff - 1;
    } else {                         // the 1-bp interval of column p
      const int a0 = clip(c0);
      k = cval(f, a0);
      l = cval(f, 3 - a0);
      s = cval(f, a0 + 1) - k;
      act = base_ok && (!check_initial || s >= mi);
      if (!act) k = l = s = 0;
      E = act ? p + 1 : p;
      off = 0;
    }
    bool fs = false, f3s = false;
    P fk = 0, fl = 0, fss = 0, f3k = 0, f3l = 0, f3ss = 0;
    int f3E = 0, t = 1, rounds = 0;
    // the step at column j (the lane's t-th), its extension (nk, nl, ns)
    // made: the pass-3 record, then a size failure (false: the lane
    // retires) or the match grown to j + 1
    auto take = [&](int j, P nk, P nl, P ns) {
      ++steps;
      if (merge && !f3s && ns < (P)p3_max_intv && off + t + 1 >= p3_stop) {
        f3s = true;
        f3E = j;
        f3k = nk;
        f3l = nl;
        f3ss = ns;
      }
      if (ns < mi && (stop_min_len <= 0 || j - p + 1 >= stop_min_len)) {
        fs = true;                               // a size failure
        fk = nk;
        fl = nl;
        fss = ns;
        died = died || merge;
        return false;
      }
      E = j + 1;
      k = nk;
      l = nl;
      s = ns;
      ++t;
      return true;
    };
    while (act) {                    // KS forward steps a row fetch
      const int j = p + off + t;
      const int a = code(j);
      if (j >= len || a >= 4) break;           // an N or the read's end
      ++rounds;
      if constexpr (KS == 1) {
        P nk, nl, ns;
        ext(f, l, k, s, 3 - clip(a), nl, nk, ns);  // the swapped interval
        act = take(j, nk, nl, ns);
      } else {
        // a walk that ends after the first base keeps its records
        const int b2 = code(j + 1);
        int ch[2] = {3 - a, 3 - clip(b2)}, bk[2], bl[2], bs[2];
        ext_k<2>(f, g, l, k, s, ch, bk, bl, bs);   // the swapped interval
        act = take(j, bl[0], bk[0], bs[0]) && j + 1 < len && b2 < 4
              && take(j + 1, bl[1], bk[1], bs[1]);
      }
    }
    const size_t o = (size_t)b * NP + p;
    out_i[o] = E;
    out_i[plane + o] = f3E;
    out_i[2 * plane + o] = steps;
    if constexpr (KS > 1) out_i[3 * plane + o] = rounds;
    const P vals[9] = {k, l, s, fk, fl, fss, f3k, f3l, f3ss};
#pragma unroll
    for (int i = 0; i < 9; ++i) out_p[i * plane + o] = vals[i];
    out_b[o] = fs;
    out_b[plane + o] = f3s;
    out_b[2 * plane + o] = died;
    out_b[3 * plane + o] = base_ok;
  }
}

// The first invalid column at or after p (L when there is none): the
// read's invalid mask, W words, bits past L set.
__device__ __forceinline__ int first_invalid(const uint32_t* inv, int W,
                                             int L, int p) {
  int i = p >> 5;
  uint32_t m = inv[i] & (~0u << (p & 31));
  while (m == 0 && ++i < W) m = inv[i];
  return m ? min(L, i * WARP + __ffs(m) - 1) : L;
}

// 32-bit words of shared memory a warp of the merged stage takes: the two
// column masks and the emitted columns
__host__ __device__ __forceinline__ size_t merged_words(int L, int NP,
                                                       int M) {
  const size_t W = ((size_t)L + WARP - 1) / WARP;
  const size_t n = 2 * W + (size_t)(M < NP ? M : NP);
  return (n + 3) & ~(size_t)3;                 // 16-byte aligned
}

template <typename P>
__global__ void __launch_bounds__(MERGED_WARPS * WARP)
seed_strategy_merged_kernel(const P* __restrict__ count,       // [5]
                            const int32_t* __restrict__ codes,  // [B, L]
                            const int32_t* __restrict__ lens,   // [B]
                            const uint8_t* __restrict__ died_s,  // [B, NP]
                            const uint8_t* __restrict__ f3_s,
                            const int32_t* __restrict__ f3_E,
                            const int32_t* __restrict__ Ecol,
                            const P* __restrict__ f3k,
                            const P* __restrict__ f3l,
                            const P* __restrict__ f3ss,
                            int B, int L, int NP, int stop_min_len, int M,
                            int32_t* __restrict__ out,  // [2][B][M] m n,
                                                        // [3][B][M] P k l s
                            int32_t* __restrict__ cnt_out,    // [B]
                            int32_t* __restrict__ steps_out,  // [B]
                            unsigned long long* __restrict__ acc_steps,
                            unsigned long long* __restrict__ acc_total,
                            unsigned long long* __restrict__ run) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  const int b = blockIdx.x * (blockDim.x / WARP) + w;
  const int W = (L + WARP - 1) / WARP;
  int steps = 0;
  if (b < B) {
    uint32_t* inv = reinterpret_cast<uint32_t*>(smem)
                    + merged_words(L, NP, M) * w;
    uint32_t* zero = inv + W;
    int32_t* em = reinterpret_cast<int32_t*>(zero + W);   // [min(M, NP)]
    // bit a: base a occurs nowhere (s1 = C[a + 1] - C[a] = 0)
    const P cv = lane < 5 ? count[lane] : (P)0;
    const P cn = __shfl_down_sync(FULL, cv, 1);
    const unsigned empty = __ballot_sync(FULL, lane < 4 && cn == cv);
    const int len = lens[b];
    const int32_t* crow = codes + (size_t)b * L;
#pragma unroll 4
    for (int i = 0; i < W; ++i) {
      const int col = i * WARP + lane;
      const int c = col < L ? crow[col] : 4;
      const bool bad = c >= 4 || col >= len;
      const int a = c < 0 ? 0 : (c > 3 ? 3 : c);
      const unsigned mi = __ballot_sync(FULL, bad);
      const unsigned mz = __ballot_sync(FULL, !bad && ((empty >> a) & 1));
      if (lane == 0) {
        inv[i] = mi;
        zero[i] = mz;
      }
    }
    const size_t row = (size_t)b * NP;
    __syncwarp();
    int pos = 0, cnt = 0;
    while (pos < len && pos < NP) {            // warp-uniform
      ++steps;
      const size_t o = row + pos;
      const int fl =
          (died_s[o] ? 1 : 0) | (f3_s[o] ? 2 : 0) | (f3ss[o] > 0 ? 4 : 0);
      const int e3f = f3_E[o];
      const int e0 = Ecol[o];
      const bool base_ok = !((inv[pos >> 5] >> (pos & 31)) & 1);
      const bool f3 = fl & 2;
      const bool died = (fl & 1) || ((zero[pos >> 5] >> (pos & 31)) & 1);
      const bool zombie = base_ok && died && !f3;
      bool zfail = false;
      int E3 = e0;
      if (f3) {
        E3 = e3f;
      } else if (zombie) {                     // its end reckoned, not walked
        const int limit = first_invalid(inv, W, L, pos) - pos;
        zfail = stop_min_len <= limit;
        E3 = pos + (zfail ? stop_min_len - 1 : limit);
      }
      if (base_ok && f3 && (fl & 4)) {         // emit_col
        if (cnt < M && lane == 0) em[cnt] = pos;
        ++cnt;
      }
      const bool fail3 = f3 || zfail;
      const bool hit_n = base_ok && !fail3 && E3 < len;
      const int nxt = base_ok ? ((fail3 || hit_n) ? E3 + 1 : len) : pos + 1;
      pos = max(nxt, pos + 1);
    }
    __syncwarp();
    const int kept = min(cnt, M);
    const size_t bm = (size_t)B * M, orow = (size_t)b * M;
    P* kls = reinterpret_cast<P*>(out + 2 * bm);
    for (int j = lane; j < M; j += WARP) {     // each slot once
      int m = 0, n = 0;
      P k = 0, l = 0, s = 0;
      if (j < kept) {
        const int col = em[j];
        const size_t o = row + col;
        m = col;
        n = f3_E[o];
        k = f3k[o];
        l = f3l[o];
        s = f3ss[o];
      }
      out[orow + j] = m;
      out[bm + orow + j] = n;
      kls[orow + j] = k;
      kls[bm + orow + j] = l;
      kls[2 * bm + orow + j] = s;
    }
    if (lane == 0) {
      cnt_out[b] = cnt;
      steps_out[b] = steps;
    }
  }
  if (acc_steps != nullptr) {                  // the stats, grid-uniform
    __shared__ unsigned long long bmax, bsum;
    if (threadIdx.x == 0) bmax = bsum = 0;
    __syncthreads();
    if (lane == 0 && b < B) {
      atomicMax(&bmax, (unsigned long long)steps);
      atomicAdd(&bsum, (unsigned long long)steps);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicMax(run, bmax);
      atomicAdd(acc_total, bsum);
      __threadfence();
      // run[1]'s low word: blocks done, back to 0 after the last
      const unsigned t = atomicInc(reinterpret_cast<unsigned*>(run + 1),
                                   gridDim.x - 1);
      if (t == gridDim.x - 1) atomicAdd(acc_steps, atomicExch(run, 0ull));
    }
  }
}

// threads a sweep block: NP rounded up to a warp, at most SWEEP_BLOCK
int sweep_threads(int NP) {
  const int t = (NP + WARP - 1) / WARP * WARP;
  return t < SWEEP_BLOCK ? t : SWEEP_BLOCK;
}

template <int KS, typename P>
int sweep_extend_launch_t(const Fmi<P>& f, const Kfmi& g, const void* codes,
                          const void* lens, const void* mis, int B, int L,
                          int NP, int check_initial, int stop_min_len,
                          int p3_max_intv, int p3_stop, const void* lad_k,
                          const void* lad_l, const void* lad_s, int K,
                          int K_eff, void* out_i, void* out_p, void* out_b,
                          void* stream) {
  if (B <= 0 || NP <= 0) return 0;
  const size_t bytes = codes_bytes(L);
  const bool fma_ok = K_eff == 0
      || (K_eff >= 2 && K_eff <= K && K <= 15 && lad_k && lad_l && lad_s);
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || L <= 0 || NP > L
      || bytes > SMEM_MAX || !fma_ok)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(sweep_extend_kernel<KS, P>, bytes);
  if (e != cudaSuccess) return (int)e;
  sweep_extend_kernel<KS, P><<<B, sweep_threads(NP), bytes,
                               (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, (const int32_t*)mis,
      B, L, NP, check_initial, stop_min_len, p3_max_intv, p3_stop,
      (const P*)lad_k, (const P*)lad_l, (const P*)lad_s, K, K_eff,
      (int32_t*)out_i, (P*)out_p, (uint8_t*)out_b);
  return (int)cudaGetLastError();
}

template <typename P>
int seed_strategy_merged_launch_t(
    const void* count, const void* codes, const void* lens,
    const void* died_s, const void* f3_s, const void* f3_E, const void* E,
    const void* f3k, const void* f3l, const void* f3ss, int B, int L,
    int NP, int stop_min_len, int M, void* out, void* cnt, void* steps,
    void* acc_steps, void* acc_total, void* run, void* stream) {
  if (B <= 0) return 0;
  if (L <= 0 || NP <= 0 || NP > L || M < 0
      || (acc_steps != nullptr && (acc_total == nullptr || run == nullptr)))
    return (int)cudaErrorInvalidValue;
  const size_t per = 4 * merged_words(L, NP, M);
  if (per > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int wpb = per * MERGED_WARPS <= SMEM_MAX ? MERGED_WARPS
                                                 : (int)(SMEM_MAX / per);
  const size_t bytes = per * wpb;
  auto kernel = seed_strategy_merged_kernel<P>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + wpb - 1) / wpb, wpb * WARP, bytes, (cudaStream_t)stream>>>(
      (const P*)count, (const int32_t*)codes, (const int32_t*)lens,
      (const uint8_t*)died_s, (const uint8_t*)f3_s, (const int32_t*)f3_E,
      (const int32_t*)E, (const P*)f3k, (const P*)f3l, (const P*)f3ss, B, L,
      NP, stop_min_len, M, (int32_t*)out, (int32_t*)cnt, (int32_t*)steps,
      (unsigned long long*)acc_steps, (unsigned long long*)acc_total,
      (unsigned long long*)run);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch sweep_extend_kernel on `stream` over B rows (one block each) and
// their first NP start columns; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for a shape it cannot take. K_eff = 0
// runs without the ladder table (its pointers may be null), else 2 <=
// K_eff <= K <= 15. The caller allocates every buffer (the kernel writes
// every output slot) and checks shapes and types; nothing here
// synchronises.
extern "C" int sweep_extend_launch(const void* cp_fused, int nb, int c0,
                                   int c1, int c2, int c3, int c4,
                                   int sentinel, const void* codes,
                                   const void* lens, const void* mis, int B,
                                   int L, int NP, int check_initial,
                                   int stop_min_len, int p3_max_intv,
                                   int p3_stop, const void* lad_k,
                                   const void* lad_l, const void* lad_s,
                                   int K, int K_eff, void* out_i,
                                   void* out_p, void* out_b, void* stream) {
  return sweep_extend_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{}, codes,
      lens, mis, B, L, NP, check_initial, stop_min_len, p3_max_intv, p3_stop,
      lad_k, lad_l, lad_s, K, K_eff, out_i, out_p, out_b, stream);
}

// sweep_extend_launch's k-step form (int32 layout only): two bases a row
// fetch from the k-gram table `cpk` ([nb][w4] int4, ops/occ.py::
// kstep_rows; a trigram table's bigram groups) with its C2 [16] table on
// the device, after the FMA start where K_eff > 0; out_i [4][B][NP] (E,
// f3_E, steps, and each lane's row fetches).
extern "C" int sweep_extend_launch_k(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* cpk, int w4, const void* c2k,
    const void* codes, const void* lens, const void* mis, int B, int L,
    int NP, int check_initial, int stop_min_len, int p3_max_intv,
    int p3_stop, const void* lad_k, const void* lad_l, const void* lad_s,
    int K, int K_eff, void* out_i, void* out_p, void* out_b, void* stream) {
  return sweep_extend_launch_t<2>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel),
      make_kfmi(cpk, nb, w4, c2k, nullptr), codes, lens, mis, B, L, NP,
      check_initial, stop_min_len, p3_max_intv, p3_stop, lad_k, lad_l, lad_s,
      K, K_eff, out_i, out_p, out_b, stream);
}

// sweep_extend_launch's int64 form: the index at 64 bits with its
// high-word step table `hi` and steps h0-h3 a base (csrc/smem.cu's
// one_pos_launch64), int64 ladders, out_p [9][B][NP] int64.
extern "C" int sweep_extend_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* codes,
    const void* lens, const void* mis, int B, int L, int NP,
    int check_initial, int stop_min_len, int p3_max_intv, int p3_stop,
    const void* lad_k, const void* lad_l, const void* lad_s, int K,
    int K_eff, void* out_i, void* out_p, void* out_b, void* stream) {
  return sweep_extend_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{}, codes, lens, mis, B, L, NP, check_initial, stop_min_len,
      p3_max_intv, p3_stop, lad_k, lad_l, lad_s, K, K_eff, out_i, out_p,
      out_b, stream);
}

// Launch seed_strategy_merged_kernel on `stream` over B reads (a warp
// each): count [5] and the records f3k, f3l, f3ss [B, NP] of the position
// type (int32 here, int64 in seed_strategy_merged_launch64), codes [B, L]
// and lens [B] int32, died_s and f3_s [B, NP] bytes, f3_E and E [B, NP]
// int32; out [2][B][M] int32 then [3][B][M] of the position type, cnt
// and steps [B] int32. With acc_steps, acc_total (one uint64 each) and run (two uint64, zero when first used,
// left zero by every launch) the launch adds its longest and total steps
// to the two counters; all three null for none. The return and the caller's duties as
// sweep_extend_launch.
extern "C" int seed_strategy_merged_launch(
    const void* count, const void* codes, const void* lens,
    const void* died_s, const void* f3_s, const void* f3_E, const void* E,
    const void* f3k, const void* f3l, const void* f3ss, int B, int L,
    int NP, int stop_min_len, int M, void* out, void* cnt, void* steps,
    void* acc_steps, void* acc_total, void* run, void* stream) {
  return seed_strategy_merged_launch_t<int>(
      count, codes, lens, died_s, f3_s, f3_E, E, f3k, f3l, f3ss, B, L, NP,
      stop_min_len, M, out, cnt, steps, acc_steps, acc_total, run, stream);
}

extern "C" int seed_strategy_merged_launch64(
    const void* count, const void* codes, const void* lens,
    const void* died_s, const void* f3_s, const void* f3_E, const void* E,
    const void* f3k, const void* f3l, const void* f3ss, int B, int L,
    int NP, int stop_min_len, int M, void* out, void* cnt, void* steps,
    void* acc_steps, void* acc_total, void* run, void* stream) {
  return seed_strategy_merged_launch_t<long long>(
      count, codes, lens, died_s, f3_s, f3_E, E, f3k, f3l, f3ss, B, L, NP,
      stop_min_len, M, out, cnt, steps, acc_steps, acc_total, run, stream);
}
