// The position-parallel sweep seeding engine for Hopper (sm_90a): its two
// per-lane, data-dependent loops, each whole in one launch with no host
// synchronisation inside.
// - sweep_extend_kernel: the forward extension from every (read, start
//   column) lane, optionally started from the FMA ladder table;
// - strategy_chase_kernel: pass 3's restart chain over those records.
// Each replaces a jax.lax.while_loop of bwa_mem_scale_tpu/ops/smem.py,
// through the port's lockstep counterparts in ops/smem.py (a host
// synchronisation every 8 ticks, tens of small PyTorch launches a tick).
// Every output equals the lockstep's, bit for bit.
//
// What bounds them on this card: chains of dependent loads, as for every
// FM walk of the port (csrc/smem.cu's note). A lane's steps depend on one
// another (each step's checkpoint rows come from the previous interval),
// 0.224 us a dependent row load on the 4.6 Mbp table in L2 on an NVIDIA
// H100 80GB HBM3 at 700 W (probe B, PERF.md section 6). The sweep does
// many more steps than the one-hot machine (each start column walks to
// the first mismatch after it), but its lanes are independent: there is
// no interval stack and no restart chain inside the walk, so the longest
// lane (at most L - K steps) sets the floor and the rest run side by
// side. The bytes a launch moves (64 a step) take microseconds at 3.35
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
// ---- strategy_chase_kernel
// Replaces bwa_mem_scale_tpu/ops/smem.py:468 smems_seed_strategy_merged's
// restart chain (loop :527), through ops/smem.py::strategy_chase: each
// read chases nxt from column 0 while pos < len and pos < NP, emitting
// (pos, E3, f3_k, f3_l, f3_ss) where `emit` holds; an emission past M is
// dropped and the count still grows. One thread a read (a read's chain is
// one dependent walk of a few steps), one warp a block: the warp first
// zeroes its 32 reads' SmemBuf rows together (one contiguous stretch a
// field, neighbouring lanes on neighbouring words), then each lane chases
// its read and writes its emissions. The first form had each lane write
// its own row, zeros past its count, one word a store at 32 rows apart:
// 0.0214 ms on phase 5's batch for a walk of at most 5 steps (PERF.md
// section 6). nxt > pos always (the glue makes it so); a step to nxt <=
// pos would still move on by one, so no input can hang the kernel.
//
// ---- the int64 forms
// Each kernel is a template on its position type P (int, long long), and
// the sweep also on its bases a fetch KS, as in csrc/smem.cu; the launch
// functions ending in 64 launch the long long forms on the int64 layout
// of ops/occ.py (the ladders at int64 too).

#include "fmi_step.cuh"

namespace {

constexpr int SWEEP_BLOCK = 256;     // the most threads a sweep block takes
constexpr int CHASE_BLOCK = 32;      // reads (threads) a chase block

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

template <typename P>
__global__ void __launch_bounds__(CHASE_BLOCK)
strategy_chase_kernel(const uint8_t* __restrict__ emit,   // [B, NP]
                      const int32_t* __restrict__ E3,     // [B, NP]
                      const int32_t* __restrict__ nxt,    // [B, NP]
                      const P* __restrict__ f3k,          // [B, NP]
                      const P* __restrict__ f3l,
                      const P* __restrict__ f3ss,
                      const int32_t* __restrict__ lens,   // [B]
                      int B, int NP, int M,
                      int32_t* __restrict__ out,   // [2][B][M] m n, then
                                                   // [3][B][M] P: k l s
                      int32_t* __restrict__ cnt_out,      // [B]
                      int32_t* __restrict__ steps_out) {  // [B]
  const int b0 = blockIdx.x * CHASE_BLOCK;
  const int b = b0 + threadIdx.x;
  const int nr = min(CHASE_BLOCK, B - b0);
  const size_t bm = (size_t)B * M;                 // one output field
  P* kls = reinterpret_cast<P*>(out + 2 * bm);
  for (int i = threadIdx.x; i < nr * M; i += CHASE_BLOCK) {  // the rows
    const size_t o = (size_t)b0 * M + i;
    out[o] = 0;
    out[bm + o] = 0;
    kls[o] = 0;
    kls[bm + o] = 0;
    kls[2 * bm + o] = 0;
  }
  __syncthreads();               // the zeros before any emission
  if (b >= B) return;
  const size_t row = (size_t)b * NP, orow = (size_t)b * M;
  const int len = lens[b];
  int pos = 0, cnt = 0, steps = 0;
  while (pos < len && pos < NP) {
    ++steps;
    if (emit[row + pos]) {
      if (cnt < M) {
        out[orow + cnt] = pos;
        out[bm + orow + cnt] = E3[row + pos];
        kls[orow + cnt] = f3k[row + pos];
        kls[bm + orow + cnt] = f3l[row + pos];
        kls[2 * bm + orow + cnt] = f3ss[row + pos];
      }
      ++cnt;
    }
    const int n = nxt[row + pos];
    pos = n > pos ? n : pos + 1;
  }
  cnt_out[b] = cnt;
  steps_out[b] = steps;
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
int strategy_chase_launch_t(const void* emit, const void* E3,
                            const void* nxt, const void* f3k,
                            const void* f3l, const void* f3ss,
                            const void* lens, int B, int NP, int M,
                            void* out, void* cnt, void* steps,
                            void* stream) {
  if (B <= 0) return 0;
  if (NP <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  strategy_chase_kernel<P><<<(B + CHASE_BLOCK - 1) / CHASE_BLOCK,
                             CHASE_BLOCK, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)emit, (const int32_t*)E3, (const int32_t*)nxt,
      (const P*)f3k, (const P*)f3l, (const P*)f3ss, (const int32_t*)lens, B,
      NP, M, (int32_t*)out, (int32_t*)cnt, (int32_t*)steps);
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

// Launch strategy_chase_kernel on `stream` over B reads; out [2][B][M]
// int32 then [3][B][M] of the records' type (int32 here, int64 in
// strategy_chase_launch64); the return and the caller's duties as
// sweep_extend_launch.
extern "C" int strategy_chase_launch(const void* emit, const void* E3,
                                     const void* nxt, const void* f3k,
                                     const void* f3l, const void* f3ss,
                                     const void* lens, int B, int NP, int M,
                                     void* out, void* cnt, void* steps,
                                     void* stream) {
  return strategy_chase_launch_t<int>(emit, E3, nxt, f3k, f3l, f3ss, lens,
                                      B, NP, M, out, cnt, steps, stream);
}

extern "C" int strategy_chase_launch64(const void* emit, const void* E3,
                                       const void* nxt, const void* f3k,
                                       const void* f3l, const void* f3ss,
                                       const void* lens, int B, int NP,
                                       int M, void* out, void* cnt,
                                       void* steps, void* stream) {
  return strategy_chase_launch_t<long long>(emit, E3, nxt, f3k, f3l, f3ss,
                                            lens, B, NP, M, out, cnt, steps,
                                            stream);
}
