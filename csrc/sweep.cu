// The position-parallel sweep seeding engine for Hopper (sm_90a): its
// per-lane forward extension with passes 1 and 2's emission, and pass 3's
// merged stage, each whole in one launch with no host synchronisation
// inside.
// - sweep_extend_kernel: the forward extension from every (read, start
//   column) lane, optionally started from the FMA ladder table; in its
//   pass forms it also ranks and writes each read's SMEM slots;
// - seed_strategy_merged_kernel: pass 3 from those records, its column
//   glue and its restart chain together.
// Each replaces code of bwa_mem_scale_tpu/ops/smem.py, through the port's
// plain versions in ops/smem.py (lockstep loops with a host
// synchronisation every 8 ticks, tens of small PyTorch launches a tick,
// the emission and the merged stage's glue as torch operations). Every
// output equals the plain version's, bit for bit.
//
// ---- sweep_extend_kernel
// Replaces bwa_mem_scale_tpu/ops/smem.py:109 extend_all_positions (its
// loop at :295, body :196) with ops/fma.py:128 fast_forward as each
// lane's start, and the emission that :542 collect_smems_device (pass 1)
// and :362 smems_reseed (pass 2) run after it, through ops/smem.py::
// sweep_pass_plain (extend_all_positions with check_initial, then the
// emission).
// Lane (row, p), p < NP: without the table, from the 1-bp interval of
// column p, which must hold >= mi occurrences; with it, the first K_eff
// steps from row km of the ladders, km the K-mer at p (N bases and
// columns past L clipped to 3): j* is the leading ladder entries >= mi
// among the first `cap` columns that are bases inside the read, E = p +
// j*, the interval the ladder's entry j* - 1, and the lane goes on only
// if j* = K_eff and p + K_eff < len; a lane with j* < cap stopped on a
// size (died_s). Then one forward step a column j = p + off + t (off =
// K_eff - 1, or 0): an N or the read's end retires the lane with no
// record; a size below mi retires it (died_s when merged); otherwise E =
// j + 1. Merged with pass 3 (p3_max_intv, p3_stop > 0), the first step with
// off + t + 1 >= p3_stop whose size falls below p3_max_intv is recorded
// (f3_*), whether the lane goes on or not. The lockstep advances every
// lane by one shared t; here each lane runs its own t, which gives each
// lane the same j and the same records, since no lane's state reads
// another's. The k-step form (KS = 2, int32 layout only; the JAX loop's
// `body2`, :236-290, with a k-gram table, csrc/fmi_step.cuh ext_k) takes
// two columns a row fetch after the FMA start: the second only where the
// first keeps the lane, every record evaluated at the depth where it
// falls.
// The FMA start in at most two dependent trips: the lane issues the
// first `cap` sizes of its ladder row as independent 16-byte loads of the
// aligned chunks that hold them, all before any is used (unrolled to K <=
// 15), takes j* from the values in registers, and only then loads k and
// l at j* - 1. No ladder load waits on another's value but those at j* -
// 1; on the main path each trip misses the L2 (the ladders are 554 MB at
// K = 11).
// Two forms of the launch (MODE), one for each pass:
// - 1, pass 1: a block a read; after each chunk's walks the block keeps
//   the chunk's E in shared memory (and the last E of the chunk before),
//   takes the left-maximal mask of ops/smem.py::_left_max_mask (p = 0 or
//   E(p - 1) < E(p), and E(p) - p >= min_seed_len), ranks the emitting
//   columns by a block scan in column order and writes slot r of the
//   read (m = p, n = E - 1, k, l, s) from the lane's registers; after the
//   last chunk the slots from min(cnt, M) on are zeroed, each slot
//   written once, and cnt counts every emission (one past M dropped).
//   Merged, it also writes the records pass 3's stage reads (E, f3_E,
//   f3_k, f3_l, f3_ss, f3_s, died_s) and nothing else;
// - 2, pass 2: a block a read over its reseed tasks. The tasks must be
//   sorted by read (ops/smem.py::reseed_tasks: the valid ones first, in
//   read order; not checked here: another order gives wrong slots), so
//   the block finds its range by two searches of the
//   key t_valid ? t_read : B, 4 blockDim.x samples a round (one round at
//   T = 2B), its loads in flight beside the codes' staging. A block a
//   read, not a block a task with a look-back over blocks (csrc/sal.cu's
//   scan): a read's slots are then ranked by one block scan with no
//   traffic between blocks, the read's codes are staged once for all
//   its tasks (no codes[t_read] gather), and a read's tasks run side by
//   side. The lanes are task-major, which is _emit_compact(rows=t_read)'s
//   slot order, each task's columns up to its t_x only: a lane past t_x
//   can neither emit nor decide an emitting lane's left-maximality, which
//   reads the lane before it, so it is not walked (steps 0). A group of
//   up to blockDim.x tasks loads its t_x and t_mi at once and compacts
//   its lanes by a block scan of the widths. The mask adds p <= t_x and
//   E > t_x of the lane's task; mi is t_mi.
// With per-lane step planes given (a test's or a tool's request) the
// launch writes each lane's steps (and row fetches at KS = 2) too. With
// stats, each block adds its lanes' longest steps, total steps and
// longest row fetches to three device counters through running maxima
// and a self-resetting ticket, as seed_strategy_merged_kernel does, so no
// operation is needed outside the launch.
// Design: one block a read, its codes staged into dynamic shared memory
// as bytes (stage_codes), one thread a lane, min(256, the read's lanes
// rounded up to 32) threads a block striding over the lanes in chunks. A
// warp's lanes are 32 neighbouring columns: lanes before a mismatch stop
// near it, lanes after it run on, so a warp runs as long as its longest
// lane (issue slots, not the chain, while every warp is resident).
// What bounds it on this card: the longest lane's chain. A lane's steps
// depend on one another (each step's two checkpoint rows come from the
// previous interval): on a table in the L2 (the 4.6 Mbp genome's 9.2 MB)
// one L2 trip a step (probe B, measured in the run), after the start's
// trips past the L2 (at most two). Latency floor: the longest lane's
// steps x the L2 trip + one HBM trip. Bytes bound, each byte counted
// once: the distinct checkpoint rows the launch's steps touch (32 bytes
// each, counted by the twin, ops/sweep_cuda.py::sweep_extend_twin), the
// ladder sectors the starts touch, the codes and lengths (and the task
// list), the outputs; over 3.35 TB/s.
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
constexpr int KMAX = 15;             // the longest ladder row (K)
constexpr int MERGED_WARPS = 8;      // reads (warps) a merged-stage block

enum { PASS1 = 1, PASS2 = 2 };

// What a launch reads and writes beside the index (every pointer of a
// form it does not use null): out [2][B][M] int32 m, n then [3][B][M] P
// k, l, s, cnt [B]; pass 1 merged: rec_i [2][B][NP] E, f3_E, rec_p
// [3][B][NP] f3_k, f3_l, f3_ss, rec_b [2][B][NP] f3_s, died_s; the lanes'
// steps and row fetches [rows][NP] where given.
struct SweepArgs {
  const int32_t* codes;       // [B, L]
  const int32_t* lens;        // [B]
  const long long* t_read;    // [T] (pass 2)
  const int32_t* t_x;
  const void* t_mi;           // [T] of P
  const uint8_t* t_valid;
  const void* lad_k;          // [4^K, K] of P, or null
  const void* lad_l;
  const void* lad_s;
  int32_t* out;
  int32_t* cnt;
  int32_t* rec_i;
  void* rec_p;
  uint8_t* rec_b;
  int32_t* steps;             // [rows][NP] or null
  int32_t* rounds;
  unsigned long long* acc_steps;    // the longest lanes' steps, summed
  unsigned long long* acc_total;    // every lane's steps
  unsigned long long* acc_rounds;   // the longest lanes' row fetches
  unsigned long long* run;    // [4]: two running maxima, ticket, 0
  int B, L, NP, T, p3_max_intv, p3_stop, K, K_eff, min_seed_len, M;
};

// one lane's walk and what it records
template <typename P>
struct Lane {
  P k, l, s, f3k, f3l, f3ss;
  int E, f3E, steps, rounds;
  bool f3s, died;
};

// j*, the leading sizes >= mi among the first cap (<= KMAX) of a ladder
// row starting at p, and the size at j* - 1 (s, left as it is for j* =
// 0): the row's sizes as 16-byte loads of the aligned chunks that hold
// them (the ladders' base is 16-byte aligned), all issued before any is
// used. A quarter (int32) or half (int64) of the load instructions of one
// load an entry, whose 32 lanes each touch a random row.
template <typename P>
__device__ __forceinline__ int row_lead(const P* p, int cap, P mi, P& s) {
  constexpr int EPC = 16 / sizeof(P);                 // entries a chunk
  constexpr int NCH = (KMAX + EPC - 1) / EPC + 1;     // chunks at most
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const int4* c = reinterpret_cast<const int4*>(at & ~(uintptr_t)15);
  const int skip = (int)((at & 15) / sizeof(P));
  int4 q[NCH];
#pragma unroll
  for (int j = 0; j < NCH; ++j)
    q[j] = j * EPC < skip + cap ? __ldg(c + j) : make_int4(0, 0, 0, 0);
  // entry e of the chunks, e a constant after unrolling
  auto elem = [&](int e) -> P {
    const int4& x = q[e / EPC];
    if constexpr (EPC == 4) {
      const int r = e % 4;
      return (P)(r == 0 ? x.x : r == 1 ? x.y : r == 2 ? x.z : x.w);
    } else {
      const bool hi = e % 2;
      const unsigned lo32 = (unsigned)(hi ? x.z : x.x);
      const unsigned hi32 = (unsigned)(hi ? x.w : x.y);
      return (P)(((unsigned long long)hi32 << 32) | lo32);
    }
  };
  int jstar = 0;
  bool lead = true;
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    P x = 0;
#pragma unroll
    for (int sk = 0; sk < EPC; ++sk)
      if (sk == skip) x = elem(sk + i);
    lead = lead && i < cap && x >= mi;
    if (lead) s = x;
    jstar += lead;
  }
  return jstar;
}

template <int KS, typename P>
__device__ __forceinline__ void sweep_lane(const Fmi<P>& f, const Kfmi& g,
                                           const SweepArgs& a,
                                           const int8_t* q, int len, P mi,
                                           int p, Lane<P>& o) {
  const P* lad_k = static_cast<const P*>(a.lad_k);
  const P* lad_l = static_cast<const P*>(a.lad_l);
  const P* lad_s = static_cast<const P*>(a.lad_s);
  const int L = a.L, K = a.K, K_eff = a.K_eff;
  const bool merge = a.p3_max_intv > 0 && a.p3_stop > 0;
  auto code = [&](int i) { return i < L ? (int)q[i] : 4; };
  auto clip = [](int c) { return c < 0 ? 0 : (c > 3 ? 3 : c); };
  P k = 0, l = 0, s = 0;
  int E, off;
  bool act, died = false;
  if (K_eff) {                       // the FMA start: the K-mer's row
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
    const int jstar = row_lead(lad_s + row, cap, mi, s);  // trip 1: sizes
    if (jstar > 0) {                 // trip 2: k and l at j* - 1
      k = __ldg(lad_k + row + jstar - 1);
      l = __ldg(lad_l + row + jstar - 1);
    }
    E = p + jstar;
    act = jstar == K_eff && p + K_eff < len;
    died = merge && jstar < cap;
    off = K_eff - 1;
  } else {                           // the 1-bp interval of column p
    const int c0 = code(p), a0 = clip(c0);
    k = cval(f, a0);
    l = cval(f, 3 - a0);
    s = cval(f, a0 + 1) - k;
    act = p < len && c0 < 4 && s >= mi;
    if (!act) k = l = s = 0;
    E = act ? p + 1 : p;
    off = 0;
  }
  bool f3s = false;
  P f3k = 0, f3l = 0, f3ss = 0;
  int f3E = 0, t = 1, rounds = 0, steps = 0;
  // the step at column j (the lane's t-th), its extension (nk, nl, ns)
  // made: the pass-3 record, then a size below mi (false: the lane
  // retires) or the match grown to j + 1
  auto take = [&](int j, P nk, P nl, P ns) {
    ++steps;
    if (merge && !f3s && ns < (P)a.p3_max_intv && off + t + 1 >= a.p3_stop) {
      f3s = true;
      f3E = j;
      f3k = nk;
      f3l = nl;
      f3ss = ns;
    }
    if (ns < mi) {                             // a size failure
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
  while (act) {                      // KS forward steps a row fetch
    const int j = p + off + t;
    const int c = code(j);
    if (j >= len || c >= 4) break;             // an N or the read's end
    ++rounds;
    if constexpr (KS == 1) {
      P nk, nl, ns;
      ext(f, l, k, s, 3 - clip(c), nl, nk, ns);  // the swapped interval
      act = take(j, nk, nl, ns);
    } else {
      // a walk that ends after the first base keeps its records
      const int b2 = code(j + 1);
      int ch[2] = {3 - c, 3 - clip(b2)}, bk[2], bl[2], bs[2];
      ext_k<2>(f, g, l, k, s, ch, bk, bl, bs);   // the swapped interval
      act = take(j, bl[0], bk[0], bs[0]) && j + 1 < len && b2 < 4
            && take(j + 1, bl[1], bk[1], bs[1]);
    }
  }
  o = Lane<P>{k, l, s, f3k, f3l, f3ss, E, f3E, steps, rounds, f3s, died};
}

// Read b's tasks [t0, t1): the first tasks whose key (t_valid ? t_read :
// B, sorted) is >= b and >= b + 1. Both searches sample 4 blockDim.x
// keys a round, all loads of a round issued at once; each round narrows
// the range 4 blockDim.x-fold (one round at T = 2B = 1,024 with 256
// threads), not the ~log2(T) dependent trips of a binary search.
// Block-uniform.
__device__ __forceinline__ void task_range(const SweepArgs& a, int b,
                                           int& t0, int& t1) {
  constexpr int U = 4;                          // samples a thread
  int lo[2] = {0, 0}, hi[2] = {a.T, a.T};
  const int ns_max = U * blockDim.x;
  while (lo[0] < hi[0] || lo[1] < hi[1]) {
    int step[2], key[2][U], c[2] = {0, 0};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = hi[r] - lo[r];
      step[r] = n > 0 ? (n + ns_max - 1) / ns_max : 1;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int t = lo[r] + (U * (int)threadIdx.x + u) * step[r];
        key[r][u] = t < hi[r] ? (a.t_valid[t] ? (int)a.t_read[t] : a.B)
                              : a.B + 1;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int u = 0; u < U; ++u)
        c[r] += __syncthreads_count(key[r][u] < b + r);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = hi[r] - lo[r], ns = (n + step[r] - 1) / step[r];
      if (n <= 0) continue;
      const int nlo = c[r] ? lo[r] + (c[r] - 1) * step[r] + 1 : lo[r];
      hi[r] = c[r] < ns ? lo[r] + c[r] * step[r] : hi[r];
      lo[r] = nlo;
    }
  }
  t0 = lo[0];
  t1 = lo[1];
}

template <int KS, typename P, int MODE>
__global__ void __launch_bounds__(SWEEP_BLOCK)
sweep_extend_kernel(Fmi<P> f, Kfmi g, SweepArgs a) {
  extern __shared__ int4 smem[];
  int8_t* q = reinterpret_cast<int8_t*>(smem);     // the read's codes
  __shared__ int Es[SWEEP_BLOCK];                  // the chunk's E
  __shared__ int wsum[SWEEP_BLOCK / WARP];         // a warp's sums
  __shared__ int pre[SWEEP_BLOCK];   // pass 2: a task group's lane offsets
  __shared__ int tx[SWEEP_BLOCK];    // and each task's t_x
  __shared__ P tm[SWEEP_BLOCK];      // and t_mi
  __shared__ unsigned long long bst[3];            // the block's stats
  const int b = blockIdx.x;
  const int NP = a.NP, L = a.L, M = a.M;
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  // the read's codes (their loads in flight beside pass 2's search)
  stage_codes(a.codes + (size_t)b * L, L, q, threadIdx.x, blockDim.x);
  int t0 = b, nt = 1;
  if constexpr (MODE == PASS2) {
    int t1;
    task_range(a, b, t0, t1);
    nt = t1 - t0;
  }
  const int len = a.lens[b];
  const bool merge = a.p3_max_intv > 0 && a.p3_stop > 0;
  if (a.acc_steps != nullptr && threadIdx.x < 3) bst[threadIdx.x] = 0;
  __syncthreads();
  const size_t plane = (size_t)a.B * NP;
  int base = 0, carry = 0;       // emissions so far; E of the lane before
  unsigned long long mx = 0, sum = 0, mr = 0;
  // The block's lanes, task-major: every column of the row (pass 1), or
  // pass 2's tasks of the read in groups of blockDim.x, each task's
  // columns up to its t_x only (a lane past it can neither emit nor
  // decide an emitting lane's left-maximality), compacted by a prefix of
  // the widths, so that a read with many tasks takes few chunks.
  for (int g0 = 0; g0 < nt; g0 += blockDim.x) {   // block-uniform
    const int gn = min(nt - g0, (int)blockDim.x);
    int nl = NP;
    if constexpr (MODE == PASS2) {
      int wdt = 0;
      if ((int)threadIdx.x < gn) {   // the group's t_x and t_mi at once
        const int t = t0 + g0 + threadIdx.x;
        const int x = a.t_x[t];
        tm[threadIdx.x] = static_cast<const P*>(a.t_mi)[t];
        tx[threadIdx.x] = x;
        wdt = x < 0 ? 0 : (x + 1 < NP ? x + 1 : NP);
      }
      int v = wdt;                   // a block-wide exclusive scan
#pragma unroll
      for (int d = 1; d < WARP; d <<= 1) {
        const int u = __shfl_up_sync(FULL, v, d);
        if (lane >= d) v += u;
      }
      if (lane == WARP - 1) wsum[w] = v;
      __syncthreads();
      int off = 0;
      nl = 0;
      for (int i = 0; i < (int)(blockDim.x / WARP); ++i) {
        off += i < w ? wsum[i] : 0;
        nl += wsum[i];
      }
      pre[threadIdx.x] = off + v - wdt;
      __syncthreads();
    }
    for (int c0 = 0; c0 < nl; c0 += blockDim.x) {  // block-uniform
      const int n = c0 + threadIdx.x;
      const bool on = n < nl;
      int ti = 0;                    // the lane's task in the group
      if (MODE == PASS2 && on) {
        int lo = 0, hi = gn - 1;     // the last task whose lanes start <= n
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (pre[mid] <= n) lo = mid; else hi = mid - 1;
        }
        ti = lo;
      }
      const int p = MODE == PASS2 ? n - pre[ti] : n;
      const int t = t0 + g0 + ti;
      Lane<P> o;
      o.E = 0;
      if (on) {
        const P mi = MODE == PASS2 ? tm[ti] : (P)1;
        sweep_lane<KS, P>(f, g, a, q, len, mi, p, o);
        mx = max(mx, (unsigned long long)o.steps);
        sum += o.steps;
        mr = max(mr, (unsigned long long)o.rounds);
        const size_t at = (size_t)(MODE == PASS2 ? t : b) * NP + p;
        if (a.steps != nullptr) a.steps[at] = o.steps;
        if (a.rounds != nullptr) a.rounds[at] = o.rounds;
        if (MODE == PASS1 && merge) {  // what pass 3's stage reads
          P* rp = static_cast<P*>(a.rec_p);
          a.rec_i[at] = o.E;
          a.rec_i[plane + at] = o.f3E;
          rp[at] = o.f3k;
          rp[plane + at] = o.f3l;
          rp[2 * plane + at] = o.f3ss;
          a.rec_b[at] = o.f3s;
          a.rec_b[plane + at] = o.died;
        }
      }
      Es[threadIdx.x] = o.E;
      __syncthreads();
      const int prev = threadIdx.x ? Es[threadIdx.x - 1] : carry;
      bool em = on && (p == 0 || prev < o.E) && o.E - p >= a.min_seed_len;
      if (MODE == PASS2) em = em && o.E > tx[ti];
      const unsigned bal = __ballot_sync(FULL, em);
      if (lane == 0) wsum[w] = __popc(bal);
      __syncthreads();
      int r = base, total = 0;
      for (int i = 0; i < (int)(blockDim.x / WARP); ++i) {
        r += i < w ? wsum[i] : 0;
        total += wsum[i];
      }
      r += __popc(bal & ((1u << lane) - 1));
      if (em && r < M) {           // slot r of the read, once
        const size_t bm = (size_t)a.B * M, at = (size_t)b * M + r;
        P* kls = reinterpret_cast<P*>(a.out + 2 * bm);
        a.out[at] = p;
        a.out[bm + at] = o.E - 1;
        kls[at] = o.k;
        kls[bm + at] = o.l;
        kls[2 * bm + at] = o.s;
      }
      carry = Es[blockDim.x - 1];
      base += total;
      __syncthreads();             // before Es, wsum, pre, tx, tm reused
    }
  }
  // the slots past the emissions
  const size_t bm = (size_t)a.B * M;
  P* kls = reinterpret_cast<P*>(a.out + 2 * bm);
  for (int j = min(base, M) + threadIdx.x; j < M; j += blockDim.x) {
    const size_t at = (size_t)b * M + j;
    a.out[at] = 0;
    a.out[bm + at] = 0;
    kls[at] = 0;
    kls[bm + at] = 0;
    kls[2 * bm + at] = 0;
  }
  if (threadIdx.x == 0) a.cnt[b] = base;
  if (a.acc_steps != nullptr) {      // the stats, grid-uniform
    atomicMax(&bst[0], mx);
    atomicAdd(&bst[1], sum);
    atomicMax(&bst[2], mr);
    __syncthreads();
    if (threadIdx.x == 0) {
      atomicMax(a.run, bst[0]);
      atomicMax(a.run + 1, bst[2]);
      atomicAdd(a.acc_total, bst[1]);
      __threadfence();
      // run[2]'s low word: blocks done, back to 0 after the last
      const unsigned t = atomicInc(reinterpret_cast<unsigned*>(a.run + 2),
                                   gridDim.x - 1);
      if (t == gridDim.x - 1) {
        atomicAdd(a.acc_steps, atomicExch(a.run, 0ull));
        atomicAdd(a.acc_rounds, atomicExch(a.run + 1, 0ull));
      }
    }
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


// threads a sweep block: a block's lanes rounded up to a warp, at most
// SWEEP_BLOCK
int sweep_threads(int lanes) {
  const int t = (lanes + WARP - 1) / WARP * WARP;
  return t < SWEEP_BLOCK ? t : SWEEP_BLOCK;
}

template <int KS, typename P, int MODE>
int sweep_launch_t(const Fmi<P>& f, const Kfmi& g, const SweepArgs& a,
                   void* stream) {
  if (a.B <= 0 || a.NP <= 0) return 0;
  const size_t bytes = codes_bytes(a.L);
  const bool fma_ok = a.K_eff == 0
      || (a.K_eff >= 2 && a.K_eff <= a.K && a.K <= KMAX && a.lad_k
          && a.lad_l && a.lad_s);
  const bool outs_ok = a.out && a.cnt && a.M >= 0
      && (a.p3_max_intv <= 0 || a.p3_stop <= 0
          || (a.rec_i && a.rec_p && a.rec_b));
  const bool tasks_ok = MODE != PASS2
      || (a.T >= 0 && a.t_read && a.t_x && a.t_mi && a.t_valid);
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || a.L <= 0 || a.NP > a.L
      || bytes > SMEM_MAX || !fma_ok || !outs_ok || !tasks_ok
      || (a.acc_steps && !(a.acc_total && a.acc_rounds && a.run)))
    return (int)cudaErrorInvalidValue;
  auto kernel = sweep_extend_kernel<KS, P, MODE>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  // pass 2: a read's tasks side by side, however many
  kernel<<<a.B, MODE == PASS2 ? SWEEP_BLOCK : sweep_threads(a.NP), bytes,
           (cudaStream_t)stream>>>(f, g, a);
  return (int)cudaGetLastError();
}

// A pass's arguments (the launch functions below say which is which).
SweepArgs pass_args(const void* codes, const void* lens,
                    const void* t_read, const void* t_x, const void* t_mi,
                    const void* t_valid, int T, int B, int L, int NP,
                    int min_seed_len, int M, int p3_max_intv, int p3_stop,
                    const void* lad_k, const void* lad_l, const void* lad_s,
                    int K, int K_eff, void* out, void* cnt, void* rec_i,
                    void* rec_p, void* rec_b, void* steps, void* rounds,
                    void* acc_steps, void* acc_total, void* acc_rounds,
                    void* run) {
  return SweepArgs{(const int32_t*)codes, (const int32_t*)lens,
                   (const long long*)t_read, (const int32_t*)t_x, t_mi,
                   (const uint8_t*)t_valid, lad_k, lad_l, lad_s,
                   (int32_t*)out, (int32_t*)cnt, (int32_t*)rec_i, rec_p,
                   (uint8_t*)rec_b, (int32_t*)steps, (int32_t*)rounds,
                   (unsigned long long*)acc_steps,
                   (unsigned long long*)acc_total,
                   (unsigned long long*)acc_rounds, (unsigned long long*)run,
                   B, L, NP, T, p3_max_intv, p3_stop, K, K_eff,
                   min_seed_len, M};
}

template <int KS, typename P>
int pass_launch_t(const Fmi<P>& f, const Kfmi& g, const SweepArgs& a,
                  void* stream) {
  return a.t_read ? sweep_launch_t<KS, P, PASS2>(f, g, a, stream)
                  : sweep_launch_t<KS, P, PASS1>(f, g, a, stream);
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

// Launch a pass form of sweep_extend_kernel on `stream`: B reads (a block
// each) of codes [B, L] and lens [B] int32, their first NP start columns;
// returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for a
// shape it cannot take. K_eff = 0 runs without the ladder table (its
// pointers may be null), else 2 <= K_eff <= K <= 15 and the ladders
// 16-byte aligned. Pass 1 (t_read null): min_intv 1; merged with pass 3
// where p3_max_intv, p3_stop > 0, its records into rec_i [2][B][NP]
// int32 (E, f3_E), rec_p [3][B][NP] of the position type (f3_k, f3_l,
// f3_ss) and rec_b [2][B][NP] bytes (f3_s, died_s). Pass 2: the tasks
// t_read [T] int64, t_x [T] int32, t_mi [T] of the position type and
// t_valid [T] bytes, the valid ones first and sorted by read (not
// checked). Both: the SMEMs of each read whose match is left-maximal and
// at least min_seed_len long (pass 2: and covering its task's t_x) into
// out ([2][B][M] int32 m, n, then [3][B][M] of the position type k, l,
// s; every slot written) and cnt [B] int32. With steps (and at KS = 2
// rounds), [B][NP] (pass 1) or [T][NP] (pass 2, zeroed by the caller: an
// invalid task's row and a lane past its task's t_x are not written)
// int32, each lane's steps (row fetches). With acc_steps, acc_total and
// acc_rounds (one uint64 each: the launches' longest steps, total steps,
// longest row fetches) and run (four uint64, zero when first used, left
// zero by every launch) the launch adds its stats to the three; all four
// null for none. The caller allocates every buffer and checks shapes and
// types; nothing here synchronises.
extern "C" int sweep_pass_launch(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* codes, const void* lens, const void* t_read,
    const void* t_x, const void* t_mi, const void* t_valid, int T, int B,
    int L, int NP, int min_seed_len, int M, int p3_max_intv, int p3_stop,
    const void* lad_k, const void* lad_l, const void* lad_s, int K,
    int K_eff, void* out, void* cnt, void* rec_i, void* rec_p, void* rec_b,
    void* steps, void* rounds, void* acc_steps, void* acc_total,
    void* acc_rounds, void* run, void* stream) {
  return pass_launch_t<1, int>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{},
      pass_args(codes, lens, t_read, t_x, t_mi, t_valid, T, B, L, NP,
                min_seed_len, M, p3_max_intv, p3_stop, lad_k, lad_l, lad_s,
                K, K_eff, out, cnt, rec_i, rec_p, rec_b, steps, rounds,
                acc_steps, acc_total, acc_rounds, run),
      stream);
}

// sweep_pass_launch's k-step form (int32 layout only): two bases a row
// fetch from the k-gram table `cpk` ([nb][w4] int4, ops/occ.py::
// kstep_rows; a trigram table's bigram groups) with its C2 [16] table on
// the device, after the FMA start where K_eff > 0.
extern "C" int sweep_pass_launch_k(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* cpk, int w4, const void* c2k,
    const void* codes, const void* lens, const void* t_read,
    const void* t_x, const void* t_mi, const void* t_valid, int T, int B,
    int L, int NP, int min_seed_len, int M, int p3_max_intv, int p3_stop,
    const void* lad_k, const void* lad_l, const void* lad_s, int K,
    int K_eff, void* out, void* cnt, void* rec_i, void* rec_p, void* rec_b,
    void* steps, void* rounds, void* acc_steps, void* acc_total,
    void* acc_rounds, void* run, void* stream) {
  return pass_launch_t<2, int>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel),
      make_kfmi(cpk, nb, w4, c2k, nullptr),
      pass_args(codes, lens, t_read, t_x, t_mi, t_valid, T, B, L, NP,
                min_seed_len, M, p3_max_intv, p3_stop, lad_k, lad_l, lad_s,
                K, K_eff, out, cnt, rec_i, rec_p, rec_b, steps, rounds,
                acc_steps, acc_total, acc_rounds, run),
      stream);
}

// sweep_pass_launch's int64 form: the index at 64 bits with its
// high-word step table `hi` and steps h0-h3 a base (csrc/smem.cu's
// one_pos_launch64), int64 ladders, the k, l, s slots and the records
// rec_p at int64.
extern "C" int sweep_pass_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* codes,
    const void* lens, const void* t_read, const void* t_x, const void* t_mi,
    const void* t_valid, int T, int B, int L, int NP, int min_seed_len,
    int M, int p3_max_intv, int p3_stop, const void* lad_k,
    const void* lad_l, const void* lad_s, int K, int K_eff, void* out,
    void* cnt, void* rec_i, void* rec_p, void* rec_b, void* steps,
    void* rounds, void* acc_steps, void* acc_total, void* acc_rounds,
    void* run, void* stream) {
  return pass_launch_t<1, long long>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{},
      pass_args(codes, lens, t_read, t_x, t_mi, t_valid, T, B, L, NP,
                min_seed_len, M, p3_max_intv, p3_stop, lad_k, lad_l, lad_s,
                K, K_eff, out, cnt, rec_i, rec_p, rec_b, steps, rounds,
                acc_steps, acc_total, acc_rounds, run),
      stream);
}

// Launch seed_strategy_merged_kernel on `stream` over B reads (a warp
// each): count [5] and the records f3k, f3l, f3ss [B, NP] of the position
// type (int32 here, int64 in seed_strategy_merged_launch64), codes [B, L]
// and lens [B] int32, died_s and f3_s [B, NP] bytes, f3_E and E [B, NP]
// int32; out [2][B][M] int32 then [3][B][M] of the position type, cnt
// and steps [B] int32. With acc_steps, acc_total (one uint64 each) and
// run (two uint64, zero when first used, left zero by every launch) the
// launch adds its longest and total steps to the two counters; all three
// null for none. The return and the caller's duties as
// sweep_pass_launch's.
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
