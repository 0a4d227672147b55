// The extension stage's glue for Hopper (sm_90a): what seed_chain_extend
// does from the chain filter's outputs to its returned dict, around the
// four BSW launches (csrc/bsw.cu), in seven launches of its own with no
// host synchronisation and no tensor operation between them but the
// outputs' allocations. The stage on a CUDA batch is eleven launches:
// ext_select_kernel, ext_pairs_kernel, ext_stage_kernel, BSW left round 1,
// ext_band_kernel<0>, BSW left round 2, ext_band_kernel<1>, BSW right round
// 1, ext_band_kernel<2>, BSW right round 2, ext_band_kernel<3>. Their plain
// versions are bwa_mem_scale_tpu_torch/ops/extend.py's functions (the
// port's earlier eager torch glue, moved); ops/extend_cuda.py wraps the
// kernels and holds their CPU twins. The JAX package runs this as part
// of one traced program (bwa_mem_scale_tpu/pipeline/align.py:202-509),
// as rank arithmetic, one-hot compaction and gathered windows because
// XLA on a TPU gathers per element slowly; on the card each read's
// candidates and each pair's fields are a loop, and the loop is a kernel.
//
// ---- ext_select_kernel (candidates and rmax; a block a read)
// Replaces JAX align.py:202-329 (the port's align.py:244-311 before this
// kernel): a dense [B, C, S] argsort, scatter and gathers, then rmax with its
// bridging and contig clamp. Sixteen warps a read (four took 0.0206 ms on a
// 512-read batch and 0.0158 on one read on an H100: a warp's chains ran one
// after another, each a chain of dependent loads and reductions). Phase A, a
// warp a chain slot: each live seed's span (_cal_max_gap at both ends, in
// int64), the min / max by warp reductions, the first live seed by a minimum
// (slot 0 when none is live), the l_pac bridging rule at it and the clamp to
// its contig by a binary search over the contig offsets; the chain's live
// count into shared memory. Phase B, one warp: the live counts of the kept
// chains in the filter's order, scanned in chunks of 32 into each chain's
// first candidate rank (n_cand and reg_overflow). Phase C, a warp a kept chain
// whose first rank is below R: its S keys (score << 16) | sidx staged in
// shared memory (-1 for a dead seed), each live seed ranked by counting the
// keys above it (valid keys are distinct), and written at its rank as slot * S
// + sidx when below R. The slots past min(n_cand, R) get 0, as the plain
// version's scatter leaves them. Tier 2 (C = 1,024, S = 256) is 262,144 seed
// slots a read: the loops are over chains, and a chain's ranking is S x (its
// live seeds) comparisons from shared memory. Bound: the live seeds' qbeg, len
// and rbeg read once, the rmax rows and sel written once (bytes); a few
// microseconds at the default widths.
//
// ---- ext_pairs_kernel (pair compaction; one block)
// Replaces JAX align.py:331-358 and the per-read half of :488-500 (the
// port's align.py:313-322 and :421-425): compact_indices over the [B, R]
// candidate mask (cumsum, scatter), pair_overflow, read_pair_of, the
// overflow OR and the meta rows. One block of 1,024 threads loops over
// the reads in chunks (csrc/block_scan.cuh, as reseed_tasks_kernel): a
// thread a read takes its candidate count min(n_cand, R), the block
// scans the counts and carries the chunk's total; each thread writes its
// read's overflow flags and meta row; then the block writes the chunk's
// pairs below PX coalesced, each thread finding its pair's read by a
// binary search over the chunk's scanned counts in shared memory. The
// rows past the batch's pairs get read 0, candidate 0 and valid 0, as
// compact_indices points them at flat index 0. It also zeroes the BSW
// length flag that the next two kernels OR into. Bound: a few bytes a
// read and a pair; the launch's latency, not bytes.
//
// ---- ext_stage_kernel (window staging; a warp a pair)
// Replaces JAX align.py:359-389 (the port's align.py:323-349: ten topair
// gathers, four window gathers, the length masks). A warp a pair over
// all PX rows: every lane loads the pair's scalars (one address each, a
// broadcast), lane 0 writes the pair's fields, unmasked lengths, the left
// round-1 lengths (do_left applied) and h0; the lanes write the four
// windows lane-strided, so the stores of a row coalesce: q_l[j] =
// codes[qbeg - 1 - j], t_l[j] = ref[rbeg - 1 - j], q_r[j] = codes[qe + j],
// t_r[j] = ref[re0 + j], each index clamped into its row as
// ops/window.py clamps it. Invalid rows hold exactly the plain path's
// values (read 0's candidate column 0). Bound: the windows' bytes, PX x
// (2 L + 2 TL) x 4 written (13.4 MB at PX 4,096, L 101, TL 309: 4 us at
// HBM rate), plus each distinct input byte read once: the union of the
// rows' reference windows (the invalid rows share one pair), each read's
// codes, each candidate's seed and each chain's rmax.
//
// ---- ext_band_kernel<PHASE> (band-doubling picks; a thread a pair)
// Replaces JAX align.py:410-509 (the port's align.py:359-431: the where /
// pick chains between the BSW calls, the [PX, S] coverage gather and two
// stacks). It reads BSW's [6, P] output in place. Phase 0, after left
// round 1: the round-2 lengths of the pairs whose max_off reached the
// acceptance band. Phase 1, after left round 2: the pick, score_l, qb,
// rb, truesc, the band, and the right round-1 lengths (h0 = score_l).
// Phase 2, after right round 1: the round-2 lengths. Phase 3, after
// right round 2: the pick, qe, re, truesc and the band; seedcov as a loop
// over the pair's chain's S seeds; the packed [PX, 14] row (int64
// positions in 31-bit halves) and every per-pair field of the dict at the
// plain path's dtype. Bound: BSW's rows and the pair fields read once,
// the outputs written once (bytes), plus the coverage's live seeds.
//
// ---- the BSW length check
// ops/bsw_cuda.py::banded_swa_batch_cuda checks each call's lengths
// against its rows with a host synchronisation. On this path the kernels
// that write a BSW call's lengths (ext_stage_kernel, phases 0-2) test the
// same bound, OR 1 into the flag word on a length past its row, and hand
// BSW the length clamped to the row, so BSW never reads past it;
// fetch_extend raises with the check's message after its copy.
//
// Every kernel is a template on the position type P (int, or long long
// for the int64 layout): only the chains' rbeg is P; the spans, rb and
// re are int64 and everything else int32 (flags as bytes). Each output
// element is written once.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using scan::FULL;
using scan::WARP;

constexpr int SELECT_WARPS = 16;         // ext_select_kernel: warps a read
constexpr int PAIR_THREADS = 1024;       // ext_pairs_kernel's one block
constexpr int STAGE_WARPS = 8;           // ext_stage_kernel: pairs a block
constexpr int BAND_THREADS = 256;        // ext_band_kernel: pairs a block
constexpr size_t SMEM_DEFAULT = 49152;

// the stage's int32 rows [ST_ROWS][PX] (ops/extend_cuda.py names them)
enum { QBEG, SLEN, RID, SLOT, PLENS, QL, TLN, QR, TR, BLQ, BLT, H0,
       ST_ROWS };
// the left pick's int32 rows [LF_ROWS][PX]
enum { L_QB, L_SCORE, L_TRUESC, L_W, L_BLQ, L_BLT, LF_ROWS };
// BSW's output rows [6][P]
enum { B_SCORE, B_QLE, B_TLE, B_GTLE, B_GSCORE, B_MAXOFF };
// phase 3's int32 rows [3][PX] and int64 rows [3][PX]
enum { F_QE, F_SCORE, F_TRUESC };
enum { F_RE, F_W, F_SEEDCOV };
constexpr int PACKED = 14;

struct Opt {                 // MemOptions' scalars the stage reads
  int a, w, o_del, e_del, o_ins, e_ins, pen_clip5, pen_clip3;
  long long l_pac;
};

template <typename P>
struct ChainsIn {            // ops/chain.py::Chains, rows by slot
  const int32_t* qbeg;       // [B][C][S]
  const int32_t* len;        // [B][C][S]
  const P* rbeg;             // [B][C][S]
  const int32_t* n_seeds;    // [B][C]
  const int32_t* rid;        // [B][C]
  const uint8_t* live;       // [B][C][S], or null: the first n_seeds
  int C, S;
};

template <typename P>
__device__ __forceinline__ bool seed_live(const ChainsIn<P>& ch,
                                          long long cs, int s) {
  return ch.live ? ch.live[cs * ch.S + s] != 0 : s < ch.n_seeds[cs];
}

// _cal_max_gap in int64 (C division truncates, as torch's "trunc")
__device__ __forceinline__ long long max_gap(long long q, const Opt& o) {
  const long long l_del = (q * o.a - o.o_del) / o.e_del + 1;
  const long long l_ins = (q * o.a - o.o_ins) / o.e_ins + 1;
  return min(max(max(l_del, l_ins), 1LL), (long long)(o.w << 1));
}

__device__ __forceinline__ long long warp_min(long long v) {
  for (int d = WARP / 2; d; d >>= 1) v = min(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__device__ __forceinline__ long long warp_max(long long v) {
  for (int d = WARP / 2; d; d >>= 1) v = max(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
  for (int d = WARP / 2; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
  return v;
}

__device__ __forceinline__ int warp_imin(int v) {
  for (int d = WARP / 2; d; d >>= 1) v = min(v, __shfl_xor_sync(FULL, v, d));
  return v;
}

// A length BSW takes: flagged and clamped past its row count.
__device__ __forceinline__ int checked(int len, int rows, bool* over) {
  if (len > rows) {
    *over = true;
    return rows;
  }
  return len;
}

template <typename P>
__global__ void __launch_bounds__(SELECT_WARPS * WARP) ext_select_kernel(
    ChainsIn<P> ch, const int32_t* __restrict__ order,
    const int32_t* __restrict__ kept, const int32_t* __restrict__ score,
    const int32_t* __restrict__ lens, const long long* __restrict__ offsets,
    int n_seqs, Opt o, int R, int32_t* __restrict__ n_cand,
    int32_t* __restrict__ sel, uint8_t* __restrict__ reg_of,
    long long* __restrict__ rmax0, long long* __restrict__ rmax1) {
  extern __shared__ int smem[];
  const int C = ch.C, S = ch.S;
  int* live_of = smem;                   // [C] live seeds by slot
  int* base = smem + C;                  // [C] first rank by position
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  int* keys = smem + 2 * C + w * S;      // [S] this warp's keys
  const int b = blockIdx.x;
  const long long l_pac = o.l_pac, l_pac2 = 2 * o.l_pac;
  const long long rlen = lens[b];

  // A: each chain's live count and rmax, a warp a slot
  for (int c = w; c < C; c += SELECT_WARPS) {
    const long long cs = (long long)b * C + c;
    long long v0 = LLONG_MAX, v1 = LLONG_MIN;
    int nl = 0, first = S;
    for (int s = lane; s < S; s += WARP) {
      const long long i = cs * S + s;
      if (seed_live(ch, cs, s)) {
        const long long q = ch.qbeg[i], l = ch.len[i];
        const long long r = (long long)ch.rbeg[i];
        const long long flank = rlen - q - l;
        v0 = min(v0, r - (q + max_gap(q, o)));
        v1 = max(v1, r + l + flank + max_gap(flank, o));
        ++nl;
        first = min(first, s);
      } else {
        v0 = min(v0, l_pac2);
        v1 = max(v1, 0LL);
      }
    }
    v0 = warp_min(v0);
    v1 = warp_max(v1);
    nl = warp_sum(nl);
    first = warp_imin(first);
    if (lane == 0) {
      long long m0 = max(v0, 0LL), m1 = min(v1, l_pac2);
      const long long fr =
          (long long)ch.rbeg[cs * S + (first == S ? 0 : first)];
      const bool bridging = m0 < l_pac && l_pac < m1;
      if (bridging && fr < l_pac) m1 = l_pac;
      if (bridging && fr >= l_pac) m0 = l_pac;
      // the contig of the first seed: the offsets at or below its
      // forward position, less one (none past l_pac), at least 0
      const bool rev = fr >= l_pac;
      const long long pf = rev ? l_pac2 - 1 - fr : fr;
      int lo = 0, hi = n_seqs;           // first offset above pf
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (offsets[mid] <= pf) lo = mid + 1; else hi = mid;
      }
      const int rid = pf >= l_pac ? 0 : max(lo - 1, 0);
      const long long fb = offsets[rid];
      const long long fe = rid + 1 < n_seqs ? offsets[rid + 1] : l_pac;
      rmax0[cs] = max(m0, rev ? l_pac2 - fe : fb);
      rmax1[cs] = min(m1, rev ? l_pac2 - fb : fe);
      live_of[c] = nl;
    }
  }
  __syncthreads();
  // B: the kept chains' first ranks in the filter's order
  if (w == 0) {
    int carry = 0;
    for (int p0 = 0; p0 < C; p0 += WARP) {
      const int p = p0 + lane;
      int v = 0;
      if (p < C) {
        const long long bp = (long long)b * C + p;
        v = kept[bp] > 0 ? live_of[order[bp]] : 0;
      }
      const int inc = scan::warp_inclusive(v, lane);
      if (p < C) base[p] = carry + inc - v;
      carry += __shfl_sync(FULL, inc, WARP - 1);
    }
    if (lane == 0) {
      n_cand[b] = carry;
      reg_of[b] = carry > R;
    }
    live_of[0] = carry;                  // the read's total, for D
  }
  __syncthreads();
  const int total = live_of[0];
  // C: each kept chain's live seeds by rank
  for (int p = w; p < C; p += SELECT_WARPS) {
    const long long bp = (long long)b * C + p;
    const int bp0 = base[p];
    if (kept[bp] <= 0 || bp0 >= R) continue;        // warp-uniform
    const int slot = order[bp];
    const long long cs = (long long)b * C + slot;
    for (int s = lane; s < S; s += WARP)
      keys[s] = seed_live(ch, cs, s)
                    ? (int)(((uint32_t)score[cs * S + s] << 16) | (uint32_t)s)
                    : -1;
    __syncwarp();
    for (int s = lane; s < S; s += WARP) {
      if (!seed_live(ch, cs, s)) continue;
      const int k = keys[s];
      int rank = 0;
      for (int t = 0; t < S; ++t) rank += keys[t] > k;
      if (bp0 + rank < R) sel[(long long)b * R + bp0 + rank] = slot * S + s;
    }
    __syncwarp();                        // keys are rewritten next chain
  }
  // D: the slots past the candidates
  for (int r = min(total, R) + threadIdx.x; r < R; r += blockDim.x)
    sel[(long long)b * R + r] = 0;
}

__global__ void __launch_bounds__(PAIR_THREADS) ext_pairs_kernel(
    const int32_t* __restrict__ n_cand, const uint8_t* __restrict__ reg_of,
    const int32_t* __restrict__ smem_cnt, int M,
    const uint8_t* __restrict__ coord_of, const uint8_t* __restrict__ ch_of,
    const uint8_t* __restrict__ sw_of, const float* __restrict__ frac_rep,
    int B, int R, int PX, int32_t* __restrict__ p_read,
    int32_t* __restrict__ p_cand, uint8_t* __restrict__ p_valid,
    uint8_t* __restrict__ read_pair_of, uint8_t* __restrict__ pair_of,
    uint8_t* __restrict__ read_of, float* __restrict__ meta,
    int32_t* __restrict__ flag) {
  __shared__ int warp_inc[PAIR_THREADS / WARP];
  __shared__ int incl[PAIR_THREADS];     // the chunk's scanned counts
  const int tid = threadIdx.x;
  int carry = 0;                         // the earlier chunks' candidates
  for (int base = 0; base < B; base += PAIR_THREADS) {
    const int b = base + tid;
    const int k = b < B ? min(max(n_cand[b], 0), R) : 0;
    int chunk;
    const int inc = scan::block_inclusive(k, warp_inc, &chunk);
    incl[tid] = inc;
    if (b < B) {
      const bool rpo = k > 0 && carry + inc > PX;
      const bool ro = smem_cnt[b] >= M || coord_of[b] || ch_of[b] ||
                      reg_of[b] || rpo || (sw_of && sw_of[b]);
      read_pair_of[b] = rpo;
      read_of[b] = ro;
      meta[2LL * b] = frac_rep[b];
      meta[2LL * b + 1] = ro ? 1.0f : 0.0f;
    }
    __syncthreads();
    const int n = min(B - base, PAIR_THREADS);
    const int end = min(carry + chunk, PX);
    for (int t = carry + tid; t < end; t += PAIR_THREADS) {
      const int local = t - carry;
      int lo = 0, hi = n - 1;            // the first read past `local`
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (incl[mid] > local) hi = mid; else lo = mid + 1;
      }
      p_read[t] = base + lo;
      p_cand[t] = local - (lo ? incl[lo - 1] : 0);
      p_valid[t] = 1;
    }
    carry += chunk;
    __syncthreads();                     // incl is rewritten next chunk
  }
  for (int t = min(carry, PX) + tid; t < PX; t += PAIR_THREADS) {
    p_read[t] = 0;
    p_cand[t] = 0;
    p_valid[t] = 0;
  }
  if (tid == 0) {
    *pair_of = carry > PX;
    *flag = 0;
  }
}

template <typename P>
__global__ void __launch_bounds__(STAGE_WARPS * WARP) ext_stage_kernel(
    const int32_t* __restrict__ p_read, const int32_t* __restrict__ p_cand,
    const uint8_t* __restrict__ p_valid, const int32_t* __restrict__ sel,
    const long long* __restrict__ rmax0, const long long* __restrict__ rmax1,
    ChainsIn<P> ch, const int32_t* __restrict__ codes,
    const int32_t* __restrict__ lens, const uint8_t* __restrict__ ref,
    Opt o, int R, int L, int TL, int PX, int32_t* __restrict__ rows,
    long long* __restrict__ rbeg_out, int32_t* __restrict__ q_l,
    int32_t* __restrict__ t_l, int32_t* __restrict__ q_r,
    int32_t* __restrict__ t_r, int32_t* __restrict__ flag) {
  const int lane = threadIdx.x & (WARP - 1);
  const int p = blockIdx.x * STAGE_WARPS + threadIdx.x / WARP;
  if (p >= PX) return;
  const int C = ch.C, S = ch.S;
  const int b = p_read[p];
  const bool valid = p_valid[p];
  const int ss = sel[(long long)b * R + p_cand[p]];
  const int slot = ss / S;
  const long long i = (long long)b * C * S + ss, cs = (long long)b * C + slot;
  const int qbeg = ch.qbeg[i], slen = ch.len[i];
  const long long rbeg = (long long)ch.rbeg[i];
  const int plens = valid ? lens[b] : 0;
  const int qe = qbeg + slen;
  const long long re0 = rbeg + slen;
  const int ql = valid ? qbeg : 0;
  const int tl = valid ? (int)(rbeg - rmax0[cs]) : 0;
  const int qr = valid ? plens - qe : 0;
  const int tr = valid ? (int)(rmax1[cs] - re0) : 0;
  if (lane == 0) {
    const bool do_left = valid && qbeg > 0;
    bool over = false;
    const int blq = checked(do_left ? ql : 0, L, &over);
    const int blt = checked(do_left ? tl : 0, TL, &over);
    if (over) atomicOr(flag, 1);
    const int v[ST_ROWS] = {qbeg, slen, ch.rid[cs], slot, plens, ql, tl, qr,
                            tr, blq, blt, slen * o.a};
    for (int r = 0; r < ST_ROWS; ++r) rows[(long long)r * PX + p] = v[r];
    rbeg_out[p] = rbeg;
  }
  const int32_t* rc = codes + (long long)b * L;
  int32_t* ql_row = q_l + (long long)p * L;
  int32_t* qr_row = q_r + (long long)p * L;
  for (int j = lane; j < L; j += WARP) {
    ql_row[j] = rc[min(max(qbeg - 1 - j, 0), L - 1)];
    qr_row[j] = rc[min(max(qe + j, 0), L - 1)];
  }
  const long long top = 2 * o.l_pac - 1;
  int32_t* tl_row = t_l + (long long)p * TL;
  int32_t* tr_row = t_r + (long long)p * TL;
  for (int j = lane; j < TL; j += WARP) {
    tl_row[j] = ref[min(max(rbeg - 1 - j, 0LL), top)];
    tr_row[j] = ref[min(max(re0 + j, 0LL), top)];
  }
}

// The band phases. st: the stage's rows; res1 / res2: the round-1 and
// round-2 BSW outputs [6][PX] (res2 read by phases 1 and 3); lf / rb:
// phase 1's rows and rb (read by phases 2 and 3). Phases 0 and 2 write
// `bl` [2][PX]; phase 1 `lf_out` and `rb_out`; phase 3 `fi`, `fl` and
// `packed`.
template <int PHASE, typename P>
__global__ void __launch_bounds__(BAND_THREADS) ext_band_kernel(
    const int32_t* __restrict__ st, const long long* __restrict__ rbeg,
    const uint8_t* __restrict__ p_valid, const int32_t* __restrict__ p_read,
    const int32_t* __restrict__ res1, const int32_t* __restrict__ res2,
    const int32_t* __restrict__ lf, const long long* __restrict__ rb_in,
    ChainsIn<P> ch, Opt o, int L, int TL, int PX, int32_t* __restrict__ bl,
    int32_t* __restrict__ lf_out, long long* __restrict__ rb_out,
    int32_t* __restrict__ fi, long long* __restrict__ fl,
    int32_t* __restrict__ packed, int32_t* __restrict__ flag) {
  const int p = blockIdx.x * BAND_THREADS + threadIdx.x;
  if (p >= PX) return;
  const auto row = [&](const int32_t* m, int r) {
    return m[(long long)r * PX + p];
  };
  const int accept = (o.w >> 1) + (o.w >> 2);
  const bool valid = p_valid[p];
  const int qbeg = row(st, QBEG), slen = row(st, SLEN);
  const int plens = row(st, PLENS);
  const bool do_left = valid && qbeg > 0;
  const bool do_right = valid && qbeg + slen < plens;
  bool over = false;
  if (PHASE == 0 || PHASE == 1) {
    const bool need2 = do_left && !(row(res1, B_MAXOFF) < accept);
    if (PHASE == 0) {
      bl[p] = checked(need2 ? row(st, QL) : 0, L, &over);
      bl[PX + p] = checked(need2 ? row(st, TLN) : 0, TL, &over);
    } else {
      const int32_t* r = need2 ? res2 : res1;
      const int wl = need2 ? o.w << 1 : o.w;
      const int score_l = do_left ? row(r, B_SCORE) : slen * o.a;
      const int gscore = row(r, B_GSCORE);
      const bool gs_ok = gscore <= 0 || gscore <= score_l - o.pen_clip5;
      const long long rb0 = rbeg[p];
      lf_out[(long long)L_QB * PX + p] =
          do_left && gs_ok ? qbeg - row(r, B_QLE) : 0;
      lf_out[(long long)L_SCORE * PX + p] = score_l;
      lf_out[(long long)L_TRUESC * PX + p] =
          do_left ? (gs_ok ? score_l : gscore) : slen * o.a;
      lf_out[(long long)L_W * PX + p] = do_left ? max(wl, o.w) : o.w;
      lf_out[(long long)L_BLQ * PX + p] =
          checked(do_right ? row(st, QR) : 0, L, &over);
      lf_out[(long long)L_BLT * PX + p] =
          checked(do_right ? row(st, TR) : 0, TL, &over);
      rb_out[p] = do_left ? (gs_ok ? rb0 - row(r, B_TLE)
                                   : rb0 - row(r, B_GTLE))
                          : rb0;
    }
  } else {
    const int score_l = row(lf, L_SCORE);
    const bool acc1 = row(res1, B_SCORE) == score_l ||
                      row(res1, B_MAXOFF) < accept;
    const bool need2 = do_right && !acc1;
    if (PHASE == 2) {
      bl[p] = checked(need2 ? row(st, QR) : 0, L, &over);
      bl[PX + p] = checked(need2 ? row(st, TR) : 0, TL, &over);
    } else {
      const int32_t* r = need2 ? res2 : res1;
      const int wr = need2 ? o.w << 1 : o.w;
      const int qe = qbeg + slen;
      const long long re0 = rbeg[p] + slen;
      const int score_f = do_right ? row(r, B_SCORE) : score_l;
      const int gscore = row(r, B_GSCORE);
      const bool gs_ok = gscore <= 0 || gscore <= score_f - o.pen_clip3;
      const int qe_f = do_right && gs_ok ? qe + row(r, B_QLE) : plens;
      const long long re_f =
          do_right ? re0 + (gs_ok ? row(r, B_TLE) : row(r, B_GTLE)) : re0;
      const int truesc =
          row(lf, L_TRUESC) +
          (do_right ? (gs_ok ? score_f : gscore) - score_l : 0);
      const long long a_w =
          do_right ? max((long long)row(lf, L_W), (long long)wr)
                   : (long long)row(lf, L_W);
      const int qb = row(lf, L_QB);
      const long long rb = rb_in[p];
      const int b = p_read[p];
      const long long cs = (long long)b * ch.C + row(st, SLOT);
      long long cov = 0;
      for (int s = 0; s < ch.S; ++s) {
        if (!seed_live(ch, cs, s)) continue;
        const long long i = cs * ch.S + s;
        const int q = ch.qbeg[i], l = ch.len[i];
        const long long rr = (long long)ch.rbeg[i];
        if (q >= qb && q + l <= qe_f && rr >= rb && rr + l <= re_f) cov += l;
      }
      fi[(long long)F_QE * PX + p] = qe_f;
      fi[(long long)F_SCORE * PX + p] = score_f;
      fi[(long long)F_TRUESC * PX + p] = truesc;
      fl[(long long)F_RE * PX + p] = re_f;
      fl[(long long)F_W * PX + p] = a_w;
      fl[(long long)F_SEEDCOV * PX + p] = cov;
      const int v[PACKED] = {
          (int)valid, b, qb, qe_f, score_f, truesc, (int)a_w, (int)cov,
          row(st, RID), slen, (int)(rb & 0x7FFFFFFF), (int)(rb >> 31),
          (int)(re_f & 0x7FFFFFFF), (int)(re_f >> 31)};
      int32_t* out = packed + (long long)p * PACKED;
      for (int k = 0; k < PACKED; ++k) out[k] = v[k];
    }
  }
  if (over) atomicOr(flag, 1);
}

// ---- the launchers: every pointer and integer in one int64 array `a`,
// in the order ops/extend_cuda.py packs it

template <typename P>
ChainsIn<P> chains_at(const long long* a) {
  return ChainsIn<P>{(const int32_t*)a[0], (const int32_t*)a[1],
                     (const P*)a[2],       (const int32_t*)a[3],
                     (const int32_t*)a[4], (const uint8_t*)a[5],
                     (int)a[6],            (int)a[7]};
}

Opt opt_at(const long long* a) {
  return Opt{(int)a[0], (int)a[1], (int)a[2], (int)a[3],
             (int)a[4], (int)a[5], (int)a[6], (int)a[7], a[8]};
}

constexpr int CH_ARGS = 8, OPT_ARGS = 9;

template <typename P>
int select_launch(const long long* a, cudaStream_t stream) {
  const ChainsIn<P> ch = chains_at<P>(a);
  const Opt o = opt_at(a + CH_ARGS);
  const long long* x = a + CH_ARGS + OPT_ARGS;
  const int B = (int)x[0], n_seqs = (int)x[6], R = (int)x[7];
  if (B <= 0 || ch.C <= 0 || ch.S <= 0 || R < 0 || n_seqs <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = (2 * (size_t)ch.C + SELECT_WARPS * (size_t)ch.S) * 4;
  if (bytes > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        ext_select_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ext_select_kernel<P><<<B, SELECT_WARPS * WARP, bytes, stream>>>(
      ch, (const int32_t*)x[1], (const int32_t*)x[2], (const int32_t*)x[3],
      (const int32_t*)x[4], (const long long*)x[5], n_seqs, o, R,
      (int32_t*)x[8], (int32_t*)x[9], (uint8_t*)x[10], (long long*)x[11],
      (long long*)x[12]);
  return (int)cudaGetLastError();
}

template <typename P>
int stage_launch(const long long* a, cudaStream_t stream) {
  const ChainsIn<P> ch = chains_at<P>(a);
  const Opt o = opt_at(a + CH_ARGS);
  const long long* x = a + CH_ARGS + OPT_ARGS;
  const int R = (int)x[9], L = (int)x[10], TL = (int)x[11], PX = (int)x[12];
  if (PX <= 0) return 0;
  if (L <= 0 || TL <= 0 || o.l_pac <= 0) return (int)cudaErrorInvalidValue;
  ext_stage_kernel<P><<<(PX + STAGE_WARPS - 1) / STAGE_WARPS,
                        STAGE_WARPS * WARP, 0, stream>>>(
      (const int32_t*)x[0], (const int32_t*)x[1], (const uint8_t*)x[2],
      (const int32_t*)x[3], (const long long*)x[4], (const long long*)x[5],
      ch, (const int32_t*)x[6], (const int32_t*)x[7], (const uint8_t*)x[8],
      o, R, L, TL, PX, (int32_t*)x[13], (long long*)x[14], (int32_t*)x[15],
      (int32_t*)x[16], (int32_t*)x[17], (int32_t*)x[18], (int32_t*)x[19]);
  return (int)cudaGetLastError();
}

template <int PHASE, typename P>
int band_launch_t(const long long* a, cudaStream_t stream) {
  const ChainsIn<P> ch = chains_at<P>(a);
  const Opt o = opt_at(a + CH_ARGS);
  const long long* x = a + CH_ARGS + OPT_ARGS;
  const int L = (int)x[8], TL = (int)x[9], PX = (int)x[10];
  if (PX <= 0) return 0;
  ext_band_kernel<PHASE, P><<<(PX + BAND_THREADS - 1) / BAND_THREADS,
                              BAND_THREADS, 0, stream>>>(
      (const int32_t*)x[0], (const long long*)x[1], (const uint8_t*)x[2],
      (const int32_t*)x[3], (const int32_t*)x[4], (const int32_t*)x[5],
      (const int32_t*)x[6], (const long long*)x[7], ch, o, L, TL, PX,
      (int32_t*)x[11], (int32_t*)x[12], (long long*)x[13], (int32_t*)x[14],
      (long long*)x[15], (int32_t*)x[16], (int32_t*)x[17]);
  return (int)cudaGetLastError();
}

template <typename P>
int band_launch(int phase, const long long* a, cudaStream_t stream) {
  switch (phase) {
    case 0: return band_launch_t<0, P>(a, stream);
    case 1: return band_launch_t<1, P>(a, stream);
    case 2: return band_launch_t<2, P>(a, stream);
    case 3: return band_launch_t<3, P>(a, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Each launcher takes the int64 array `a` of pointers and integers that
// ops/extend_cuda.py packs (the chains' eight, then MemOptions' nine, then
// the kernel's own), pos64 (1 for the int64 layout: the chains' rbeg
// int64) and the stream. Returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it cannot take. The caller allocates
// every buffer and checks shapes and types; nothing here synchronises.
extern "C" int ext_select_launch(const long long* a, int pos64,
                                 void* stream) {
  return pos64 ? select_launch<long long>(a, (cudaStream_t)stream)
               : select_launch<int>(a, (cudaStream_t)stream);
}

extern "C" int ext_pairs_launch(const long long* x, void* stream) {
  const int M = (int)x[3], B = (int)x[8], R = (int)x[9], PX = (int)x[10];
  if (B <= 0 || R < 0 || PX < 0) return (int)cudaErrorInvalidValue;
  ext_pairs_kernel<<<1, PAIR_THREADS, 0, (cudaStream_t)stream>>>(
      (const int32_t*)x[0], (const uint8_t*)x[1], (const int32_t*)x[2], M,
      (const uint8_t*)x[4], (const uint8_t*)x[5], (const uint8_t*)x[6],
      (const float*)x[7], B, R, PX, (int32_t*)x[11], (int32_t*)x[12],
      (uint8_t*)x[13], (uint8_t*)x[14], (uint8_t*)x[15], (uint8_t*)x[16],
      (float*)x[17], (int32_t*)x[18]);
  return (int)cudaGetLastError();
}

extern "C" int ext_stage_launch(const long long* a, int pos64,
                                void* stream) {
  return pos64 ? stage_launch<long long>(a, (cudaStream_t)stream)
               : stage_launch<int>(a, (cudaStream_t)stream);
}

extern "C" int ext_band_launch(int phase, const long long* a, int pos64,
                               void* stream) {
  return pos64 ? band_launch<long long>(phase, a, (cudaStream_t)stream)
               : band_launch<int>(phase, a, (cudaStream_t)stream);
}
