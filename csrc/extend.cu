// The extension stage's glue for Hopper (sm_90a): what seed_chain_extend
// does from the chain filter's outputs to its returned dict, with no host
// synchronisation and no tensor operation between the launches but the
// outputs' allocations. The stage on a CUDA batch is seven launches:
// ext_select_kernel, ext_pairs_kernel, ext_stage_kernel, then the four
// BSW rounds (left round 1, left round 2, right round 1, right round 2),
// each a bsw_band_kernel launch: BSW's warp body (csrc/bsw_warp.cuh, the
// DP of csrc/bsw.cu) with the band-doubling work of the round that
// follows it as the warp's epilogue. Their plain versions are
// bwa_mem_scale_tpu_torch/ops/extend.py's functions (the port's earlier
// eager torch glue, moved; ext_bsw_band is ops/bsw.py's banded_swa_rows
// then ext_band); ops/extend_cuda.py wraps the kernels and holds their
// CPU twins. The JAX package runs this as part of one traced program
// (bwa_mem_scale_tpu/pipeline/align.py:202-509), as rank arithmetic,
// one-hot compaction and gathered windows because XLA on a TPU gathers
// per element slowly; on the card each read's candidates and each pair's
// fields are a loop, and the loop is a kernel.
//
// ---- ext_select_kernel (candidates and rmax; a block a read)
// Replaces JAX align.py:202-329 (the port's align.py:244-311 before these
// kernels): a dense [B, C, S] argsort, scatter and gathers, then rmax with
// its bridging and contig clamp. Its first design (a warp a chain slot,
// one slot after another) took 0.0205 ms on a 512-read batch and 0.0088
// on one read on an H100, 64x its bytes bound: each slot was a chain of
// dependent trips (n_seeds, then the seed fields it guards, reductions,
// lane 0 reloading the first live seed's rbeg, lane 0's binary search
// over the contig offsets one load a probe, then two more loads), and
// the batch took two waves of blocks. Most slots hold no chain (phase
// 5's batch: one live chain a read of 64 slots); this design spends a
// load and two stores on such a slot:
// - the block is 8, 16 or 32 warps (the launcher's pick: as many as keep
//   the batch in one wave, at 64 registers a thread); a warp takes its
//   chain slots 32 at a time, a lane a slot: their n_seeds in one load,
//   and a chain with no seed written at once (rmax [2 l_pac, 0), exact
//   while the offsets lie in [0, 2 l_pac]; live seeds need the others);
// - the other chains as items (slot, chunk of 32 seeds up to the chain's
//   n_seeds, or all S under the seed-SW filter's mask), the loads of
//   SELECT_ITEMS items issued at once (qbeg, len, rbeg and, where they
//   are staged, the scores), masking dead seeds afterwards (two items:
//   at four ptxas spilled the loads' registers past 64 a thread);
// - the live count and the first live seed come from single-instruction
//   warp reductions, and the first live seed's rbeg from the lane that
//   loaded it (a shuffle, no reload);
// - the contig search is a 32-way search by the warp, the lanes probing
//   at once (one round for up to 32 contigs, two up to 1,024); the
//   offsets at the answer and past it come from the probes, so no load
//   follows the search;
// - the live counts are scanned by the block (csrc/block_scan.cuh), each
//   thread over its run of positions; each kept chain with a live seed
//   has its seeds ranked by counting the keys above each (valid keys are
//   distinct), from shared memory: the keys staged in phase A where C x S
//   fits SELECT_KEYS, else the chain's scores loaded when it is ranked.
// The slots past min(n_cand, R) get 0, as the plain version's scatter
// leaves them. Tier 2 (C = 1,024, S = 256) is 262,144 seed slots a read.
// Bound: the live seeds' qbeg, len and rbeg read once, the rmax rows and
// sel written once (bytes); a few microseconds at the default widths.
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
// ---- bsw_band_kernel (BSW with the band-doubling picks; a warp a pair)
// Replaces JAX align.py:410-509 (the port's align.py:359-431: the where /
// pick chains between the BSW calls, the [PX, S] coverage gather and two
// stacks) and runs BSW (bwa_mem_scale_tpu/ops/bsw_pallas.py:56
// _bsw_kernel's port) in the same launch. Warp p of a BSW launch owns pair
// p and ends with the pair's six results in its registers; the picks read
// only that pair's rows, so the warp goes on to them after it stores the
// rows (the epilogue, BandEpilogue): phase 0 after left round 1, the
// round-2 lengths of the pairs whose max_off reached the acceptance band;
// phase 1 after left round 2, the pick, score_l, qb, rb, truesc, the band
// and the right round-1 lengths (h0 = score_l); phase 2 after right round
// 1, the round-2 lengths; phase 3 after right round 2, the pick, qe, re,
// truesc and the band, the seed coverage (the lanes over the pair's
// chain's S seeds, a warp sum), the packed [PX, 14] row (int64 positions
// in 31-bit halves) and every per-pair field of the dict at the plain
// path's dtype. The round's own results come from the registers, the
// earlier round's from its rows. The picks were a kernel of their own
// (ext_band_kernel, a thread a pair) launched after each BSW call: a few
// loads and stores a pair, whose time was a bare launch's (2.3-2.9 us,
// 7.1 for phase 3's coverage loop), so the design that moves them is to
// launch them no more. The phase and the chains' position width are run
// time arguments: the instantiations are BSW's (K columns a lane,
// csrc/bsw_warp.cuh's list, and the tiled form) once more, no more.
// Bound: BSW's (its DP's operations or its bytes) plus the pair's stage
// and BSW rows read and its outputs written, and in phase 3 its chain's
// live seeds.
//
// ---- the BSW length check
// ops/bsw_cuda.py::banded_swa_batch_cuda checks each call's lengths
// against its rows with a host synchronisation. On this path the kernels
// that write a BSW round's lengths (ext_stage_kernel, the epilogue's
// phases 0-2) test the same bound, OR 1 into the flag word on a length
// past its row, and hand BSW the length clamped to the row, so BSW never
// reads past it; fetch_extend raises with the check's message after its
// copy.
//
// ext_select_kernel and ext_stage_kernel are templates on the position
// type P (int, or long long for the int64 layout); the epilogue reads the
// chains' rbeg at the width the launch names. Only the chains' rbeg is P;
// the spans, rb and re are int64 and everything else int32 (flags as
// bytes). Each output element is written once.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "bsw_warp.cuh"

namespace {

using scan::FULL;
using scan::WARP;

constexpr int SELECT_MAX_WARPS = 32;     // ext_select_kernel: warps a read
constexpr int SELECT_ITEMS = 2;          // (slot, chunk) loads in flight
constexpr int SELECT_KEYS = 8192;        // C x S keys staged in phase A
constexpr int PAIR_THREADS = 1024;       // ext_pairs_kernel's one block
constexpr int STAGE_WARPS = 8;           // ext_stage_kernel: pairs a block
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
  bool small;                // q x a - o in int32 for |q| <= 2^20 (opt_at)
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

// _cal_max_gap in int64 (C division truncates, as torch's "trunc"); in
// int32 where q x a - o fits it (the same quotients, without the 64-bit
// division's call)
__device__ __forceinline__ long long max_gap(long long q, const Opt& o) {
  long long l_del, l_ins;
  if (o.small && q >= -(1 << 20) && q <= (1 << 20)) {
    const int qi = (int)q;
    l_del = (qi * o.a - o.o_del) / o.e_del + 1;
    l_ins = (qi * o.a - o.o_ins) / o.e_ins + 1;
  } else {
    l_del = (q * o.a - o.o_del) / o.e_del + 1;
    l_ins = (q * o.a - o.o_ins) / o.e_ins + 1;
  }
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

__device__ __forceinline__ long long warp_sum64(long long v) {
  for (int d = WARP / 2; d; d >>= 1) v += __shfl_xor_sync(FULL, v, d);
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

// A block a read, blockDim.x / 32 warps (8, 16 or 32). Shared memory:
// live_of, base, ord and nss [C] each, then the keys: [C][S] when C x S
// <= SELECT_KEYS (staged in phase A), else [warps][S] (a chain's at a
// time).
template <typename P>
__global__ void __launch_bounds__(SELECT_MAX_WARPS * WARP) ext_select_kernel(
    ChainsIn<P> ch, const int32_t* __restrict__ order,
    const int32_t* __restrict__ kept, const int32_t* __restrict__ score,
    const int32_t* __restrict__ lens, const long long* __restrict__ offsets,
    int n_seqs, Opt o, int R, int32_t* __restrict__ n_cand,
    int32_t* __restrict__ sel, uint8_t* __restrict__ reg_of,
    long long* __restrict__ rmax0, long long* __restrict__ rmax1) {
  constexpr int U = SELECT_ITEMS;
  extern __shared__ int smem[];
  __shared__ int warp_inc[WARP];
  const int C = ch.C, S = ch.S;
  const int nt = blockDim.x, nw = nt / WARP;
  const int tid = threadIdx.x, lane = tid & (WARP - 1), w = tid / WARP;
  const bool staged = (long long)C * S <= SELECT_KEYS;
  int* live_of = smem;                   // [C] live seeds by slot
  int* base = live_of + C;               // [C] first rank by position
  int* ord = base + C;                   // [C] slot by position, -1 unkept
  int* nss = ord + C;                    // [C] n_seeds by slot
  int* keys = nss + C;
  const int b = blockIdx.x;
  const long long bc = (long long)b * C;
  const long long l_pac = o.l_pac, l_pac2 = 2 * o.l_pac;
  const long long rlen = lens[b];
  // phase B's inputs, a thread's first position in registers until phase
  // A is done, the rest (C past the block's threads) stored now
  const int my_kept = tid < C ? kept[bc + tid] : 0;
  const int my_order = tid < C ? order[bc + tid] : 0;
  for (int p = tid + nt; p < C; p += nt)
    ord[p] = kept[bc + p] > 0 ? order[bc + p] : -1;
  const long long off0 = offsets[0];
  const long long off1 = n_seqs > 1 ? offsets[1] : l_pac;
  // with the offsets in [0, l_pac2] (a valid index's), a chain with no
  // live seed spans [l_pac2, 0) whatever its contig
  const bool dead_known =
      off0 >= 0 && offsets[n_seqs - 1] <= l_pac2 && l_pac >= 0;
  int top = 1;                           // the contig search's first stride
  while ((long long)top * WARP < n_seqs) top *= WARP;

  // A: each chain's live count and rmax. A warp takes its slots w, w +
  // nw, ... 32 at a time, a lane a slot: the slots' seed counts in one
  // load, a chain with none written at once; the others as items (slot,
  // chunk of 32 seeds, up to its last seed), U items a load round, every
  // load of a round issued before any is used (S <= 32: U chains at
  // once); a chain reduced, searched and written at its last chunk
  const int nch = (S + WARP - 1) / WARP;
  const int slots = (C + nw - 1) / nw;
  const auto walk = [&](int ns) {        // chunks a chain walks
    return ch.live ? nch : ns > 0 ? (min(ns, S) + WARP - 1) / WARP : 1;
  };
  for (int win = 0; win < slots; win += WARP) {
    const int cw = w + (win + lane) * nw;
    const bool mine = win + lane < slots && cw < C;
    const int ns_l = mine && !ch.live ? ch.n_seeds[bc + cw] : 0;
    const bool todo = mine && (ch.live || ns_l > 0 || !dead_known);
    if (mine) {
      nss[cw] = ns_l;
      if (!todo) {
        rmax0[bc + cw] = l_pac2;
        rmax1[bc + cw] = 0;
        live_of[cw] = 0;
      }
    }
    unsigned m = __ballot_sync(FULL, todo);
    int k0 = 0;                          // the chunk of the round's first item
    long long v0 = LLONG_MAX, v1 = LLONG_MIN, frb = 0;
    int nl = 0, fm = S;
    while (m) {                          // warp-uniform
      int q[U], l[U], sc[U];
      long long r[U];
      bool lv[U];
      unsigned mm = m;
#pragma unroll
      for (int u = 0, k = k0; u < U; ++u) {
        const int j = mm ? __ffs(mm) - 1 : 0;
        const int c = w + (win + j) * nw;
        const int ns = __shfl_sync(FULL, ns_l, j);
        const int s = k * WARP + lane;
        const bool in = mm && s < S && (ch.live || s < ns);
        const long long i = (bc + c) * S + s;
        q[u] = in ? ch.qbeg[i] : 0;
        l[u] = in ? ch.len[i] : 0;
        r[u] = in || (mm && s == 0) ? (long long)ch.rbeg[i] : 0;
        sc[u] = in && staged ? score[i] : 0;
        lv[u] = in && (!ch.live || ch.live[i] != 0);
        if (++k == walk(ns)) k = 0, mm &= mm - 1;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (!m) break;                   // warp-uniform
        const int j = __ffs(m) - 1;
        const int c = w + (win + j) * nw;
        const int ns = __shfl_sync(FULL, ns_l, j);
        const int s = k0 * WARP + lane;
        if (k0 == 0) v0 = LLONG_MAX, v1 = LLONG_MIN, frb = 0, nl = 0, fm = S;
        if (s < S) {
          if (lv[u]) {
            const long long qq = q[u], ll = l[u];
            const long long flank = rlen - qq - ll;
            v0 = min(v0, r[u] - (qq + max_gap(qq, o)));
            v1 = max(v1, r[u] + ll + flank + max_gap(flank, o));
          } else {
            v0 = min(v0, l_pac2);
            v1 = max(v1, 0LL);
          }
          nl += lv[u];
          if (fm == S) {                 // the lane's first live seed, and
            if (lv[u]) fm = s;           // lane 0's seed 0 (the rbeg of a
            if (lv[u] || s == 0) frb = r[u];  // chain with none live)
          }
          if (staged)
            keys[c * S + s] =
                lv[u] ? (int)(((uint32_t)sc[u] << 16) | (uint32_t)s) : -1;
        }
        if (++k0 < walk(ns)) continue;
        k0 = 0;
        m &= m - 1;
        // the chain's last chunk: the seeds not walked are dead ones
        if (!ch.live && ns < S) {
          v0 = min(v0, l_pac2);
          v1 = max(v1, 0LL);
        }
        const int nlive = __reduce_add_sync(FULL, nl);
        if (nlive == 0 && dead_known) {  // warp-uniform
          if (lane == 0) {
            rmax0[bc + c] = l_pac2;
            rmax1[bc + c] = 0;
            live_of[c] = 0;
          }
          continue;
        }
        const long long m0r = warp_min(v0), m1r = warp_max(v1);
        const int first = (int)__reduce_min_sync(FULL, (unsigned)fm);
        const long long fr =
            __shfl_sync(FULL, frb, first == S ? 0 : first & (WARP - 1));
        const bool rev = fr >= l_pac;
        const long long pf = rev ? l_pac2 - 1 - fr : fr;
        // ub, the first offset above pf, by a 32-way search (lane l probes
        // ub + (l + 1) st - 1); the largest probe at or below pf and the
        // least above it end as offsets[ub - 1] and offsets[ub]
        int ub = 0;
        long long below = off0, above = off1;
        for (int st = top; st > 0; st /= WARP) {
          const long long idx = ub + (long long)(lane + 1) * st - 1;
          const bool ok = idx < n_seqs;
          const long long v = ok ? __ldg(offsets + idx) : 0;
          const int kk = __popc(__ballot_sync(FULL, ok && v <= pf));
          const long long vb = __shfl_sync(FULL, v, max(kk - 1, 0));
          const long long va = __shfl_sync(FULL, v, min(kk, WARP - 1));
          const bool oka = __shfl_sync(FULL, (int)ok, min(kk, WARP - 1));
          if (kk) below = vb;
          if (kk < WARP && oka) above = va;
          ub += kk * st;
        }
        if (lane != 0) continue;
        long long m0 = max(m0r, 0LL), m1 = min(m1r, l_pac2);
        const bool bridging = m0 < l_pac && l_pac < m1;
        if (bridging && !rev) m1 = l_pac;
        if (bridging && rev) m0 = l_pac;
        // the contig of the first seed: the offsets at or below its forward
        // position, less one (none past l_pac), at least 0
        const bool zero = pf >= l_pac || ub <= 1;
        const long long fb = zero ? off0 : below;
        const long long fe = zero ? off1 : ub < n_seqs ? above : l_pac;
        rmax0[bc + c] = max(m0, rev ? l_pac2 - fe : fb);
        rmax1[bc + c] = min(m1, rev ? l_pac2 - fb : fe);
        live_of[c] = nlive;
      }
    }
  }
  if (tid < C) ord[tid] = my_kept > 0 ? my_order : -1;
  __syncthreads();
  // B: the kept chains' first ranks in the filter's order, a thread a run
  // of positions, scanned by the block
  const int run = (C + nt - 1) / nt, p0 = min(tid * run, C);
  const int p1 = min(p0 + run, C);
  int v = 0;
  for (int p = p0; p < p1; ++p) v += ord[p] >= 0 ? live_of[ord[p]] : 0;
  int total;
  int at = scan::block_inclusive(v, warp_inc, &total) - v;
  for (int p = p0; p < p1; ++p) {
    base[p] = at;
    at += ord[p] >= 0 ? live_of[ord[p]] : 0;
  }
  if (tid == 0) {
    n_cand[b] = total;
    reg_of[b] = total > R;
  }
  __syncthreads();
  // C: each kept chain's live seeds by rank (a live key is never -1: its
  // low 16 bits are its seed index, below S). Staged without a seed-SW
  // mask, a chain's keys stop at its n_seeds: the dead keys past it (-1)
  // are counted at once
  int* wk = keys + w * S;
  for (int p = w; p < C; p += nw) {
    const int slot = ord[p], bp0 = base[p];
    if (slot < 0 || bp0 >= R || !live_of[slot]) continue;  // warp-uniform
    const long long cs = bc + slot;
    const int* kk = keys + slot * S;
    int lim = S;
    if (!staged) {
#pragma unroll 4
      for (int s = lane; s < S; s += WARP)
        wk[s] = seed_live(ch, cs, s)
                    ? (int)(((uint32_t)score[cs * S + s] << 16) | (uint32_t)s)
                    : -1;
      __syncwarp();
      kk = wk;
    } else if (!ch.live) {
      lim = min(nss[slot], S);
    }
    for (int s = lane; s < lim; s += WARP) {
      const int k = kk[s];
      if (k == -1) continue;
      int rank = k < -1 ? S - lim : 0;
      for (int t = 0; t < lim; ++t) rank += kk[t] > k;
      if (bp0 + rank < R) sel[(long long)b * R + bp0 + rank] = slot * S + s;
    }
    __syncwarp();                        // wk is rewritten next chain
  }
  // D: the slots past the candidates
  for (int r = min(total, R) + tid; r < R; r += nt)
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

// The band epilogue's inputs and outputs. st: the stage's rows; res1:
// the round-1 BSW rows [6][PX] (read by phases 1 and 3, whose own round
// is round 2); lf / rb_in: phase 1's rows and rb (read by phases 2 and
// 3); the chains (phase 3's coverage), their rbeg int or long long as
// pos64 says. Phases 0 and 2 write `bl` [2][PX]; phase 1 `lf_out` and
// `rb_out`; phase 3 `fi`, `fl` and `packed`.
struct Band {
  int phase, pos64, PX, L, TL;
  Opt o;
  const int32_t* c_qbeg;     // [B][C][S]
  const int32_t* c_len;      // [B][C][S]
  const void* c_rbeg;        // [B][C][S], int or long long
  const int32_t* n_seeds;    // [B][C]
  const uint8_t* live;       // [B][C][S], or null: the first n_seeds
  int C, S;
  const int32_t* st;
  const long long* rbeg;
  const uint8_t* valid;
  const int32_t* read;
  const int32_t* res1;
  const int32_t* lf;
  const long long* rb_in;
  int32_t* bl;
  int32_t* lf_out;
  long long* rb_out;
  int32_t* fi;
  long long* fl;
  int32_t* packed;
  int32_t* flag;
};

struct Res {                 // a pair's six BSW results
  int score, qle, tle, gtle, gscore, max_off;
};

__device__ __forceinline__ Res res_of(const bsw::Best& x) {
  return Res{x.max_sc, x.max_j + 1, x.max_i + 1, x.max_ie + 1, x.gscore,
             x.max_off};
}

__device__ __forceinline__ Res res_at(const int32_t* m, int PX, int p) {
  return Res{m[p], m[PX + p], m[2 * PX + p], m[3 * PX + p], m[4 * PX + p],
             m[5 * PX + p]};
}

// Phase e.phase of the band-doubling retries for pair p, after the BSW
// round it follows stored the pair's result `best`: every lane of the
// pair's warp computes the pair's fields (each load one address, a
// broadcast), phase 3's lanes share the coverage, lane 0 writes.
__device__ __forceinline__ void band_epilogue(const Band& e,
                                              const bsw::Best& best, int p,
                                              int lane) {
  const int PX = e.PX;
  const Opt& o = e.o;
  const auto row = [&](const int32_t* m, int r) {
    return m[(long long)r * PX + p];
  };
  const Res cur = res_of(best);
  const int accept = (o.w >> 1) + (o.w >> 2);
  const bool valid = e.valid[p];
  const int qbeg = row(e.st, QBEG), slen = row(e.st, SLEN);
  const int plens = row(e.st, PLENS);
  const bool do_left = valid && qbeg > 0;
  const bool do_right = valid && qbeg + slen < plens;
  bool over = false;
  if (e.phase == 0) {
    const bool need2 = do_left && !(cur.max_off < accept);
    const int blq = checked(need2 ? row(e.st, QL) : 0, e.L, &over);
    const int blt = checked(need2 ? row(e.st, TLN) : 0, e.TL, &over);
    if (lane == 0) {
      e.bl[p] = blq;
      e.bl[PX + p] = blt;
    }
  } else if (e.phase == 1) {
    const Res r1 = res_at(e.res1, PX, p);
    const bool need2 = do_left && !(r1.max_off < accept);
    const Res r = need2 ? cur : r1;
    const int wl = need2 ? o.w << 1 : o.w;
    const int score_l = do_left ? r.score : slen * o.a;
    const bool gs_ok = r.gscore <= 0 || r.gscore <= score_l - o.pen_clip5;
    const long long rb0 = e.rbeg[p];
    const int v[LF_ROWS] = {
        do_left && gs_ok ? qbeg - r.qle : 0, score_l,
        do_left ? (gs_ok ? score_l : r.gscore) : slen * o.a,
        do_left ? max(wl, o.w) : o.w,
        checked(do_right ? row(e.st, QR) : 0, e.L, &over),
        checked(do_right ? row(e.st, TR) : 0, e.TL, &over)};
    if (lane == 0) {
      for (int k = 0; k < LF_ROWS; ++k)
        e.lf_out[(long long)k * PX + p] = v[k];
      e.rb_out[p] = do_left ? (gs_ok ? rb0 - r.tle : rb0 - r.gtle) : rb0;
    }
  } else {
    const int score_l = row(e.lf, L_SCORE);
    const Res r1 = e.phase == 2 ? cur : res_at(e.res1, PX, p);
    const bool acc1 = r1.score == score_l || r1.max_off < accept;
    const bool need2 = do_right && !acc1;
    if (e.phase == 2) {
      const int blq = checked(need2 ? row(e.st, QR) : 0, e.L, &over);
      const int blt = checked(need2 ? row(e.st, TR) : 0, e.TL, &over);
      if (lane == 0) {
        e.bl[p] = blq;
        e.bl[PX + p] = blt;
      }
    } else {
      const Res r = need2 ? cur : r1;
      const int wr = need2 ? o.w << 1 : o.w;
      const int qe = qbeg + slen;
      const long long re0 = e.rbeg[p] + slen;
      const int score_f = do_right ? r.score : score_l;
      const bool gs_ok =
          r.gscore <= 0 || r.gscore <= score_f - o.pen_clip3;
      const int qe_f = do_right && gs_ok ? qe + r.qle : plens;
      const long long re_f =
          do_right ? re0 + (gs_ok ? r.tle : r.gtle) : re0;
      const int truesc =
          row(e.lf, L_TRUESC) +
          (do_right ? (gs_ok ? score_f : r.gscore) - score_l : 0);
      const long long lw = row(e.lf, L_W);
      const long long a_w = do_right ? max(lw, (long long)wr) : lw;
      const int qb = row(e.lf, L_QB);
      const long long rb = e.rb_in[p];
      const int b = e.read[p];
      const long long cs = (long long)b * e.C + row(e.st, SLOT);
      // the seed coverage: the lanes over the chain's seeds, a warp sum
      const int ns = e.live ? 0 : e.n_seeds[cs];
      long long cov = 0;
      for (int s = lane; s < e.S; s += WARP) {
        const long long i = cs * e.S + s;
        if (e.live ? !e.live[i] : s >= ns) continue;
        const int q = e.c_qbeg[i], l = e.c_len[i];
        const long long rr = e.pos64 ? ((const long long*)e.c_rbeg)[i]
                                     : ((const int*)e.c_rbeg)[i];
        if (q >= qb && q + l <= qe_f && rr >= rb && rr + l <= re_f) cov += l;
      }
      cov = warp_sum64(cov);
      if (lane == 0) {
        e.fi[(long long)F_QE * PX + p] = qe_f;
        e.fi[(long long)F_SCORE * PX + p] = score_f;
        e.fi[(long long)F_TRUESC * PX + p] = truesc;
        e.fl[(long long)F_RE * PX + p] = re_f;
        e.fl[(long long)F_W * PX + p] = a_w;
        e.fl[(long long)F_SEEDCOV * PX + p] = cov;
        const int v[PACKED] = {
            (int)valid, b, qb, qe_f, score_f, truesc, (int)a_w, (int)cov,
            row(e.st, RID), slen, (int)(rb & 0x7FFFFFFF), (int)(rb >> 31),
            (int)(re_f & 0x7FFFFFFF), (int)(re_f >> 31)};
        int32_t* out = e.packed + (long long)p * PACKED;
        for (int k = 0; k < PACKED; ++k) out[k] = v[k];
      }
    }
  }
  if (over && lane == 0) atomicOr(e.flag, 1);
}

struct BandEpilogue {        // inline, in the register and shared forms
  Band e;
  __device__ void operator()(const bsw::Best& best, int p, int lane) const {
    band_epilogue(e, best, p, lane);
  }
};

// The tiled form calls the epilogue out of line: inlined, it changed the
// tiled row step's register allocation and slowed it on long reads. The
// call reads the kernel's Band parameter in place (__grid_constant__),
// not a copy of it in local memory.
__device__ __noinline__ void band_epilogue_call(const Band& e,
                                                const bsw::Best& best, int p,
                                                int lane) {
  band_epilogue(e, best, p, lane);
}

struct BandEpilogueCall {
  const Band& e;
  __device__ void operator()(const bsw::Best& best, int p, int lane) const {
    band_epilogue_call(e, best, p, lane);
  }
};

// BSW's warp body with the band epilogue: one instantiation for each of
// csrc/bsw.cu's (K columns a lane), and the tiled form
template <int K, bool SMEM>
__global__ void __launch_bounds__(bsw::WARPS * 32)
bsw_band_kernel(const int32_t* __restrict__ qs,      // [P, QL]
                const int32_t* __restrict__ ts,      // [P, TL]
                const int32_t* __restrict__ q_lens,  // [P]
                const int32_t* __restrict__ t_lens,  // [P]
                const int32_t* __restrict__ h0s,     // [P]
                int32_t* __restrict__ out,           // [6, P]
                int P, int QL, int TL, bsw::Pen pen, Band band) {
  bsw::warp_body<K, SMEM>(qs, ts, q_lens, t_lens, h0s, out, P, QL, TL, pen,
                          BandEpilogue{band});
}

__global__ void __launch_bounds__(bsw::WARPS * 32)
bsw_band_tiled_kernel(const int32_t* __restrict__ qs,
                      const int32_t* __restrict__ ts,
                      const int32_t* __restrict__ q_lens,
                      const int32_t* __restrict__ t_lens,
                      const int32_t* __restrict__ h0s,
                      int32_t* __restrict__ out,
                      int32_t* __restrict__ scratch, int P, int QL, int TL,
                      bsw::Pen pen, const __grid_constant__ Band band) {
  bsw::tiled_body(qs, ts, q_lens, t_lens, h0s, out, scratch, P, QL, TL, pen,
                  BandEpilogueCall{band});
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
  const auto within = [](long long v, long long m) {
    return v >= -m && v <= m;
  };
  return Opt{(int)a[0], (int)a[1], (int)a[2], (int)a[3],
             (int)a[4], (int)a[5], (int)a[6], (int)a[7], a[8],
             within(a[0], 1 << 10) && within(a[2], 1 << 20) &&
                 within(a[4], 1 << 20)};
}

constexpr int CH_ARGS = 8, OPT_ARGS = 9;

template <typename P>
int select_launch(const long long* a, cudaStream_t stream) {
  const ChainsIn<P> ch = chains_at<P>(a);
  const Opt o = opt_at(a + CH_ARGS);
  const long long* x = a + CH_ARGS + OPT_ARGS;
  const int B = (int)x[0], n_seqs = (int)x[6], R = (int)x[7];
  const int warps = (int)x[13];
  if (B <= 0 || ch.C <= 0 || ch.S <= 0 || ch.S >= (1 << 16) || R < 0 ||
      n_seqs <= 0 || warps <= 0 || warps > SELECT_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const size_t keys = (size_t)ch.C * ch.S <= SELECT_KEYS
                          ? (size_t)ch.C * ch.S : (size_t)warps * ch.S;
  const size_t bytes = (4 * (size_t)ch.C + keys) * 4;
  if (bytes + 4 * WARP > SMEM_DEFAULT) {     // warp_inc is static
    const cudaError_t e = cudaFuncSetAttribute(
        ext_select_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  ext_select_kernel<P><<<B, warps * WARP, bytes, stream>>>(
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

template <int K, bool SMEM>
int bsw_band_launch_k(const int32_t* q, const int32_t* t, const int32_t* ql,
                      const int32_t* tl, const int32_t* h0, int32_t* out,
                      int P, int QL, int TL, const bsw::Pen& pen,
                      const Band& band, cudaStream_t stream) {
  const int grid = (P + bsw::WARPS - 1) / bsw::WARPS;
  bsw_band_kernel<K, SMEM><<<grid, bsw::WARPS * 32, 0, stream>>>(
      q, t, ql, tl, h0, out, P, QL, TL, pen, band);
  return (int)cudaGetLastError();
}

int bsw_band_launch(const long long* a, cudaStream_t stream) {
  const Opt o = opt_at(a + CH_ARGS);
  const long long* x = a + CH_ARGS + OPT_ARGS;
  const int phase = (int)x[0], L = (int)x[9], TL = (int)x[10];
  const int PX = (int)x[11], k = (int)x[24];
  if (PX <= 0) return 0;
  if (phase < 0 || phase > 3 || L <= 0 || TL <= 0 ||
      (k == 0 ? x[32] == 0 : 32 * k < L + 1))
    return (int)cudaErrorInvalidValue;
  const Band band{phase, (int)x[1], PX, L, TL, o,
                  (const int32_t*)a[0], (const int32_t*)a[1],
                  (const void*)a[2], (const int32_t*)a[3],
                  (const uint8_t*)a[5], (int)a[6], (int)a[7],
                  (const int32_t*)x[2], (const long long*)x[3],
                  (const uint8_t*)x[4], (const int32_t*)x[5],
                  (const int32_t*)x[6], (const int32_t*)x[7],
                  (const long long*)x[8], (int32_t*)x[12], (int32_t*)x[13],
                  (long long*)x[14], (int32_t*)x[15], (long long*)x[16],
                  (int32_t*)x[17], (int32_t*)x[18]};
  const bsw::Pen pen{(int)x[25], o.o_del, o.e_del, o.o_ins, o.e_ins,
                     (int)x[26], (int)x[27], (int)x[28], (int)x[29],
                     (int)x[30], (int)x[31]};
  const auto* q = (const int32_t*)x[19];
  const auto* t = (const int32_t*)x[20];
  const auto* lens = (const int32_t*)x[21];
  const auto* h0 = (const int32_t*)x[22];
  auto* out = (int32_t*)x[23];
  if (k == 0) {
    bsw_band_tiled_kernel<<<(PX + bsw::WARPS - 1) / bsw::WARPS,
                            bsw::WARPS * 32, 0, stream>>>(
        q, t, lens, lens + PX, h0, out, (int32_t*)x[32], PX, L, TL, pen,
        band);
    return (int)cudaGetLastError();
  }
  switch (k) {
#define BAND_CASE(KK, SM)                                                   \
  case KK:                                                                  \
    return bsw_band_launch_k<KK, SM>(q, t, lens, lens + PX, h0, out, PX, L, \
                                     TL, pen, band, stream);
    BSW_INSTANTIATIONS(BAND_CASE)
#undef BAND_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Each launcher takes the int64 array `a` of pointers and integers that
// ops/extend_cuda.py packs (the chains' eight, then MemOptions' nine, then
// the kernel's own), pos64 (1 for the int64 layout: the chains' rbeg
// int64; ext_bsw_band_launch reads it from `a`) and the stream. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it cannot take. The caller allocates every buffer and checks shapes
// and types; nothing here synchronises.
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

// One BSW round of the extension with its band phase: `a` also holds the
// phase (0-3, the round: left 1, left 2, right 1, right 2), the round's
// windows, lengths, h0 and band, and BSW's K (0: the tiled form on the
// scratch that follows).
extern "C" int ext_bsw_band_launch(const long long* a, void* stream) {
  return bsw_band_launch(a, (cudaStream_t)stream);
}
