// The banded Smith-Waterman warp body of csrc/bsw.cu, shared by two
// sources: csrc/bsw.cu wraps it in bsw_warp_kernel / bsw_tiled_kernel
// with no epilogue (the standalone BSW, ops/bsw_cuda.py), and
// csrc/extend.cu in bsw_band_kernel / bsw_band_tiled_kernel with the
// extension's band epilogue (the band-doubling picks of the pair, run by
// the pair's warp after its result is stored). The design notes are
// csrc/bsw.cu's. An epilogue is a functor called as epi(best, p, lane)
// by every lane of warp p; `NoEpilogue` compiles to nothing, so the
// standalone kernels are the same code as before the body moved here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace bsw {


constexpr int WARPS = 4;               // pairs (warps) per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 30);
constexpr int BIG = 1 << 30;

struct Pen {
  int w, o_del, e_del, o_ins, e_ins, zdrop, sc_match, sc_mis, sc_n, mx,
      end_bonus;
};

// Lane l's K columns (l*K + k) of eh_h, eh_e and the query codes, in
// registers ...
template <int K, bool SMEM>
struct Cols {
  int h[K], e[K], q[K];
  __device__ explicit Cols(int*) {}
  __device__ int& H(int k) { return h[k]; }
  __device__ int& E(int k) { return e[k]; }
  __device__ int& Q(int k) { return q[k]; }
};

// ... or in the warp's slice of shared memory, [3][K][32]
template <int K>
struct Cols<K, true> {
  int* s;
  __device__ explicit Cols(int* warp_smem)
      : s(warp_smem + (threadIdx.x & 31)) {}
  __device__ int& H(int k) { return s[k * 32]; }
  __device__ int& E(int k) { return s[(K + k) * 32]; }
  __device__ int& Q(int k) { return s[(2 * K + k) * 32]; }
};

__device__ __forceinline__ int clamp_code(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

// M = H(i-1, j-1) + score, or 0 where H(i-1, j-1) is 0
__device__ __forceinline__ int cell_m(int hv, int qc, int tb, int tn,
                                      const Pen& pen) {
  // branch-free score: built by nvcc 12.9 (-O3, sm_90a), a select-chain
  // form of this line next to an in-kernel clamp of the codes scored
  // every cell as N on an H100, while -G and -Xptxas -O0 builds of it
  // were right; keep this form
  const int nn = tn | (qc == 4);
  const int eq = tb == qc;
  const int sc = nn * pen.sc_n + (1 - nn) * (eq * pen.sc_match
                                             + (1 - eq) * pen.sc_mis);
  return hv ? hv + sc : 0;
}

// the band, clamped to the largest feasible gap (ops/bsw.py
// band_per_pair; C division truncates as rounding_mode="trunc")
__device__ __forceinline__ int band_width(const Pen& pen, int qlen) {
  const int qx = qlen * pen.mx + pen.end_bonus;
  const int w = min(max((qx - pen.o_ins) / pen.e_ins + 1, 1),
                    max((qx - pen.o_del) / pen.e_del + 1, 1));
  return min(w, pen.w);
}

// A pair's running result, updated after each row from the row's
// maximum `raw`, the last column `mj` attaining it and H at column qlen.
struct Best {
  int max_sc, max_i = -1, max_j = -1, max_ie = -1, gscore = -1, max_off = 0;

  // true when the pair stops after row i (its maximum reached 0, or
  // z-drop)
  __device__ bool row_end(int i, int en, int qlen, int raw, int mj,
                          int h1_last, const Pen& pen) {
    if (en == qlen && gscore <= h1_last) {
      max_ie = i;
      gscore = h1_last;
    }
    const int m = max(raw, 0);
    if (m == 0) return true;
    if (m > max_sc) {
      const int off = mj > i ? mj - i : i - mj;
      if (off > max_off) max_off = off;
      max_sc = m;
      max_i = i;
      max_j = mj;
    } else if (pen.zdrop > 0) {
      const int di = i - max_i, dj = mj - max_j;
      const int delta = di > dj ? max_sc - m - (di - dj) * pen.e_del
                                : max_sc - m - (dj - di) * pen.e_ins;
      if (delta > pen.zdrop) return true;
    }
    return false;
  }

  // out [6, P]; qle, tle and gtle as max_j + 1, max_i + 1, max_ie + 1
  __device__ void store(int32_t* out, int P, int p) const {
    out[p] = max_sc;
    out[P + p] = max_j + 1;
    out[2 * P + p] = max_i + 1;
    out[3 * P + p] = max_ie + 1;
    out[4 * P + p] = gscore;
    out[5 * P + p] = max_off;
  }
};

struct NoEpilogue {
  __device__ void operator()(const Best&, int, int) const {}
};

// The body of bsw_warp_kernel<K, SMEM>, with an epilogue `epi` that
// every lane of warp p runs after the pair's result is stored:
// epi(best, p, lane). Warps past P return first and run no epilogue;
// every pair below P runs it, those of zero length too.
template <int K, bool SMEM, class Epi>
__device__ __forceinline__ void warp_body(
    const int32_t* __restrict__ qs,      // [P, QL]
    const int32_t* __restrict__ ts,      // [P, TL]
    const int32_t* __restrict__ q_lens,  // [P]
    const int32_t* __restrict__ t_lens,  // [P]
    const int32_t* __restrict__ h0s,     // [P]
    int32_t* __restrict__ out,           // [6, P]
    int P, int QL, int TL, Pen pen, Epi epi) {
  __shared__ int smem[SMEM ? WARPS * 3 * K * 32 : 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= P) return;                       // whole warps only
  Cols<K, SMEM> col(smem + (SMEM ? warp * 3 * K * 32 : 0));
  const int base = lane * K;
  const int qlen = q_lens[p], tlen = t_lens[p], h0 = h0s[p];
  const int oe_del = pen.o_del + pen.e_del, oe_ins = pen.o_ins + pen.e_ins;
  const int e_del = pen.e_del, e_ins = pen.e_ins;
  Best best{h0};

  if (qlen > 0 && tlen > 0) {
    const int w = band_width(pen, qlen);

    // first row: h0, then the insertion ramp, cut after its first failure
    const int h_of_1 = max(h0 - oe_ins, 0);
    const int32_t* qrow = qs + (size_t)p * QL;
    int fail = BIG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = base + k;
      col.Q(k) = c < QL ? clamp_code(qrow[c]) : 4;
      if (c >= 1 && h_of_1 - e_ins * (c - 1) <= e_ins) fail = min(fail, c);
    }
    fail = __reduce_min_sync(FULL, fail);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = base + k;
      int v = c <= fail ? max(h_of_1 - e_ins * (c - 1), 0) : 0;
      v = c == 0 ? h0 : (c == 1 ? h_of_1 : v);
      col.H(k) = c <= qlen ? v : 0;
      col.E(k) = 0;
    }

    // target codes: 32 rows a coalesced load, the next 32 in flight
    const int32_t* trow = ts + (size_t)p * TL;
    int tnext = lane < TL ? clamp_code(trow[lane]) : 4;
    int tcache = 4;
    int beg = 0, end = qlen;
    for (int i = 0; i < tlen; ++i) {
      if ((i & 31) == 0) {
        tcache = tnext;
        const int t = i + 32 + lane;
        tnext = t < TL ? clamp_code(trow[t]) : 4;
      }
      const int tb = __shfl_sync(FULL, tcache, i & 31);
      const int tn = tb == 4;
      const int bg = max(beg, i - w);
      const int en = min(min(end, i + w + 1), qlen);
      const int h1_first =
          bg == 0 ? max(h0 - (pen.o_del + e_del * (i + 1)), 0) : 0;

      // every column at once: M, the F key t_ins + e_ins * c (NEG out
      // of the band), and the in-lane exclusive prefix max of the keys
      int M[K], pre[K];
      int agg = NEG;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + k;
        M[k] = cell_m(col.H(k), col.Q(k), tb, tn, pen);
        const int key = c >= bg && c < en
                            ? max(M[k] - oe_ins, 0) + e_ins * c : NEG;
        pre[k] = agg;
        agg = max(agg, key);
      }
      // warp exclusive max-scan of the lane aggregates (lanes below d
      // read their own value, which the max leaves as it is)
      int incl = agg;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1)
        incl = max(incl, __shfl_up_sync(FULL, incl, d));
      int run = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) run = NEG;

      // H of every column (F is 0 at column bg: no key precedes it);
      // the lane's last H goes to lane l + 1 for the shifted write-back;
      // the lane's row max and the last column attaining it
      int h[K];
      int lmax = -1, larg = -1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + k;
        const bool inb = c >= bg && c < en;
        const int f = max(max(run, pre[k]) - e_ins * (c - 1), 0);
        h[k] = inb ? max(max(M[k], col.E(k)), f) : 0;
        const bool up = inb && h[k] >= lmax;
        lmax = up ? h[k] : lmax;
        larg = up ? c : larg;
      }
      int hprev = __shfl_up_sync(FULL, h[K - 1], 1);
      if (lane == 0) hprev = 0;

      // write-back eh_h[c] = H(i, c - 1), eh_e[c] = E(i + 1, c); the
      // non-zero columns of the new row for the band shrink
      int lead = BIG, tail = -1, mine = 0;
      const int lo = min(bg, en);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = base + k;
        const int hv = col.H(k), ev = col.E(k);
        const int hs = k == 0 ? hprev : h[k - 1];
        const bool inb = c >= bg && c < en;
        int nh = (c > bg && c <= en) ? hs : hv;
        nh = c == bg ? h1_first : nh;
        int ne = inb ? max(max(M[k] - oe_del, 0), ev - e_del) : ev;
        const int last = en > bg ? hs : h1_first;
        nh = c == en ? last : nh;
        ne = c == en ? 0 : ne;
        mine = c == en ? last : mine;
        col.H(k) = nh;
        col.E(k) = ne;
        const bool nz = nh != 0 || ne != 0;
        lead = nz && inb ? min(lead, c) : lead;
        tail = nz && c >= lo && c <= en ? c : tail;
      }
      const int raw = __reduce_max_sync(FULL, lmax);
      const int mj = __reduce_max_sync(FULL, lmax == raw ? larg : -1);
      const int h1_last = __shfl_sync(FULL, mine, en / K);
      lead = __reduce_min_sync(FULL, lead);
      tail = __reduce_max_sync(FULL, tail);

      if (best.row_end(i, en, qlen, raw, mj, h1_last, pen)) break;
      // band shrink: skip leading / trailing cells with h == 0 and e == 0
      beg = lead < BIG ? lead : en;
      end = min((tail >= 0 ? tail : beg - 1) + 2, qlen);
    }
  }
  if (lane == 0) best.store(out, P, p);
  epi(best, p, lane);
}

constexpr int KT = 8;                // columns a lane a tile (tiled)
constexpr int TILE = 32 * KT;        // columns a tile

// The body of bsw_tiled_kernel: the same row step as warp_body over the
// tiles of the band, the row in `scratch` ([P, 2, ntiles * TILE]: eh_h
// then eh_e), and the same epilogue.
template <class Epi>
__device__ __forceinline__ void tiled_body(
    const int32_t* __restrict__ qs,      // [P, QL]
    const int32_t* __restrict__ ts,      // [P, TL]
    const int32_t* __restrict__ q_lens,  // [P]
    const int32_t* __restrict__ t_lens,  // [P]
    const int32_t* __restrict__ h0s,     // [P]
    int32_t* __restrict__ out,           // [6, P]
    int32_t* __restrict__ scratch, int P, int QL, int TL, Pen pen,
    Epi epi) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int p = blockIdx.x * WARPS + warp;
  if (p >= P) return;                       // whole warps only
  const int ntiles = (QL + TILE) / TILE;    // columns 0 .. QL
  int32_t* sh = scratch + (size_t)p * 2 * ntiles * TILE + lane;
  int32_t* se = sh + ntiles * TILE;
  const int qlen = q_lens[p], tlen = t_lens[p], h0 = h0s[p];
  const int oe_del = pen.o_del + pen.e_del, oe_ins = pen.o_ins + pen.e_ins;
  const int e_del = pen.e_del, e_ins = pen.e_ins;
  Best best{h0};

  if (qlen > 0 && tlen > 0) {
    const int w = band_width(pen, qlen);

    const int h_of_1 = max(h0 - oe_ins, 0);
    const int32_t* qrow = qs + (size_t)p * QL;
    int fail = BIG;
    for (int t = 0; t < ntiles; ++t)
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int c = t * TILE + lane * KT + k;
        if (c >= 1 && h_of_1 - e_ins * (c - 1) <= e_ins) fail = min(fail, c);
      }
    fail = __reduce_min_sync(FULL, fail);
    for (int t = 0; t < ntiles; ++t)
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        const int c = t * TILE + lane * KT + k;
        int v = c <= fail ? max(h_of_1 - e_ins * (c - 1), 0) : 0;
        v = c == 0 ? h0 : (c == 1 ? h_of_1 : v);
        sh[t * TILE + k * 32] = c <= qlen ? v : 0;
        se[t * TILE + k * 32] = 0;
      }

    const int32_t* trow = ts + (size_t)p * TL;
    int tnext = lane < TL ? clamp_code(trow[lane]) : 4;
    int tcache = 4;
    int beg = 0, end = qlen;
    for (int i = 0; i < tlen; ++i) {
      if ((i & 31) == 0) {
        tcache = tnext;
        const int t = i + 32 + lane;
        tnext = t < TL ? clamp_code(trow[t]) : 4;
      }
      const int tb = __shfl_sync(FULL, tcache, i & 31);
      const int tn = tb == 4;
      const int bg = max(beg, i - w);
      const int en = min(min(end, i + w + 1), qlen);
      const int h1_first =
          bg == 0 ? max(h0 - (pen.o_del + e_del * (i + 1)), 0) : 0;
      const int lo = min(bg, en);
      const int t1 = min(max(bg, en) / TILE, ntiles - 1);

      int carry = NEG;      // the largest F key of the earlier tiles
      int hcarry = 0;       // H of the column before the tile
      int lmax = -1, larg = -1, lead = BIG, tail = -1, mine = 0;
      for (int t = lo / TILE; t <= t1; ++t) {
        const int base = t * TILE + lane * KT;
        int hv[KT], ev[KT], M[KT], pre[KT];
        int agg = NEG;
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int c = base + k;
          hv[k] = sh[t * TILE + k * 32];
          ev[k] = se[t * TILE + k * 32];
          const int qc = c < QL ? clamp_code(qrow[c]) : 4;
          M[k] = cell_m(hv[k], qc, tb, tn, pen);
          const int key = c >= bg && c < en
                              ? max(M[k] - oe_ins, 0) + e_ins * c : NEG;
          pre[k] = agg;
          agg = max(agg, key);
        }
        int incl = agg;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1)
          incl = max(incl, __shfl_up_sync(FULL, incl, d));
        int run = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) run = NEG;
        run = max(run, carry);
        carry = max(carry, __shfl_sync(FULL, incl, 31));

        int h[KT];
#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int c = base + k;
          const bool inb = c >= bg && c < en;
          const int f = max(max(run, pre[k]) - e_ins * (c - 1), 0);
          h[k] = inb ? max(max(M[k], ev[k]), f) : 0;
          const bool up = inb && h[k] >= lmax;
          lmax = up ? h[k] : lmax;
          larg = up ? c : larg;
        }
        int hprev = __shfl_up_sync(FULL, h[KT - 1], 1);
        if (lane == 0) hprev = hcarry;
        hcarry = __shfl_sync(FULL, h[KT - 1], 31);

#pragma unroll
        for (int k = 0; k < KT; ++k) {
          const int c = base + k;
          const int hs = k == 0 ? hprev : h[k - 1];
          const bool inb = c >= bg && c < en;
          int nh = (c > bg && c <= en) ? hs : hv[k];
          nh = c == bg ? h1_first : nh;
          int ne = inb ? max(max(M[k] - oe_del, 0), ev[k] - e_del) : ev[k];
          const int last = en > bg ? hs : h1_first;
          nh = c == en ? last : nh;
          ne = c == en ? 0 : ne;
          mine = c == en ? last : mine;
          sh[t * TILE + k * 32] = nh;
          se[t * TILE + k * 32] = ne;
          const bool nz = nh != 0 || ne != 0;
          lead = nz && inb ? min(lead, c) : lead;
          tail = nz && c >= lo && c <= en ? c : tail;
        }
      }
      const int raw = __reduce_max_sync(FULL, lmax);
      const int mj = __reduce_max_sync(FULL, lmax == raw ? larg : -1);
      // one lane owns column en; its H is >= 0, every other lane's 0
      const int h1_last = __reduce_max_sync(FULL, mine);
      lead = __reduce_min_sync(FULL, lead);
      tail = __reduce_max_sync(FULL, tail);

      if (best.row_end(i, en, qlen, raw, mj, h1_last, pen)) break;
      beg = lead < BIG ? lead : en;
      end = min((tail >= 0 ? tail : beg - 1) + 2, qlen);
    }
  }
  if (lane == 0) best.store(out, P, p);
  epi(best, p, lane);
}

// The instantiations of the warp body, K columns a lane (the registers
// up to 8, shared memory above): X(K, SMEM) for each, the list that the
// launchers of both sources switch over and ops/bsw_cuda.py's K_VALUES
// repeats.
#define BSW_INSTANTIATIONS(X) \
  X(1, false) X(2, false) X(3, false) X(4, false) X(5, false) X(6, false) \
  X(7, false) X(8, false) X(12, true) X(16, true) X(24, true)

}  // namespace bsw
