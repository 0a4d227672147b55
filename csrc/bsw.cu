// Batched banded Smith-Waterman extension for Hopper (sm_90a): one warp
// per pair, the DP row in the warp's registers.
//
// Replaces bwa_mem_scale_tpu/ops/bsw_pallas.py:56 _bsw_kernel (the Pallas
// TPU kernel behind banded_swa_batch_pallas) and computes the same
// function as the plain version, ops/bsw.py::banded_swa_batch: per pair
// the recurrence of the reference's scalarBandedSWA
// (src/bandedSWA.cpp:116-238) with the h0-seeded first row, the insertion
// ramp cut after its first failure, z-drop (only when zdrop > 0), the
// per-row band shrink on the freshly written row, and max_j taken as the
// LAST column attaining the row maximum. Pairs with q_len or t_len 0 keep
// (h0, -1, -1, -1, -1, 0); qle, tle and gtle are written as max_j + 1,
// max_i + 1 and max_ie + 1.
//
// Layout: the arrays as the caller has them, qs [P, QL] and ts [P, TL]
// row-major, codes clamped to [0, 4] here. Warp p of the grid owns pair
// p. Lane l owns K = ceil((QL + 1) / 32) consecutive columns l*K .. l*K +
// K - 1 of the QL + 1 entries of the DP row (eh_h, eh_e) and of the query
// codes, in registers for K <= 8 and, above that, in the warp's slice of
// shared memory (column l*K + k at [k * 32 + l], no bank conflicts).
// Nothing of the DP goes to device memory. The warp reads 32 target codes
// with one coalesced load and hands row i's code to all lanes with one
// shuffle.
//
// A row step is the plain version's row step (ops/bsw.py:118-207) in warp
// primitives: F is an exclusive prefix max of gap-decayed keys, taken
// within the lane and then across lanes with a 5-step __shfl_up_sync
// scan; the row maximum and the last column attaining it are two
// __reduce_max_sync; the shift-by-one write-back takes lane l-1's last H
// through __shfl_up_sync; the band shrink is a __reduce_min_sync and a
// __reduce_max_sync over the non-zero columns of the new row. Every break
// is per pair, so the warp never diverges.
//
// What bounds it: the work is about 20 integer operations for each band
// cell the pairs walk (4.48 M cells on chip_smoke.py phase 3's input,
// about 5 us at 64 INT32 lanes an SM; its 6.9 MB of inputs take about 2 us
// at 3.35 TB/s). Above that sits a latency floor: a pair's rows run one
// after another, and a warp's row step is a long chain of dependent
// instructions (K columns a lane, the scan's and the shift's shuffles,
// four reductions), so the longest pair's rows (198 there) times one step
// bound the call however idle the other SMs are. One warp per pair puts
// 4,096 pairs on 4,096 warps (~31 an SM, where one thread per pair kept
// one warp an SM busy), and the DP row in registers keeps loads and
// stores out of the chain; the instructions of a row step are what is
// left to cut.
//
// Past 24 columns a lane (queries of 768 columns and more, which reach
// BSW under -W > 0, e.g. -x pacbio) one more instantiation walks the DP
// row in tiles of TILE = 32 x KT columns: lane l owns columns t*TILE +
// l*KT .. + KT - 1 of tile t, the row's eh_h and eh_e live in a per-pair
// scratch in device memory that the wrapper allocates ([P, 2, ntiles *
// TILE], column t*TILE + l*KT + k at t*TILE + k*32 + l, so a warp's
// loads coalesce), and the tiles of the band run one after another
// within the row step, carrying the F prefix max and the H of the
// tile's last column into the next tile, and the row maximum, the band
// shrink's first and last non-zero columns and h1_last across all of
// them. Tiles wholly outside [min(bg, en), max(bg, en)] are skipped: no
// column there changes, and none enters a reduction (bsw_tiled_kernel).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <int K, bool SMEM>
__global__ void __launch_bounds__(WARPS * 32)
bsw_warp_kernel(const int32_t* __restrict__ qs,      // [P, QL]
                const int32_t* __restrict__ ts,      // [P, TL]
                const int32_t* __restrict__ q_lens,  // [P]
                const int32_t* __restrict__ t_lens,  // [P]
                const int32_t* __restrict__ h0s,     // [P]
                int32_t* __restrict__ out,           // [6, P]
                int P, int QL, int TL, Pen pen) {
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
}

constexpr int KT = 8;                // columns a lane a tile (tiled)
constexpr int TILE = 32 * KT;        // columns a tile

// The same row step as bsw_warp_kernel over the tiles of the band, the
// row in `scratch` ([P, 2, ntiles * TILE]: eh_h then eh_e).
__global__ void __launch_bounds__(WARPS * 32)
bsw_tiled_kernel(const int32_t* __restrict__ qs,      // [P, QL]
                 const int32_t* __restrict__ ts,      // [P, TL]
                 const int32_t* __restrict__ q_lens,  // [P]
                 const int32_t* __restrict__ t_lens,  // [P]
                 const int32_t* __restrict__ h0s,     // [P]
                 int32_t* __restrict__ out,           // [6, P]
                 int32_t* __restrict__ scratch,
                 int P, int QL, int TL, Pen pen) {
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
}

template <int K, bool SMEM>
int launch(const int32_t* qs, const int32_t* ts, const int32_t* q_lens,
           const int32_t* t_lens, const int32_t* h0, int32_t* out, int P,
           int QL, int TL, const Pen& pen, cudaStream_t stream) {
  const int grid = (P + WARPS - 1) / WARPS;
  bsw_warp_kernel<K, SMEM><<<grid, WARPS * 32, 0, stream>>>(
      qs, ts, q_lens, t_lens, h0, out, P, QL, TL, pen);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch the instantiation for `k` columns a lane on `stream`, or with
// k = 0 the tiled one on `scratch` (int32 [P, 2, ceil((QL + 1) / 256) *
// 256]); returns cudaGetLastError() (0 on success), cudaErrorInvalidValue
// for a `k` without an instantiation, one too small for QL, or k = 0
// without scratch. The caller allocates every buffer and checks the
// lengths; nothing here synchronises. The wrapper's K_VALUES and TILED
// list the same `k` values.
extern "C" int bsw_launch(const void* qs, const void* ts, const void* q_lens,
                          const void* t_lens, const void* h0, void* out,
                          int P, int QL, int TL, int k, int w, int o_del,
                          int e_del, int o_ins, int e_ins, int zdrop,
                          int sc_match, int sc_mis, int sc_n, int mx,
                          int end_bonus, void* scratch, void* stream) {
  if (P <= 0) return 0;
  if (k == 0 ? scratch == nullptr : 32 * k < QL + 1)
    return (int)cudaErrorInvalidValue;
  const Pen pen{w, o_del, e_del, o_ins, e_ins, zdrop, sc_match, sc_mis,
                sc_n, mx, end_bonus};
  auto* q = (const int32_t*)qs;
  auto* t = (const int32_t*)ts;
  auto* ql = (const int32_t*)q_lens;
  auto* tl = (const int32_t*)t_lens;
  auto* hh = (const int32_t*)h0;
  auto* o = (int32_t*)out;
  auto s = (cudaStream_t)stream;
  if (k == 0) {
    bsw_tiled_kernel<<<(P + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        q, t, ql, tl, hh, o, (int32_t*)scratch, P, QL, TL, pen);
    return (int)cudaGetLastError();
  }
  switch (k) {
#define BSW_CASE(KK, SM) \
  case KK:               \
    return launch<KK, SM>(q, t, ql, tl, hh, o, P, QL, TL, pen, s);
    BSW_CASE(1, false)
    BSW_CASE(2, false)
    BSW_CASE(3, false)
    BSW_CASE(4, false)
    BSW_CASE(5, false)
    BSW_CASE(6, false)
    BSW_CASE(7, false)
    BSW_CASE(8, false)
    BSW_CASE(12, true)
    BSW_CASE(16, true)
    BSW_CASE(24, true)
#undef BSW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
