// Banded global alignment with traceback (the CIGAR DP of bwa_gen_cigar2,
// ksw_global2) for Hopper (sm_90a): one warp per pair.
//
// Replaces bwa_mem_scale_tpu/ops/kswg.py:33 ksw_global_batch (its row
// loop, jax.lax.fori_loop at :67-143, and its lockstep traceback
// while_loop at :156-176) and computes the same function as the plain
// version, ops/kswg.py::ksw_global_batch: score [P], ops [P, S] int8
// (0 = M, 1 = I, 2 = D, alignment end first, -1 past n_ops), n_ops [P],
// tail_del [P] and tail_ins [P], S = QL + TL + 2. Lengths are clamped into
// [0, QL] and [0, TL]; codes into [0, 4]. The scores come from the JAX
// function's arithmetic profile (match, mismatch, and N where either base
// is 4: mat[0][0], mat[0][1], mat[0][4]), which the wrapper spells out as
// a 5 x 5 table; the kernel reads it from shared memory. (Built by nvcc
// 12.9 at -O3 for sm_90a, the profile computed in the kernel, as a select
// chain or branch-free, from the clamped target code scored every cell as
// N on an H100: `clamp(t) == 4` came out true for t = 3. A -G build, an
// unclamped code and the table form were right; keep the table.)
//
// Design. Block p (one warp) owns pair p. Its query and target codes are
// staged into shared memory once, as bytes, and the row loop reads no
// global memory. The row is indexed by band position k = j - i + w
// (column j, row i), so that a cell's M reads the previous row's H at the
// same k and its E the previous row's E at k + 1; each lane holds a strip
// of R consecutive positions in registers, R the least of 1, 2, 3, 4, 6,
// 8, 12 and 16 that covers the pair's band, 2 w + 1 (w clamped to the
// pair's longer side, which changes no cell), so that a pair pays for its
// own band. F is the exclusive prefix max of t_ins[k] + e_ins * j over the
// band: an in-strip scan, then one 5-step shuffle scan of the strips'
// maxima, whatever the band's width. A band wider than 512 positions runs
// in segments of 32 x 16 positions whose row state waits in shared memory
// between rows, a running carry passing F's prefix from one segment to
// the next. The profile scores of the next row are loaded while a row
// runs. The plain version's masks are kept exactly: a row's cells are the
// positions [max(w - i, 0), min(2 w + 1, qlen - i + w)); position k - 1 of
// the first cell takes h1_first at the left edge (i < w); E enters the
// band as -inf; the score is the last write of column qlen (h1_last of the
// last row when its band reaches qlen, h1_first of an empty band).
//
// Each cell's direction is a nibble: H's source in bits 0-1 (0 M, 1 E, 2
// F), E's continuation in bit 2, F's in bit 3. A lane stores its strip's
// nibbles as one word a row (1, 2, 4 or 8 bytes). A pair's rows stay in
// dynamic shared memory when they fit beside the codes (`rest`); otherwise
// they go to the pair's part of a global scratch zb [P, TL, zrb] and the
// traceback stages them back into shared memory a tile of rows at a time
// (a coalesced warp-wide copy, 16 bytes a lane). The warp walks the
// traceback in lockstep, one nibble read from shared memory a step, lane 0
// storing the ops; then the warp pads ops with -1. The host sizes `rest`
// from the call (ops/kswg_cuda.py `plan`, `block_budget`): the whole block
// while the call has no more pairs than the card has SMs, else a share of
// an SM's shared memory that lets as many blocks run on it at once as the
// call puts there (at most what the registers allow), never less than a
// tile of 32 rows. A segmented band whose state would leave no room for
// such a tile keeps its state in a global scratch zs [P, zsb] instead. So
// a call raises only when its codes and one row of nibbles (a byte a two
// band positions) exceed a block: QL + TL + 1 + the row past 231,424
// bytes, that is TL past about 100,000 at any band and QL 29,024, past
// about 200,000 at a narrow one.
//
// What bounds it: per band cell about 25 integer operations (profile 4,
// M / pre / direction 6, the F key and scan share 4, F 3, H / E / bits
// 8), so Sum over pairs of band cells over 16.7 T/s, and the codes read
// once and the outputs written once over 3.35 TB/s. Above both sits a
// latency floor that no design of this DP avoids: a pair's rows run one
// after another, each row waiting on the one before, and so does each
// traceback step, so (the longest pair's rows + its traceback steps) x
// one dependent round of a warp in shared memory (a load, a shuffle and a
// ballot, tools/round_cost.py) bound the call. This design's row is about
// six shuffles deep (the scan and the E shift) plus its strip's
// arithmetic, its traceback step one shared-memory load. A warp a pair
// puts every pair of a batch in flight at once.

#include <cuda_runtime.h>
#include <stdint.h>

// the 5 x 5 profile by value, row-major (target code, query code); outside
// the anonymous namespace, so that kswg_launch keeps external linkage
struct Prof {
  int v[25];
};

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG_INF = -(1 << 29);
constexpr int WARP = 32;
constexpr int SEG_R = 16;            // a segment's strip, wide bands
constexpr int SMEM_MAX = 232448;     // a block's shared memory on Hopper

struct Gap {
  int o_del, e_del, o_ins, e_ins;
};

__device__ __forceinline__ int clamp_code(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

// bytes of one lane's nibbles a row: ceil(R / 2) rounded up to a power of 2
__host__ __device__ constexpr int lane_bytes(int R) {
  return R <= 2 ? 1 : (R <= 4 ? 2 : (R <= 8 ? 4 : 8));
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) & ~15; }

// the least strip (positions a lane) that covers a band of half-width w,
// ceil((2 w + 1) / 32); a pair takes the least of 1, 2, 3, 4, 6, 8, 12 and
// 16 at or above it, else segments of 32 x SEG_R (ops/kswg_cuda.py
// `strip` follows this)
__host__ __device__ constexpr int strip_need(int w) {
  return w >= 0 ? (2 * w + 1 + WARP - 1) / WARP : 1;
}

// (R, S) of a band of half-width w: the kernel's choice of pair_dp
inline void strip_of(int w, int* R, int* S) {
  const int need = strip_need(w);
  *R = need <= 4 ? need : (need <= 6 ? 6 : (need <= 8 ? 8 : (need <= 12
                                                             ? 12 : SEG_R)));
  *S = need <= SEG_R ? 1 : (need + SEG_R - 1) / SEG_R;
}

template <int LB>
__device__ __forceinline__ void put_word(uint8_t* at, uint64_t v) {
  if constexpr (LB == 1) *at = (uint8_t)v;
  else if constexpr (LB == 2) *reinterpret_cast<uint16_t*>(at) = (uint16_t)v;
  else if constexpr (LB == 4) *reinterpret_cast<uint32_t*>(at) = (uint32_t)v;
  else *reinterpret_cast<uint64_t*>(at) = v;
}

// H of the first row at column c: eh_h[0] = 0, eh_h[c] = -(o_ins + e_ins
// * c) for 1 <= c <= min(w, qlen), else -inf
__device__ __forceinline__ int first_h(int c, int w, int qlen, Gap s) {
  return c == 0 ? 0 : ((c >= 1 && c <= w && c <= qlen)
                           ? -(s.o_ins + s.e_ins * c) : NEG_INF);
}

// The cells of one strip (positions k0 .. k0 + R - 1) of row i: from the
// strip's H, its incoming E and profile scores, and the exclusive prefix
// `lex` of the keys before the strip, the new H and stored E in place and
// the strip's nibbles (`cells`), after `keys` and the warp's scan.
template <int R>
struct Strip {
  int M[R], Ein[R], ex[R];

  // M, the keys' in-strip exclusive prefix; returns the strip's maximum
  __device__ __forceinline__ int keys(const int* h, const int* qp, int k0,
                                      int kb, int ke, int jk, Gap s) {
    const int oe_ins = s.o_ins + s.e_ins;
    int loc = NEG_INF;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int k = k0 + t;
      M[t] = max(h[t] + qp[t], NEG_INF);
      const int t_ins = max(M[t] - oe_ins, NEG_INF);
      const int key = (k >= kb && k < ke) ? t_ins + s.e_ins * (jk + k)
                                          : NEG_INF;
      ex[t] = loc;
      loc = max(loc, key);
    }
    return loc;
  }

  __device__ __forceinline__ uint64_t cells(int* h, int* est, int lex,
                                            int k0, int kb, int ke, int jk,
                                            int h1_first, Gap s) {
    const int oe_ins = s.o_ins + s.e_ins, oe_del = s.o_del + s.e_del;
    uint64_t nib = 0;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int k = k0 + t, j = jk + k;
      const bool inb = k >= kb && k < ke;
      const int E = Ein[t];
      int dh = M[t] >= E ? 0 : 1;
      const int pre = max(M[t], E);
      const int t_ins = max(M[t] - oe_ins, NEG_INF);
      const int run = max(lex, ex[t]);
      const int f = (!inb || k == kb) ? NEG_INF
                                      : max(run - s.e_ins * (j - 1), NEG_INF);
      if (!(pre >= f)) dh = 2;
      const int H = max(pre, f);
      const int t_del = max(M[t] - oe_del, NEG_INF);
      const int e_bit = (E - s.e_del) > t_del;
      const int E_next = max(E - s.e_del, t_del);
      const int f_bit = (f - s.e_ins) > t_ins;
      nib |= (uint64_t)(dh | (e_bit << 2) | (f_bit << 3)) << (4 * t);
      h[t] = inb ? H : (k == kb - 1 ? h1_first : h[t]);
      est[t] = k < ke ? E_next : NEG_INF;
    }
    return nib;
  }
};

// inclusive max scan over the warp's lanes (a lane below d gets its own
// value back from the shuffle, which max leaves as it is)
__device__ __forceinline__ int warp_incl_max(int v) {
#pragma unroll
  for (int d = 1; d < WARP; d <<= 1) v = max(v, __shfl_up_sync(FULL, v, d));
  return v;
}

// One pair's DP and traceback at strip R (MULTI: S segments of 32 x R
// positions, the row state between rows in shared memory, or in `zst`, the
// pair's part of a global scratch, when that is given). `rest` is the
// block's shared memory past the codes: the segments' state when it is
// there, then rows of nibbles, all of the pair's rows when they fit (else
// a tile of them, the rows themselves in `zrow`, the pair's part of the
// global scratch).
template <int R, bool MULTI>
__device__ __forceinline__ void pair_dp(const int8_t* qc, const int8_t* tc,
                                        int qlen, int tlen, int w, int S,
                                        uint8_t* rest, int rest_bytes,
                                        uint8_t* zrow, int* zst,
                                        const int* tab, int8_t* orow,
                                        int* out, Gap s) {
  constexpr int LB = lane_bytes(R);
  constexpr int SEG = WARP * R;        // positions a segment
  const int lane = threadIdx.x;
  int* sH = zst ? zst : reinterpret_cast<int*>(rest);   // segments only
  int* sE = sH + S * SEG;
  uint8_t* dsm = MULTI && !zst ? reinterpret_cast<uint8_t*>(sE + S * SEG)
                               : rest;
  const int RB = S * WARP * LB;        // bytes of a row's nibbles
  const int tile_rows = (rest_bytes - (int)(dsm - rest)) / RB;
  const bool direct = tlen <= tile_rows;   // every row in shared memory
  uint8_t* rows = direct ? dsm : zrow;

  // the row state: H at each band position and E as stored (E_next at
  // its own position; a row reads position k + 1)
  int h[R], est[R];
  if constexpr (MULTI) {
    for (int x = lane; x < S * SEG; x += WARP) {
      const int st = x / WARP;
      const int k = (st / R) * SEG + (x % WARP) * R + st % R;
      sH[x] = first_h(k - w, w, qlen, s);
      sE[x] = NEG_INF;
    }
  } else {
#pragma unroll
    for (int t = 0; t < R; ++t) {
      h[t] = first_h(lane * R + t - w, w, qlen, s);
      est[t] = NEG_INF;
    }
  }
  __syncwarp();

  // the profile scores of a strip of row i (tc[tlen] is a code too)
  auto load_qp = [&](int i, int k0, int* qp) {
    const int* tr = tab + 5 * tc[i];
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int j = i - w + k0 + t;
      qp[t] = tr[(j >= 0 && j < qlen) ? qc[j] : 0];
    }
  };

  int qpn[R];
  if constexpr (!MULTI) load_qp(0, lane * R, qpn);
  for (int i = 0; i < tlen; ++i) {
    const int kb = max(w - i, 0);
    const int ke = min(2 * w + 1, qlen - i + w);
    const int h1_first = i <= w ? -(s.o_del + s.e_del * (i + 1)) : NEG_INF;
    const int jk = i - w;              // column = jk + band position
    uint8_t* row = rows + (size_t)i * RB;
    if constexpr (!MULTI) {
      int qp[R];
#pragma unroll
      for (int t = 0; t < R; ++t) qp[t] = qpn[t];
      load_qp(i + 1, lane * R, qpn);   // the next row's, off the chain
      Strip<R> st;
      const int e_nb = __shfl_down_sync(FULL, est[0], 1);
#pragma unroll
      for (int t = 0; t < R; ++t)
        st.Ein[t] = t + 1 < R ? est[t + 1] : (lane == WARP - 1 ? NEG_INF
                                                               : e_nb);
      const int k0 = lane * R;
      const int incl = warp_incl_max(st.keys(h, qp, k0, kb, ke, jk, s));
      int lex = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) lex = NEG_INF;
      const uint64_t nib = st.cells(h, est, lex, k0, kb, ke, jk, h1_first,
                                    s);
      put_word<LB>(row + lane * LB, nib);
    } else {
      int carry = NEG_INF;             // F's prefix over earlier segments
      for (int g = 0; g < S; ++g) {
        const int k0 = g * SEG + lane * R;
        int* gh = sH + g * SEG;
        int* ge = sE + g * SEG;
        int qp[R];
        load_qp(i, k0, qp);
        Strip<R> st;
#pragma unroll
        for (int t = 0; t < R; ++t) {
          h[t] = gh[t * WARP + lane];
          st.Ein[t] = t + 1 < R ? ge[(t + 1) * WARP + lane]
                      : (lane + 1 < WARP ? ge[lane + 1]
                         : (g + 1 < S ? ge[SEG] : NEG_INF));
        }
        __syncwarp();                  // the segment's old state is read
        const int incl = warp_incl_max(st.keys(h, qp, k0, kb, ke, jk, s));
        int lex = __shfl_up_sync(FULL, incl, 1);
        if (lane == 0) lex = NEG_INF;
        lex = max(lex, carry);
        carry = max(carry, __shfl_sync(FULL, incl, WARP - 1));
        const uint64_t nib = st.cells(h, est, lex, k0, kb, ke, jk, h1_first,
                                      s);
#pragma unroll
        for (int t = 0; t < R; ++t) {
          gh[t * WARP + lane] = h[t];
          ge[t * WARP + lane] = est[t];
        }
        put_word<LB>(row + (g * WARP + lane) * LB, nib);
      }
      __syncwarp();
    }
  }
  __syncwarp();                        // the rows are written

  // the score, the last write of column qlen: at w >= 0 the last row's
  // when its band reaches qlen (h1_last, H at ke - 1, or h1_first of an
  // empty band), else the first row's value; at w < 0 every row writes
  // -inf there
  int score = qlen == 0 ? 0 : (qlen <= w ? -(s.o_ins + s.e_ins * qlen)
                                         : NEG_INF);
  if (tlen > 0 && w < 0) score = NEG_INF;
  if (tlen > 0 && w >= 0 && tlen + w >= qlen) {
    const int i = tlen - 1;
    const int kb = max(w - i, 0), ke = min(2 * w + 1, qlen - i + w);
    if (ke > kb) {
      const int kk = ke - 1;
      if constexpr (MULTI) {
        score = sH[(kk / SEG) * SEG + ((kk % SEG) % R) * WARP
                   + (kk % SEG) / R];
      } else {
        int v = 0;
#pragma unroll
        for (int t = 0; t < R; ++t)
          if (lane * R + t == kk) v = h[t];
        score = __shfl_sync(FULL, v, kk / R);
      }
    } else {
      score = i <= w ? -(s.o_del + s.e_del * tlen) : NEG_INF;
    }
  }

  // traceback: the warp in lockstep, lane 0 storing; a cell outside its
  // row's band reads 0. In the tile form rows [lo, hi) are in shared memory.
  int i = tlen - 1;
  int k = min(i + w + 1, qlen) - 1;
  int which = 0, sc = 0;
  int lo = direct ? 0 : tlen;
  while (i >= 0 && k >= 0) {
    if (i < lo) {                      // stage the tile of rows ending at i
      const int hi = i + 1;
      lo = max(hi - tile_rows, 0);
      const int4* src = reinterpret_cast<const int4*>(rows + (size_t)lo * RB);
      int4* dst = reinterpret_cast<int4*>(dsm);
      const int n16 = (hi - lo) * RB / 16;
      __syncwarp();
      for (int x = lane; x < n16; x += WARP) dst[x] = src[x];
      __syncwarp();
    }
    const int beg = max(i - w, 0);
    const int end = min(i + w + 1, qlen);
    int d = 0;
    if (k >= beg && k < end) {
      const int kk = k - i + w;
      const int g = kk / SEG, r = kk % SEG;
      const int t = r % R;
      const uint8_t* rb = dsm + (size_t)(i - lo) * RB;
      d = (rb[(g * WARP + r / R) * LB + (t >> 1)] >> ((t & 1) * 4)) & 15;
    }
    which = which == 0 ? (d & 3)
                       : (which == 1 ? ((d >> 2) & 1) : ((d >> 3) & 1) * 2);
    if (lane == 0)
      orow[sc] = (int8_t)(which == 0 ? 0 : (which == 1 ? 2 : 1));
    ++sc;
    if (which != 2) --i;
    if (which != 1) --k;
  }
  out[0] = score;
  out[1] = sc;
  out[2] = max(i + 1, 0);
  out[3] = max(k + 1, 0);
}

__global__ void __launch_bounds__(32)
kswg_kernel(const int32_t* __restrict__ qs,      // [P, QL]
            const int32_t* __restrict__ q_lens,  // [P]
            const int32_t* __restrict__ ts,      // [P, TL]
            const int32_t* __restrict__ t_lens,  // [P]
            const int32_t* __restrict__ w_p,     // [P]
            uint8_t* __restrict__ zb,            // [P, TL, zrb] (tiles)
            int32_t* __restrict__ zs,            // [P, zsb / 4] (state)
            int32_t* __restrict__ score,         // [P]
            int8_t* __restrict__ ops,            // [P, S]
            int32_t* __restrict__ n_ops,         // [P]
            int32_t* __restrict__ tail_del,      // [P]
            int32_t* __restrict__ tail_ins,      // [P]
            int QL, int TL, int rest_bytes, int zrb, int zsb, Prof prof,
            Gap s) {
  __shared__ int tab[25];
  extern __shared__ __align__(16) uint8_t sm[];
  int8_t* qc = reinterpret_cast<int8_t*>(sm);
  int8_t* tc = qc + round16(QL);
  uint8_t* rest = reinterpret_cast<uint8_t*>(tc + round16(TL + 1));
  const int lane = threadIdx.x;
  const int p = blockIdx.x;
  const int qlen = min(max(q_lens[p], 0), QL);
  const int tlen = min(max(t_lens[p], 0), TL);
  // a band past the pair's longer side changes no cell: clamp w to it
  const int w = min(w_p[p], max(qlen, tlen));
  const int32_t* qrow = qs + (size_t)p * QL;
  const int32_t* trow = ts + (size_t)p * TL;
  if (lane < 25) tab[lane] = prof.v[lane];
  for (int c = lane; c < qlen; c += WARP) qc[c] = (int8_t)clamp_code(qrow[c]);
  for (int c = lane; c < tlen; c += WARP) tc[c] = (int8_t)clamp_code(trow[c]);
  if (lane == 0) tc[tlen] = 0;
  __syncwarp();
  int8_t* orow = ops + (size_t)p * (QL + TL + 2);
  uint8_t* zrow = zb ? zb + (size_t)p * TL * zrb : nullptr;
  int* zst = zs ? zs + (size_t)p * (zsb / 4) : nullptr;
  const int need = strip_need(w);
  int out[4];
#define KSWG_PAIR(R, M, S) pair_dp<R, M>(qc, tc, qlen, tlen, w, S, rest, \
    rest_bytes, zrow, zst, tab, orow, out, s)
  if (need <= 1) KSWG_PAIR(1, false, 1);
  else if (need <= 2) KSWG_PAIR(2, false, 1);
  else if (need <= 3) KSWG_PAIR(3, false, 1);
  else if (need <= 4) KSWG_PAIR(4, false, 1);
  else if (need <= 6) KSWG_PAIR(6, false, 1);
  else if (need <= 8) KSWG_PAIR(8, false, 1);
  else if (need <= 12) KSWG_PAIR(12, false, 1);
  else if (need <= SEG_R) KSWG_PAIR(SEG_R, false, 1);
  else KSWG_PAIR(SEG_R, true, (need + SEG_R - 1) / SEG_R);
#undef KSWG_PAIR
  if (lane == 0) {
    score[p] = out[0];
    n_ops[p] = out[1];
    tail_del[p] = out[2];
    tail_ins[p] = out[3];
  }
  const int S_ops = QL + TL + 2;
  for (int c = out[1] + lane; c < S_ops; c += WARP) orow[c] = -1;
}

// Dynamic shared memory of one block: the codes, then `rest` bytes (the
// 25-int profile table is static).
int smem_bytes(int QL, int TL, int rest) {
  return round16(QL) + round16(TL + 1) + rest;
}

}  // namespace

// score / n_ops / tail_del / tail_ins [P] int32, ops [P, QL + TL + 2] int8;
// w_max at least every pair's w (its band sizes the check below);
// rest_bytes the shared memory past the codes (a pair's segment state and
// its rows of nibbles, or a tile of them); zb [P, TL, zrb] uint8 the rows
// of a pair whose rows do not fit (null when every pair's fit); zs [P,
// zsb / 4] int32 the segments' state of a wide band kept in global memory
// (null when it is kept in shared memory). Refuses (cudaErrorInvalidValue)
// a rest_bytes that leaves the widest band less than one row, or scratch
// narrower than its rows or state. Returns the launch's CUDA error.
extern "C" int kswg_launch(const void* qs, const void* q_lens, const void* ts,
                           const void* t_lens, const void* w_p, void* zb,
                           void* zs, void* score, void* ops, void* n_ops,
                           void* tail_del, void* tail_ins, int P, int QL,
                           int TL, int w_max, int rest_bytes, int zrb,
                           int zsb, Prof prof, int o_del, int e_del,
                           int o_ins, int e_ins, void* stream) {
  if (P <= 0) return 0;
  const int smem = smem_bytes(QL, TL, rest_bytes);
  int R, S;
  const int side = QL > TL ? QL : TL;  // w clamped as the kernel does
  strip_of(w_max < side ? w_max : side, &R, &S);
  const int row = S * WARP * lane_bytes(R);
  const int state = S > 1 ? 2 * S * WARP * R * 4 : 0;
  if (QL < 1 || TL < 1 || smem > SMEM_MAX - 128
      || rest_bytes < (zs ? 0 : state) + row
      || (zb && zrb < row) || (zs && zsb < state)
      || (!zb && rest_bytes < (zs ? 0 : state) + (long long)TL * row))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kswg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Gap s{o_del, e_del, o_ins, e_ins};
  kswg_kernel<<<P, WARP, smem, (cudaStream_t)stream>>>(
      (const int32_t*)qs, (const int32_t*)q_lens, (const int32_t*)ts,
      (const int32_t*)t_lens, (const int32_t*)w_p, (uint8_t*)zb,
      (int32_t*)zs, (int32_t*)score, (int8_t*)ops, (int32_t*)n_ops,
      (int32_t*)tail_del, (int32_t*)tail_ins, QL, TL, rest_bytes, zrb, zsb,
      prof, s);
  return (int)cudaGetLastError();
}

// The blocks of kswg_kernel an SM holds at once on the current device
// when shared memory does not limit them (its registers and threads do):
// what ops/kswg_cuda.py `block_budget` shares an SM's shared memory among.
extern "C" int kswg_blocks_a_sm() {
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kswg_kernel, WARP, 0)
      != cudaSuccess)
    return 0;
  return n;
}
