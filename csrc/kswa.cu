// Batched local Smith-Waterman with start and end coordinates and a
// second-best score (ksw_align2 with XSTART, the mate-rescue aligner) for
// Hopper (sm_90a): one warp per job, the DP row in the warp's registers.
//
// Replaces bwa_mem_scale_tpu/ops/kswa.py:81 ksw_align_batch (its two
// _scan_phase passes, jax.lax.scan at :37-78, score2 / te2 from the
// column maxima at :88-94, tb / qb from the reversed prefixes at
// :96-110) and computes the same function as the plain version,
// ops/kswa.py::ksw_align_batch: score, te, qe, score2, te2, tb, qb [J]
// int32, with the JAX function's score2 (the largest column maximum
// outside te +- ceil(score / max_mat), no merging of runs). Lengths are
// clamped into [0, L] and [0, T]; codes into [0, 4]; the 5 x 5 matrix
// comes by value.
//
// Design. Warp j of the grid owns job j; lane l owns query columns
// l*K .. l*K + K - 1 of H and E, in registers. A row step is the plain
// version's: M from the previous row's H shifted one column (lane l-1's
// last by a shuffle), H' = max(M, E, 0), F as an exclusive prefix max of
// H'[k] + e_ins * k (in-lane, then a 5-step shuffle scan of the lane
// aggregates), H = max(H', F - o_ins - e_ins * j, 0), E from H; each
// row's maximum by __reduce_max_sync. The forward scan (rows 0 .. tlen-1)
// keeps the first row whose maximum beats the best (te), the first column
// holding it (qe, a __reduce_min_sync at each new best), and each row's
// maximum in a global scratch colmax [J, T]; the warp then reduces the
// candidates outside the te window to score2 and te2. When score > 0 and
// score >= minsc, the same scan runs over the reversed prefixes
// q[qe .. 0] x t[te .. 0], stopping at the first row that reaches score:
// no later row can move (te_r, qe_r), because a local score of a prefix
// never exceeds the whole's; tb = te - te_r and qb = qe - qe_r when that
// row exists, else -1, the plain version's outputs.
//
// What bounds it: about 20 integer operations a DP cell (the score
// lookup 2, M 1, H' 3, the F key 2, the scans' share 2, F 2, H 3, E 4,
// the row maximum 1), so the forward scan's Sum qlen * tlen plus the
// reverse scan's cells over 16.7 T/s; the codes read once and the outputs
// written once are far less at 3.35 TB/s. Above that sits a latency
// floor: a job's rows run one after another, each a chain of dependent
// shuffles, so the longest job's rows (both scans) times one row step
// bound the call.

#include <cuda_runtime.h>
#include <stdint.h>

struct SwMat {
  int v[25];
};

namespace {

constexpr int WARPS = 4;               // jobs (warps) per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 29);        // the plain version's NEG

struct Gap {
  int o_del, e_del, o_ins, e_ins;
};

__device__ __forceinline__ int clamp_code(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

struct ScanOut {
  int gmax, te, qe;
};

// One scan over rows 0 .. tlen - 1 of a job: the query codes qc (-1 past
// qlen), the target row i's code from tcode(i). With colmax, each row's
// maximum is stored there; with stop_at > 0 the scan ends at the first row
// whose maximum reaches stop_at.
template <int K, typename TCode>
__device__ ScanOut scan(const int (&qc)[K], int qlen, int tlen,
                        TCode tcode, const int* smat, const Gap& g,
                        int32_t* colmax, int stop_at) {
  const int lane = threadIdx.x & 31;
  const int base = lane * K;
  const int oe_del = g.o_del + g.e_del;
  int H[K], E[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    H[k] = 0;
    E[k] = 0;
  }
  ScanOut r{0, -1, -1};
  for (int i = 0; i < tlen; ++i) {
    const int* mrow = smat + 5 * tcode(i);
    int hlast = __shfl_up_sync(FULL, H[K - 1], 1);
    if (lane == 0) hlast = 0;
    int hp[K], pre[K];
    int agg = NEG;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = base + k;
      const int m = (k == 0 ? hlast : H[k - 1]) + mrow[qc[k] < 0 ? 4 : qc[k]];
      hp[k] = c < qlen ? max(max(m, E[k]), 0) : 0;
      pre[k] = agg;
      agg = max(agg, hp[k] + g.e_ins * c);
    }
    int incl = agg;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl = max(incl, v);
    }
    int run = __shfl_up_sync(FULL, incl, 1);
    if (lane == 0) run = NEG;
    int lmax = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = base + k;
      const bool ok = c < qlen;
      const int f = max(run, pre[k]) - g.o_ins - g.e_ins * c;
      const int h = max(hp[k], max(f, 0));
      H[k] = ok ? h : 0;
      E[k] = ok ? max(max(H[k] - oe_del, E[k] - g.e_del), 0) : 0;
      lmax = max(lmax, H[k]);
    }
    const int cm = __reduce_max_sync(FULL, lmax);
    if (colmax != nullptr && lane == 0) colmax[i] = cm;
    if (cm > r.gmax) {              // warp-uniform
      int first = 1 << 30;
#pragma unroll
      for (int k = K - 1; k >= 0; --k)
        if (H[k] == cm) first = base + k;
      r.gmax = cm;
      r.te = i;
      r.qe = (int)__reduce_min_sync(FULL, (unsigned)first);
      if (stop_at > 0 && cm >= stop_at) break;
    }
  }
  return r;
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
kswa_kernel(const int32_t* __restrict__ qs,      // [J, L]
            const int32_t* __restrict__ q_lens,  // [J]
            const int32_t* __restrict__ ts,      // [J, T]
            const int32_t* __restrict__ t_lens,  // [J]
            int32_t* __restrict__ colmax,        // [J, T] scratch
            int32_t* __restrict__ out,           // [7, J]
            int J, int L, int T, SwMat mat, Gap g, int minsc,
            int max_mat) {
  __shared__ int smat[25];
  if (threadIdx.x < 25) smat[threadIdx.x] = mat.v[threadIdx.x];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int j = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (j >= J) return;                       // whole warps only
  const int qlen = min(max(q_lens[j], 0), L);
  const int tlen = min(max(t_lens[j], 0), T);
  const int32_t* qrow = qs + (size_t)j * L;
  const int32_t* trow = ts + (size_t)j * T;
  int32_t* cmrow = colmax + (size_t)j * T;
  const int base = lane * K;

  // forward scan
  int qc[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    qc[k] = base + k < qlen ? clamp_code(qrow[base + k]) : -1;
  const ScanOut f = scan<K>(
      qc, qlen, tlen, [&](int i) { return clamp_code(trow[i]); }, smat, g,
      cmrow, 0);
  const int gmax = f.gmax, te = f.te;
  const int qe = gmax > 0 ? f.qe : -1;

  // score2 / te2: the largest column maximum outside te +- d, first on ties
  __syncwarp();
  const int d = (gmax + max_mat - 1) / max_mat;
  const int floor2 = max(minsc, 1);
  int best = 0, at = 1 << 30;
  for (int ti = lane; ti < tlen; ti += 32) {
    const int cm = cmrow[ti];
    if ((ti < te - d || ti > te + d) && cm >= floor2 && cm > best) {
      best = cm;
      at = ti;
    }
  }
  const int score2 = __reduce_max_sync(FULL, best);
  const int te2_at = (int)__reduce_min_sync(
      FULL, (unsigned)(best == score2 ? at : (1 << 30)));
  const int te2 = score2 > 0 ? te2_at : -1;

  // start coordinates from the reversed prefixes
  int tb = -1, qb = -1;
  if (gmax > 0 && gmax >= minsc) {
    int rq[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = base + k;
      rq[k] = c <= qe ? clamp_code(qrow[qe - c]) : -1;
    }
    const ScanOut r = scan<K>(
        rq, qe + 1, te + 1, [&](int i) { return clamp_code(trow[te - i]); },
        smat, g, nullptr, gmax);
    if (r.gmax == gmax) {
      tb = te - r.te;
      qb = qe - r.qe;
    }
  }
  if (lane == 0) {
    out[0 * J + j] = gmax;
    out[1 * J + j] = te;
    out[2 * J + j] = qe;
    out[3 * J + j] = score2;
    out[4 * J + j] = te2;
    out[5 * J + j] = tb;
    out[6 * J + j] = qb;
  }
}

}  // namespace

// columns a lane of each instantiation (L <= 32 * K); keep in step with
// ops/kswa_cuda.py::K_VALUES
extern "C" int kswa_k_for(int L) {
  const int ks[] = {1, 2, 3, 4, 5, 6, 8, 12, 16};
  for (int k : ks)
    if (L <= 32 * k) return k;
  return 0;
}

// out [7, J] int32 (score, te, qe, score2, te2, tb, qb), colmax [J, T]
// int32 scratch. Returns the launch's CUDA error.
extern "C" int kswa_launch(const void* qs, const void* q_lens, const void* ts,
                           const void* t_lens, void* colmax, void* out, int J,
                           int L, int T, SwMat mat, int o_del, int e_del,
                           int o_ins, int e_ins, int minsc, int max_mat,
                           void* stream) {
  if (J <= 0) return 0;
  if (L < 0 || T < 1 || max_mat < 1) return (int)cudaErrorInvalidValue;
  const Gap g{o_del, e_del, o_ins, e_ins};
  const dim3 grid((J + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *q = (const int32_t*)qs, *ql = (const int32_t*)q_lens,
                *t = (const int32_t*)ts, *tl = (const int32_t*)t_lens;
  int32_t *cm = (int32_t*)colmax, *o = (int32_t*)out;
  switch (kswa_k_for(L)) {
#define KSWA_CASE(KK)                                                      \
  case KK:                                                                 \
    kswa_kernel<KK><<<grid, block, 0, st>>>(q, ql, t, tl, cm, o, J, L, T,  \
                                            mat, g, minsc, max_mat);       \
    break;
    KSWA_CASE(1)
    KSWA_CASE(2)
    KSWA_CASE(3)
    KSWA_CASE(4)
    KSWA_CASE(5)
    KSWA_CASE(6)
    KSWA_CASE(8)
    KSWA_CASE(12)
    KSWA_CASE(16)
#undef KSWA_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
