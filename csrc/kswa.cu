// Batched local Smith-Waterman with start and end coordinates and a
// second-best score (ksw_align2 with XSTART, the mate-rescue aligner) for
// Hopper (sm_90a): one warp per job, the DP as a wavefront across the
// warp's lanes.
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
// Design. Warp j of the grid owns job j. It first stages the job's query
// and target codes in shared memory as bytes clamped into [0, 4], beside
// the block's 5 x 5 table (kept as a table: nvcc 12.9 at -O3 for sm_90a
// miscompiled an in-kernel profile); nothing in the step loop reads
// device memory. Lane l owns query columns l*K .. l*K + K - 1 of H and E,
// in registers, and the rows run pipelined across the lanes: at step s
// lane l computes rows ROWS (s - l) .. ROWS (s - l) + ROWS - 1 over its
// K columns, one after the other (two rows a step give the lane
// independent work to interleave: with one, the row's dependent chain
// left most of a step's cycles idle on an NVIDIA H100 80GB HBM3 at 700
// W, 0.1122 us for 86 instructions, PERF.md section 6).
// - M from its own registers of the row before; at its first column from
//   its left neighbour's last H of the row before, taken by shuffle. A
//   step's scores are loaded from the table a step ahead.
// - F from the carry G_c = max(G_{c-1}, H'_{c-1} + e_ins (c - 1)), F_c =
//   G_c - o_ins - e_ins c: exactly the plain version's exclusive prefix
//   max. The lane first takes its own columns' prefix of H' + e_ins c
//   (no left lane needed), then one max with its left neighbour's G of
//   the row, taken by one shuffle, as it takes the row's running maximum:
//   one packed value (H << 10 | 1023 - column), the larger maximum
//   winning and on a tie the smaller column.
// - E in registers.
// No lane branches: a lane before its first row computes on a padding row
// that keeps its state 0, and columns past qlen are masked only in the
// row maximum (scan()'s note).
// The lane holding column qlen - 1 (`last`) completes a row `last` steps
// after the first lane and stores its packed maximum (shared memory where
// the target fits, else the global scratch [J, T]). A step is 3 ROWS
// independent shuffles and ROWS x K cells: no scan and no reduction a
// row. A scan runs ceil(tlen / ROWS) + last steps. The warp then finds
// the first row of the largest maximum (te, the plain version's
// first-best rule) and its first column (qe) in one strided pass, and
// reduces the row maxima outside the te window to score2 and te2. When
// score > 0 and score >= minsc, the same scan runs over the reversed
// prefixes q[qe .. 0] x t[te .. 0] and stops once the last lane sees a
// row reach the score (checked every STOP_EVERY steps: at most last +
// STOP_EVERY steps after that row's); no later row can move (te_r,
// qe_r), because a local score of a prefix never exceeds the whole's. tb
// = te - te_r and qb = qe - qe_r when that row exists, else -1, the plain
// version's outputs.
//
// What bounds it: about 20 integer operations a DP cell (the score
// lookup 2, M 1, H' 3, the F key 2, the scans' share 2, F 2, H 3, E 4,
// the row maximum 1: the count the earlier design's row took, kept so the
// rows compare), so the forward scan's Sum qlen * tlen plus the reverse
// scan's cells over 16.7 T/s; the codes read once and the outputs written
// once are far less at 3.35 TB/s. Above that sits a latency floor: a
// job's steps run one after another, each a few dependent shuffles and a
// lane's ROWS x K cells, so the longest job's steps (ceil(rows / ROWS) +
// last a scan, both scans) times one step bound the call. The packed
// maximum needs H below 2^21: the launch takes a matrix whose largest
// entry times the lanes' 32 K columns stays below that, and gap
// penalties >= 0 (the plain version's F is valid only for those).

#include <cuda_runtime.h>
#include <stdint.h>

struct SwMat {
  int v[25];
};

namespace {

constexpr int WARPS = 4;               // jobs (warps) per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int NEG = -(1 << 29);        // the plain version's NEG
constexpr int PACK = 10;               // column bits of a packed maximum
constexpr int PAD = -(1 << 22);        // the padding row's score
constexpr int ROWS = 2;                // rows a lane computes a step
constexpr int STOP_EVERY = 2;          // the reverse scan's check, steps
constexpr size_t SMEM_DEFAULT = 49152;
constexpr size_t SMEM_MAX = 232448;    // a block's shared memory, Hopper
// colmax goes to shared memory while a block's codes and maxima fit here
constexpr size_t COLMAX_BUDGET = SMEM_MAX / 2;

struct Gap {
  int o_del, e_del, o_ins, e_ins;
};

__host__ __device__ __forceinline__ size_t pad16(size_t n) {
  return (n + 15) & ~(size_t)15;
}

// bytes of shared memory a warp takes: its codes, and its column maxima
// when `cm`
__host__ __device__ __forceinline__ size_t warp_bytes(int L, int T,
                                                      bool cm) {
  return pad16(L) + pad16(T) + (cm ? 4 * (size_t)T : 0);
}

struct ScanOut {
  int te, qe, steps;      // STOP: the first row reaching stop_at, else -1
};

// One wavefront scan over rows 0 .. tlen - 1 of a job: the lane's query
// codes qc (-1 past qlen), row r's target code tcodes[tidx(r)]. At step s
// lane l computes the ROWS rows from ROWS (s - l) on, one after another
// (the second's cells start as the first's are done, so the lane has two
// rows of independent work to interleave). Without STOP each row's packed
// maximum goes to rowpk[r] (the caller finds the best row); STOP ends the
// scan once a row's maximum reaches stop_at and returns that first row
// and its first column. Returns the steps it ran, warp-uniform. Every
// lane computes every step, branch-free:
// - a lane before its first row or past the last takes the table's
//   padding row (smat row 5, PAD a cell), which keeps its H and E at 0
//   before row 0 (M <= 0, so H' = 0, and F <= 0 from a left lane doing
//   the same); what it computes past tlen, or right of the last lane, no
//   recorded row reads;
// - a column at or past qlen is left to its own values, which flow only
//   rightwards and down into columns past qlen: only the row maximum
//   masks it.
// A step's scores are loaded a step ahead, so that no step waits on
// shared memory.
template <int K, bool STOP, typename TIdx>
__device__ ScanOut scan(const int (&qc)[K], int qlen, int tlen,
                        const int8_t* tcodes, TIdx tidx, const int* smat,
                        const Gap& g, int32_t* rowpk, int stop_at) {
  const int lane = threadIdx.x & 31;
  const int base = lane * K;
  const int last = qlen > 0 ? (qlen - 1) / K : 0;
  const int oe_del = g.o_del + g.e_del;
  int H[K], E[K], ec[K], oec[K], tag[K], qo[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    H[k] = 0;
    E[k] = 0;
    ec[k] = g.e_ins * (base + k);
    oec[k] = g.o_ins + ec[k];
    // the packed maximum's column part, -1 past qlen (masked)
    tag[k] = base + k < qlen ? 1023 - base - k : -1;
    qo[k] = qc[k] < 0 ? 4 : qc[k];
  }
  auto scores = [&](int (&dst)[K], int r) {   // row r's scores
    const int* mrow =
        smat + 5 * (r >= 0 && r < tlen ? (int)tcodes[tidx(r)] : 5);
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = mrow[qo[k]];
  };
  int sc[ROWS][K], nx[ROWS][K];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    scores(sc[i], -ROWS * lane + i);
    scores(nx[i], ROWS * (1 - lane) + i);
  }
  // from the left lane: its G, packed maximum and last H of this step's
  // rows (shuffled at the end of the step before), and (hdiag) its last
  // H of the row before them
  int inG[ROWS], inPk[ROWS], inH[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    inG[i] = NEG;
    inPk[i] = 0;
    inH[i] = 0;
  }
  int hdiag = 0, te = -1, qe = -1;
  bool done = false;
  const int stop_pk = stop_at << PACK;    // cm >= stop_at as a packed value
  const int nsteps = tlen > 0 ? (tlen + ROWS - 1) / ROWS + last : 0;
  int s = 0;
  while (s < nsteps) {
    const int r0 = ROWS * (s - lane);
    int Gout[ROWS], pks[ROWS], hl[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      // the row's part that needs no left lane: H' and the lane's own
      // prefix of H' + e_ins c
      const int diag = lane == 0 ? 0 : (i == 0 ? hdiag : inH[i - 1]);
      int hp[K], pre[K];
      int acc = NEG;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int m = (k == 0 ? diag : H[k - 1]) + sc[i][k];
        hp[k] = max(max(m, E[k]), 0);
        pre[k] = acc;
        acc = max(acc, hp[k] + ec[k]);
      }
      // then the left lane's prefix G and packed maximum of the row
      const int G = lane == 0 ? NEG : inG[i];
      int pk = lane == 0 ? 0 : inPk[i];
      Gout[i] = max(G, acc);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int h = max(hp[k], max(max(G, pre[k]) - oec[k], 0));
        E[k] = max(max(h - oe_del, E[k] - g.e_del), 0);
        H[k] = h;
        pk = max(pk, tag[k] < 0 ? 0 : (h << PACK) | tag[k]);
      }
      pks[i] = pk;
      hl[i] = H[K - 1];
    }
    hdiag = inH[ROWS - 1];              // the left lane's row r0 - 1
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      inG[i] = __shfl_up_sync(FULL, Gout[i], 1);
      inPk[i] = __shfl_up_sync(FULL, pks[i], 1);
      inH[i] = __shfl_up_sync(FULL, hl[i], 1);
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
#pragma unroll
      for (int k = 0; k < K; ++k) sc[i][k] = nx[i][k];
      scores(nx[i], r0 + 2 * ROWS + i);
    }
    // the last lane completes rows r0 ..
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int r = r0 + i;
      const bool mine = lane == last && r >= 0 && r < tlen;
      if constexpr (STOP) {
        const bool hit = mine && !done && pks[i] >= stop_pk;   // the first
        te = hit ? r : te;
        qe = hit ? 1023 - (pks[i] & 1023) : qe;
        done = done || hit;
      } else {
        if (mine) rowpk[r] = pks[i];
      }
    }
    ++s;
    if (STOP && s % STOP_EVERY == 0 && __any_sync(FULL, done)) break;
  }
  return ScanOut{__shfl_sync(FULL, te, last), __shfl_sync(FULL, qe, last),
                 s};
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
kswa_kernel(const int32_t* __restrict__ qs,      // [J, L]
            const int32_t* __restrict__ q_lens,  // [J]
            const int32_t* __restrict__ ts,      // [J, T]
            const int32_t* __restrict__ t_lens,  // [J]
            int32_t* __restrict__ colmax,        // [J, T] scratch, rows'
                                                 // packed maxima
            int32_t* __restrict__ out,           // [7, J]
            int32_t* __restrict__ steps_out,     // [J] or null
            int J, int L, int T, int cm_shared, SwMat mat, Gap g,
            int minsc, int max_mat) {
  extern __shared__ int4 dyn[];
  __shared__ int smat[30];              // the 5 x 5 table, a padding row
  if (threadIdx.x < 30)
    smat[threadIdx.x] = threadIdx.x < 25 ? mat.v[threadIdx.x] : PAD;
  __syncthreads();
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int j = blockIdx.x * WARPS + w;
  if (j >= J) return;                       // whole warps only
  int8_t* sq = reinterpret_cast<int8_t*>(dyn)
               + warp_bytes(L, T, cm_shared) * w;
  int8_t* st = sq + pad16(L);
  // each forward row's packed maximum (H << PACK | 1023 - its column)
  int32_t* pkrow = cm_shared ? reinterpret_cast<int32_t*>(st + pad16(T))
                             : colmax + (size_t)j * T;
  const int qlen = min(max(q_lens[j], 0), L);
  const int tlen = min(max(t_lens[j], 0), T);
  const int32_t* qrow = qs + (size_t)j * L;
  const int32_t* trow = ts + (size_t)j * T;
  auto clamp_code = [](int c) { return c < 0 ? 0 : (c > 4 ? 4 : c); };
  for (int i = lane; i < qlen; i += 32) sq[i] = (int8_t)clamp_code(qrow[i]);
  for (int i = lane; i < tlen; i += 32) st[i] = (int8_t)clamp_code(trow[i]);
  __syncwarp();
  const int base = lane * K;

  // forward scan
  int qc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) qc[k] = base + k < qlen ? sq[base + k] : -1;
  const ScanOut f = scan<K, false>(qc, qlen, tlen, st,
                                   [](int i) { return i; }, smat, g, pkrow,
                                   0);
  // the first row of the largest maximum (te), its first column (qe)
  __syncwarp();
  int rbest = 0, rat = 1 << 30;
  for (int ti = lane; ti < tlen; ti += 32) {
    const int c = pkrow[ti] >> PACK;
    if (c > rbest) {
      rbest = c;
      rat = ti;
    }
  }
  const int gmax = __reduce_max_sync(FULL, rbest);
  const int first = (int)__reduce_min_sync(
      FULL, (unsigned)(rbest == gmax ? rat : 1 << 30));
  const int te = gmax > 0 ? first : -1;
  const int qe = gmax > 0 ? 1023 - (pkrow[te] & 1023) : -1;

  // score2 / te2: the largest column maximum outside te +- d, first on ties
  const int d = (gmax + max_mat - 1) / max_mat;
  const int floor2 = max(minsc, 1);
  int best = 0, at = 1 << 30;
  for (int ti = lane; ti < tlen; ti += 32) {
    const int c = pkrow[ti] >> PACK;
    if ((ti < te - d || ti > te + d) && c >= floor2 && c > best) {
      best = c;
      at = ti;
    }
  }
  const int score2 = __reduce_max_sync(FULL, best);
  const int te2_at = (int)__reduce_min_sync(
      FULL, (unsigned)(best == score2 ? at : (1 << 30)));
  const int te2 = score2 > 0 ? te2_at : -1;

  // start coordinates from the reversed prefixes
  int tb = -1, qb = -1, steps = f.steps;
  if (gmax > 0 && gmax >= minsc) {
    int rq[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = base + k;
      rq[k] = c <= qe ? sq[qe - c] : -1;
    }
    const ScanOut r = scan<K, true>(
        rq, qe + 1, te + 1, st, [te](int i) { return te - i; }, smat, g,
        nullptr, gmax);
    steps += r.steps;
    if (r.te >= 0) {
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
    if (steps_out != nullptr) steps_out[j] = steps;
  }
}

template <int K>
cudaError_t launch_k(dim3 grid, dim3 block, size_t bytes, cudaStream_t st,
                     const int32_t* q, const int32_t* ql, const int32_t* t,
                     const int32_t* tl, int32_t* cm, int32_t* o,
                     int32_t* steps, int J, int L, int T, int cm_shared,
                     SwMat mat, Gap g, int minsc, int max_mat) {
  if (bytes > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        kswa_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return e;
  }
  kswa_kernel<K><<<grid, block, bytes, st>>>(q, ql, t, tl, cm, o, steps, J,
                                             L, T, cm_shared, mat, g, minsc,
                                             max_mat);
  return cudaGetLastError();
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
// int32 scratch (used where a block's maxima do not fit in shared
// memory), steps [J] int32 (each job's steps, both scans) or null. The
// matrix's largest entry times 32 K must stay below 2^21 and the gap
// penalties >= 0. Returns the launch's CUDA error.
extern "C" int kswa_launch(const void* qs, const void* q_lens, const void* ts,
                           const void* t_lens, void* colmax, void* out,
                           void* steps, int J, int L, int T, SwMat mat,
                           int o_del, int e_del, int o_ins, int e_ins,
                           int minsc, int max_mat, void* stream) {
  if (J <= 0) return 0;
  int mmax = 0;
  for (int v : mat.v) mmax = v > mmax ? v : mmax;
  if (L < 0 || T < 1 || max_mat < 1 || o_del < 0 || e_del < 0 || o_ins < 0
      || e_ins < 0
      || (long long)mmax * 32 * kswa_k_for(L) >= (1 << (31 - PACK)))
    return (int)cudaErrorInvalidValue;
  const int cm_shared = WARPS * warp_bytes(L, T, true) <= COLMAX_BUDGET;
  const size_t bytes = WARPS * warp_bytes(L, T, cm_shared);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const Gap g{o_del, e_del, o_ins, e_ins};
  const dim3 grid((J + WARPS - 1) / WARPS), block(WARPS * 32);
  cudaStream_t st = (cudaStream_t)stream;
  const int32_t *q = (const int32_t*)qs, *ql = (const int32_t*)q_lens,
                *t = (const int32_t*)ts, *tl = (const int32_t*)t_lens;
  int32_t *cm = (int32_t*)colmax, *o = (int32_t*)out, *sp = (int32_t*)steps;
  switch (kswa_k_for(L)) {
#define KSWA_CASE(KK)                                                      \
  case KK:                                                                 \
    return (int)launch_k<KK>(grid, block, bytes, st, q, ql, t, tl, cm, o,  \
                             sp, J, L, T, cm_shared, mat, g, minsc,        \
                             max_mat);
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
}
