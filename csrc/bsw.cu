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

#include "bsw_warp.cuh"

namespace {

using bsw::Pen;
using bsw::WARPS;

template <int K, bool SMEM>
__global__ void __launch_bounds__(WARPS * 32)
bsw_warp_kernel(const int32_t* __restrict__ qs,      // [P, QL]
                const int32_t* __restrict__ ts,      // [P, TL]
                const int32_t* __restrict__ q_lens,  // [P]
                const int32_t* __restrict__ t_lens,  // [P]
                const int32_t* __restrict__ h0s,     // [P]
                int32_t* __restrict__ out,           // [6, P]
                int P, int QL, int TL, Pen pen) {
  bsw::warp_body<K, SMEM>(qs, ts, q_lens, t_lens, h0s, out, P, QL, TL, pen,
                          bsw::NoEpilogue{});
}

__global__ void __launch_bounds__(WARPS * 32)
bsw_tiled_kernel(const int32_t* __restrict__ qs,      // [P, QL]
                 const int32_t* __restrict__ ts,      // [P, TL]
                 const int32_t* __restrict__ q_lens,  // [P]
                 const int32_t* __restrict__ t_lens,  // [P]
                 const int32_t* __restrict__ h0s,     // [P]
                 int32_t* __restrict__ out,           // [6, P]
                 int32_t* __restrict__ scratch,
                 int P, int QL, int TL, Pen pen) {
  bsw::tiled_body(qs, ts, q_lens, t_lens, h0s, out, scratch, P, QL, TL, pen,
                  bsw::NoEpilogue{});
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
    BSW_INSTANTIATIONS(BSW_CASE)
#undef BSW_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
