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
// Design. Block p (one warp) owns pair p. The DP row state of the plain
// version, eh_h and eh_e [QL + 2], lives in dynamic shared memory, and a
// row touches only its band [beg, end) = [max(i - w, 0), min(i + w + 1,
// qlen)), 32 columns a pass with a lane a column; columns outside the
// band keep their values, as the plain version's masks keep them. The
// write-back new_h[c] = H[c - 1] shifts by one column, so within a pass
// lanes 0-30 store their H at once and lane 31's H (column a + 32, the next
// pass's first column) is held in a register until the next pass has read
// that column's old value. F is the plain version's closed form: an
// exclusive prefix max of t_ins[k] + e_ins * k over the band, a 5-step
// shuffle scan within the pass plus a running carry across passes. The
// direction byte of each band cell (the plain version's bits: H's source
// in bits 0-1, E's continuation in bit 2, F's in bit 5) goes to a global
// scratch zb [P, TL, BW] at column k - beg, BW = min(2 * max w + 1, QL);
// the traceback reads a cell outside a row's band as 0, the value of the
// plain version's full z rectangle there. Lane 0 then walks the
// traceback, one dependent load a step, and the warp pads ops with -1.
//
// What bounds it: per band cell about 25 integer operations (profile 4,
// M / pre / direction 6, the F key and scan share 4, F 3, H / E / bits
// 8), so Sum over pairs of band cells over 16.7 T/s, and one direction
// byte written a cell plus one read a traceback step over 3.35 TB/s. Above
// both sits a latency floor: a pair's rows run one after another, each a
// chain of shared-memory loads, five shuffles and stores, and the
// traceback is a chain of dependent loads; the longest pair's rows times
// one row step, plus its traceback steps, bound the call. A warp a pair
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

struct Gap {
  int o_del, e_del, o_ins, e_ins;
};

__device__ __forceinline__ int clamp_code(int c) {
  return c < 0 ? 0 : (c > 4 ? 4 : c);
}

__global__ void __launch_bounds__(32)
kswg_kernel(const int32_t* __restrict__ qs,      // [P, QL]
            const int32_t* __restrict__ q_lens,  // [P]
            const int32_t* __restrict__ ts,      // [P, TL]
            const int32_t* __restrict__ t_lens,  // [P]
            const int32_t* __restrict__ w_p,     // [P]
            uint8_t* __restrict__ zb,            // [P, TL, BW] scratch
            int32_t* __restrict__ score,         // [P]
            int8_t* __restrict__ ops,            // [P, S]
            int32_t* __restrict__ n_ops,         // [P]
            int32_t* __restrict__ tail_del,      // [P]
            int32_t* __restrict__ tail_ins,      // [P]
            int QL, int TL, int BW, Prof prof, Gap s) {
  __shared__ int tab[25];
  extern __shared__ int sm[];
  int* eh_h = sm;                 // [QL + 2]
  int* eh_e = sm + QL + 2;        // [QL + 2]
  const int lane = threadIdx.x;
  const int p = blockIdx.x;
  const int qlen = min(max(q_lens[p], 0), QL);
  const int tlen = min(max(t_lens[p], 0), TL);
  const int w = w_p[p];
  const int oe_del = s.o_del + s.e_del, oe_ins = s.o_ins + s.e_ins;
  const int32_t* qrow = qs + (size_t)p * QL;
  const int32_t* trow = ts + (size_t)p * TL;
  uint8_t* zp = zb + (size_t)p * TL * BW;

  if (lane < 25) tab[lane] = prof.v[lane];
  // the first row: eh_h[0] = 0, eh_h[c] = -(o_ins + e_ins * c) for
  // 1 <= c <= min(w, qlen), else -inf; eh_e all -inf
  for (int c = lane; c < QL + 2; c += 32) {
    eh_h[c] = c == 0 ? 0
                     : ((c <= w && c <= qlen && c <= QL)
                            ? -(s.o_ins + s.e_ins * c) : NEG_INF);
    eh_e[c] = NEG_INF;
  }
  __syncwarp();

  for (int i = 0; i < tlen; ++i) {
    const int tb = clamp_code(trow[i]);
    const int beg = max(i - w, 0);
    const int end = min(i + w + 1, qlen);
    const int h1_first = beg == 0 ? -(s.o_del + s.e_del * (i + 1)) : NEG_INF;
    uint8_t* zrow = zp + (size_t)i * BW;
    int run_carry = NEG_INF;      // prefix max of the keys before the pass
    int hold = 0;                 // new_h of column a (the last pass's lane 31)
    for (int a = beg; a < end; a += 32) {
      const int j = a + lane;
      const bool inb = j < end;
      const int hprev = inb ? eh_h[j] : 0;
      const int eprev = inb ? eh_e[j] : NEG_INF;
      __syncwarp();               // this pass's old values are read
      if (lane == 0) {
        if (a == beg) {
          eh_h[beg] = h1_first;
        } else {
          eh_h[a] = hold;
        }
      }
      const int qp = tab[tb * 5 + (inb ? clamp_code(qrow[j]) : 0)];
      const int M = max(hprev + qp, NEG_INF);
      int dh = M >= eprev ? 0 : 1;
      const int pre = max(M, eprev);
      const int t_ins = max(M - oe_ins, NEG_INF);
      const int key = inb ? t_ins + s.e_ins * j : NEG_INF;
      int incl = key;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = max(incl, v);
      }
      int excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NEG_INF;
      excl = max(excl, run_carry);
      run_carry = max(run_carry, __shfl_sync(FULL, incl, 31));
      int f = max(excl - s.e_ins * (j - 1), NEG_INF);
      if (j == beg) f = NEG_INF;
      if (!(pre >= f)) dh = 2;
      const int H = max(pre, f);
      const int t_del = max(M - oe_del, NEG_INF);
      const int e_bit = (eprev - s.e_del) > t_del;
      const int E_next = max(eprev - s.e_del, t_del);
      const int f_bit = (f - s.e_ins) > t_ins;
      if (inb) {
        zrow[j - beg] = (uint8_t)(dh | (e_bit << 2) | (f_bit << 5));
        eh_e[j] = E_next;
        if (lane < 31) eh_h[j + 1] = H;
      }
      hold = __shfl_sync(FULL, H, 31);
      // lane 31's column a + 32 is the next pass's first column; with no
      // next pass it is the row's end column (h1_last = H[end - 1])
      if (lane == 31 && inb && a + 32 >= end) eh_h[j + 1] = H;
      __syncwarp();
    }
    if (lane == 0) {
      const int ce = min(max(end, 0), QL);
      if (end <= beg) {           // an empty band: h1_last = h1_first
        if (beg <= QL) eh_h[beg] = h1_first;
        eh_h[ce] = h1_first;
      }
      eh_e[ce] = NEG_INF;
    }
    __syncwarp();
  }

  // traceback, one lane; a cell outside its row's band reads 0
  if (lane == 0) {
    score[p] = eh_h[qlen];
    int8_t* orow = ops + (size_t)p * (QL + TL + 2);
    int i = tlen - 1;
    int k = min(i + w + 1, qlen) - 1;
    int which = 0, sc = 0;
    while (i >= 0 && k >= 0) {
      const int beg = max(i - w, 0);
      const int end = min(i + w + 1, qlen);
      const int d = (k >= beg && k < end) ? zp[(size_t)i * BW + (k - beg)]
                                          : 0;
      which = (d >> (which << 1)) & 3;
      orow[sc++] = (int8_t)(which == 0 ? 0 : (which == 1 ? 2 : 1));
      if (which != 2) --i;
      if (which != 1) --k;
    }
    n_ops[p] = sc;
    tail_del[p] = max(i + 1, 0);
    tail_ins[p] = max(k + 1, 0);
  }
  const int S = QL + TL + 2;
  const int sc = __shfl_sync(FULL, lane == 0 ? n_ops[p] : 0, 0);
  int8_t* orow = ops + (size_t)p * S;
  for (int c = sc + lane; c < S; c += 32) orow[c] = -1;
}

}  // namespace

// Dynamic shared memory of one block: eh_h and eh_e, (QL + 2) int32 each
// (the 25-int profile table is static).
extern "C" int kswg_smem_bytes(int QL) { return 2 * (QL + 2) * 4; }

// score / n_ops / tail_del / tail_ins [P] int32, ops [P, QL + TL + 2] int8,
// zb [P, TL, BW] uint8 scratch. Returns the launch's CUDA error.
extern "C" int kswg_launch(const void* qs, const void* q_lens, const void* ts,
                           const void* t_lens, const void* w_p, void* zb,
                           void* score, void* ops, void* n_ops,
                           void* tail_del, void* tail_ins, int P, int QL,
                           int TL, int BW, Prof prof, int o_del, int e_del,
                           int o_ins, int e_ins, void* stream) {
  if (P <= 0) return 0;
  if (QL < 1 || TL < 1 || BW < 1) return (int)cudaErrorInvalidValue;
  const int smem = kswg_smem_bytes(QL);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kswg_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  const Gap s{o_del, e_del, o_ins, e_ins};
  kswg_kernel<<<P, 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)qs, (const int32_t*)q_lens, (const int32_t*)ts,
      (const int32_t*)t_lens, (const int32_t*)w_p, (uint8_t*)zb,
      (int32_t*)score, (int8_t*)ops, (int32_t*)n_ops, (int32_t*)tail_del,
      (int32_t*)tail_ins, QL, TL, BW, prof, s);
  return (int)cudaGetLastError();
}
