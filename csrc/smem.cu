// The FM-index walks of the seeding and SA-lookup stages for Hopper
// (sm_90a): one thread per lane, each walk whole in one launch, no host
// synchronisation inside. Three kernels share the checkpoint-occ step
// (`Fmi`, `occ4`, `ext`) and live in this one source, since the build
// hashes one file:
// - one_pos_kernel: SMEM passes 1 and 2 (getSMEMsOnePosOneThread);
// - seed_strategy_kernel: SMEM pass 3 (bwtSeedStrategyAllPosOneThread);
// - sa_walk_kernel: the SA lookup's LF walk (get_sa_entry_compressed).
// Each replaces a jax.lax.while_loop the TPU runs as one program, through
// the port's lockstep counterpart in ops/ (tens to hundreds of small
// PyTorch launches a tick and a host synchronisation every 4-8 ticks).
// Each runs the reference's natural loop, not the lockstep's tick state
// machine; the lockstep follows the same loop tick for tick, so every
// output array is the same, and the clamp rules below keep it so for
// lanes the lockstep steps with junk: every read of a code clamps its
// column to [0, L - 1], and every checkpoint row index to [0, nb - 1],
// as the lockstep's gathers do.
//
// What bounds them on this card: a chain of dependent loads, not bytes.
// Each step's checkpoint rows depend on the previous step's interval or
// row: 0.224 us a step on the 4.6 Mbp table, held in L2 (probe B,
// PERF.md §6), so the longest lane's steps set a latency floor far above
// the bytes the batch moves (32 bytes a row). The designs spread the
// lanes over the SMs in small blocks so that no SM holds more than a few
// warps of the longest lanes.
//
// The occ step: backward_ext_all4 (ops/occ.py) for both ends of the
// interval, two 32-byte checkpoint rows of cp_fused ([nb, 8] int32:
// four exclusive counts, then four one-hot 32-bp block masks, MSB
// first), each fetched as two 16-byte read-only loads, counted with
// __popc under the top-y-bits mask, with the reference's sentinel
// correction. The C array (count[5]) and sentinel_index are launch
// arguments.
//
// ---- one_pos_kernel (passes 1 and 2)
// Replaces bwa_mem_scale_tpu/ops/smem_oh.py:174 one_pos_machine_oh
// through ops/smem_oh.py::one_pos_machine. It computes the reference's
// getSMEMsOnePosOneThread (src/FMI_search.cpp:1372-1660) for one task
// (read, start x, minimum interval mi): extend forward from x until the
// interval falls below mi or the read ends, pushing each interval whose
// size changed; then run backward rounds over the interval stack,
// emitting each SMEM that covers x and has at least min_seed_len bases;
// with chain restarts (pass 1) restart at next_x until the read ends,
// without (pass 2, the reseed from SMEM midpoints) stop after one
// position. Emission order and every output array equal the lockstep's,
// overflowed lanes included, by keeping its clamp rules:
// - a push at stack count c writes slot min(c, SD) (slot SD is written
//   only once the stack overflowed, and never read) and the count grows;
// - a stack read clamps its index to [0, SD - 1];
// - an emission past max_out is dropped and the count still grows;
// - a lane whose stack count ever exceeded SD returns cnt = max_out + 1,
//   and keeps walking to its end as the lockstep does.
// Layout: the interval stacks of all tasks live in one scratch that the
// wrapper allocates, [2 buffers][4 fields (k, l, s, n)][SD + 1][T] int32,
// lane minor, so a warp's pushes and reads at equal depths coalesce; SD
// is the read length in the deepest retry tier, which rules out fixed
// local arrays. A lane's A stack is buffer wA, its B stack the other, and
// the end of a round flips wA. The outputs m, n, k, l, s are [T, max_out]
// each, zeroed by the wrapper; cnt and the lane's step count are [T].
// 32-thread blocks spread a 512-read batch over 16 SMs. Left for later
// work: a warp per read (the lanes of a read's positions or stack
// entries side by side), and the stacks in shared memory.
//
// ---- seed_strategy_kernel (pass 3)
// Replaces bwa_mem_scale_tpu/ops/smem_oh.py:619 seed_strategy_machine_oh
// through ops/smem_oh.py::seed_strategy_machine. One thread a read runs
// bwtSeedStrategyAllPosOneThread (src/FMI_search.cpp:1662-1730): for each
// start x, skip an N; from the base's C-array interval extend forward a
// base a step (ext on the swapped ends, as pass 1's forward walk) and
// stop at the first j where the size falls below max_intv with at least
// min_seed_len bases, emitting (x, j, k, l, s) when s > 0, or at an N or
// the read's end; go on from j + 1 after a hit or an N. An emission past
// max_out is dropped and the count still grows (no stacks, so no
// max_out + 1 latch). Out of scope: the JAX machine's k-step branch
// (`use2`, two bases a gather over cp2_fused), since the port refuses the
// k-step table. 32-thread blocks: 16 SMs for a 512-read batch; its lanes
// walk ~100 steps each, so the longest lane's chain is the floor.
//
// ---- sa_walk_kernel (SA lookup)
// Replaces bwa_mem_scale_tpu/ops/sal.py:23 sa_lookup (its LF-walk loops)
// through ops/sal.py::sa_lookup_plain. One thread a coordinate walks
// from BWT row sp: a sampled row (sp & mask == 0) gives
// sa_samples[sp >> compx] + offset; otherwise one checkpoint row gives
// the base b = BWT[sp] (the mask whose bit 31 - y is set, MSB first, or
// 4 at the sentinel row, which gives offset) and occ(sp, b), and the
// walk moves to count[b] + occ with offset + 1. The sample index is
// clamped to [0, n_samples - 1]; an invalid lane returns 0. The walk is
// geometric (a row is sampled with p = 2^-compx), so the longest of 16k
// lanes walks ~60 rows while the mean walks ~8: 128-thread blocks over
// the SMs, each thread retiring as it finds its sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 32;            // tasks (threads) a block

struct Fmi {
  const int4* cp;                    // [nb][2] int4: counts, masks
  int nb;
  int c0, c1, c2, c3, c4;            // the C array
  int sentinel;
};

__device__ __forceinline__ int sel4(int a, int b, int c, int d, int i) {
  return i == 0 ? a : (i == 1 ? b : (i == 2 ? c : d));
}

__device__ __forceinline__ int sel4(const int4& v, int i) {
  return sel4(v.x, v.y, v.z, v.w, i);
}

// C[c] for c in [0, 4]
__device__ __forceinline__ int cval(const Fmi& f, int c) {
  return c == 4 ? f.c4 : sel4(f.c0, f.c1, f.c2, f.c3, c);
}

// the top y bits of a 32-bit word; a shift by 32 is undefined, so y = 0
// is 0 explicitly
__device__ __forceinline__ unsigned top_bits(int y) {
  return y == 0 ? 0u : 0xffffffffu << (32 - y);
}

// the checkpoint row holding position pp, its index clamped to [0, nb)
__device__ __forceinline__ const int4* cp_row(const Fmi& f, int pp) {
  int r = pp >> 5;                   // arithmetic, as torch's >> on int32
  r = r < 0 ? 0 : (r >= f.nb ? f.nb - 1 : r);
  return f.cp + 2 * (size_t)r;
}

// occ(pp, base) for all four bases: one checkpoint row, two 16-byte loads
__device__ __forceinline__ int4 occ4(const Fmi& f, int pp) {
  const int4* row = cp_row(f, pp);
  const int4 cnt = __ldg(row);
  const int4 msk = __ldg(row + 1);
  const unsigned top = top_bits(pp & 31);
  return make_int4(cnt.x + __popc((unsigned)msk.x & top),
                   cnt.y + __popc((unsigned)msk.y & top),
                   cnt.z + __popc((unsigned)msk.z & top),
                   cnt.w + __popc((unsigned)msk.w & top));
}

// The backward extension of (k, l, s) by base c in [0, 3]
// (ops/occ.py::backward_ext_all4, then the base's column).
__device__ __forceinline__ void ext(const Fmi& f, int k, int l, int s,
                                    int c, int& nk, int& nl, int& ns) {
  const int4 a = occ4(f, k);
  const int4 b = occ4(f, k + s);
  const int s0 = b.x - a.x, s1 = b.y - a.y, s2 = b.z - a.z, s3 = b.w - a.w;
  const int sent = (k <= f.sentinel) & (k + s > f.sentinel);
  // l of base c: l + sent + the sizes of the bases above c
  nl = l + sent + (c < 3 ? s3 : 0) + (c < 2 ? s2 : 0) + (c < 1 ? s1 : 0);
  nk = cval(f, c) + sel4(a, c);
  ns = sel4(s0, s1, s2, s3, c);
}

__global__ void __launch_bounds__(BLOCK)
one_pos_kernel(Fmi f, const int32_t* __restrict__ codes,   // [B, L]
               const int32_t* __restrict__ lens,           // [B]
               int B, int L,
               const int32_t* __restrict__ t_read,         // [T]
               const int32_t* __restrict__ t_x,            // [T]
               const int32_t* __restrict__ t_mi,           // [T]
               const uint8_t* __restrict__ t_valid,        // [T]
               int T, int chain_restarts, int min_seed_len, int M, int SD,
               int32_t* __restrict__ stk,       // [2][4][SD + 1][T]
               int32_t* __restrict__ out,       // [5][T][M]: m n k l s
               int32_t* __restrict__ cnt_out,   // [T]
               int32_t* __restrict__ steps_out) {  // [T]
  const int t = blockIdx.x * BLOCK + threadIdx.x;
  if (t >= T) return;
  int rd = t_read[t];
  rd = rd < 0 ? 0 : (rd >= B ? B - 1 : rd);
  const int32_t* q = codes + (size_t)rd * L;
  const int len = t_valid[t] ? lens[rd] : 0;
  const int mi = t_mi[t];
  const size_t plane = (size_t)(SD + 1) * T;      // one field of a buffer
  const size_t tm = (size_t)T * M;                 // one output field
  auto slot = [&](int buf, int fld, int i) -> int32_t& {
    return stk[(size_t)(buf * 4 + fld) * plane + (size_t)i * T + t];
  };
  auto code = [&](int i) { return q[i < 0 ? 0 : (i >= L ? L - 1 : i)]; };
  auto C = [&](int c) { return cval(f, c); };

  int cnt = 0, steps = 0, wA = 0;
  bool of = false;
  auto push = [&](int buf, int& c, int k, int l, int s, int n) {
    const int i = c < SD ? c : SD;
    slot(buf, 0, i) = k;
    slot(buf, 1, i) = l;
    slot(buf, 2, i) = s;
    slot(buf, 3, i) = n;
    ++c;
    of |= c > SD;
  };
  auto read = [&](int buf, int i, int& k, int& l, int& s, int& n) {
    i = i < 0 ? 0 : (i >= SD ? SD - 1 : i);
    k = slot(buf, 0, i);
    l = slot(buf, 1, i);
    s = slot(buf, 2, i);
    n = slot(buf, 3, i);
  };
  auto emit = [&](int m, int n, int k, int l, int s) {
    if (cnt < M) {
      const size_t o = (size_t)t * M + cnt;
      out[o] = m;
      out[tm + o] = n;
      out[2 * tm + o] = k;
      out[3 * tm + o] = l;
      out[4 * tm + o] = s;
    }
    ++cnt;
  };

  int x = t_x[t];
  for (;;) {                                       // start positions
    const int xa = x < len ? code(x) : 4;
    if (xa >= 4) {
      if (chain_restarts && ++x < len) continue;
      break;
    }
    // forward extension from x
    int ck = C(xa), cl = C(3 - xa), cs = C(xa + 1) - C(xa), cn = x;
    int j = x + 1, nx = x + 1, cA = 0;
    while (j < len) {
      nx = j + 1;
      const int a = code(j);
      if (a >= 4) break;
      int nk, nl, ns;
      ext(f, cl, ck, cs, 3 - a, nl, nk, ns);       // the swapped interval
      ++steps;
      if (ns != cs) push(wA, cA, ck, cl, cs, cn);
      if (ns < mi) {
        nx = j;
        break;
      }
      ck = nk;
      cl = nl;
      cs = ns;
      cn = j;
      ++j;
    }
    if (cs >= mi) push(wA, cA, ck, cl, cs, cn);

    // backward rounds: the first reads the A stack from its top
    int mA = x;
    bool rev = true;
    for (j = x - 1;; --j) {
      const int a = j < 0 ? 4 : code(j);
      if (a >= 4 || cA == 0) {
        if (cA > 0) {
          int pk, pl, ps, pn;
          read(wA, rev ? cA - 1 : 0, pk, pl, ps, pn);
          if (pn - mA + 1 >= min_seed_len) emit(mA, pn, pk, pl, ps);
        }
        break;
      }
      int cB = 0, curr_s = -1;
      bool hit = false;
      for (int p = 0; p < cA; ++p) {
        int pk, pl, ps, pn, nk, nl, ns;
        read(wA, rev ? cA - 1 - p : p, pk, pl, ps, pn);
        ext(f, pk, pl, ps, a, nk, nl, ns);
        ++steps;
        bool keep;
        if (hit) {                                  // the tail
          keep = ns >= mi && ns != curr_s;
        } else if (ns < mi) {                       // dies here
          hit = pn - mA + 1 >= min_seed_len;
          if (hit) emit(mA, pn, pk, pl, ps);
          keep = false;
        } else {
          keep = hit = ns != curr_s;
        }
        if (keep) {
          push(wA ^ 1, cB, nk, nl, ns, pn);
          curr_s = ns;
        }
      }
      wA ^= 1;
      cA = cB;
      mA = j;
      rev = false;
    }
    if (!chain_restarts) break;
    x = max(nx, x + 1);
    if (x >= len) break;
  }
  cnt_out[t] = of ? M + 1 : cnt;
  steps_out[t] = steps;
}

__global__ void __launch_bounds__(BLOCK)
seed_strategy_kernel(Fmi f, const int32_t* __restrict__ codes,  // [B, L]
                     const int32_t* __restrict__ lens,          // [B]
                     int B, int L, int max_intv, int min_seed_len, int M,
                     int32_t* __restrict__ out,     // [5][B][M]: m n k l s
                     int32_t* __restrict__ cnt_out,     // [B]
                     int32_t* __restrict__ steps_out) {  // [B]
  const int t = blockIdx.x * BLOCK + threadIdx.x;
  if (t >= B) return;
  const int32_t* q = codes + (size_t)t * L;
  const int len = lens[t];
  const size_t tm = (size_t)B * M;                 // one output field
  auto code = [&](int i) { return q[i < 0 ? 0 : (i >= L ? L - 1 : i)]; };
  int cnt = 0, steps = 0;
  for (int x = 0; x < len;) {                      // start positions
    const int xa = code(x);
    if (xa >= 4) {
      ++x;
      continue;
    }
    int ck = cval(f, xa), cl = cval(f, 3 - xa);
    int cs = cval(f, xa + 1) - ck;
    int j = x + 1;
    while (j < len) {                              // forward from x
      const int a = code(j++);
      if (a >= 4) break;                           // go on after the N
      int nk, nl, ns;
      ext(f, cl, ck, cs, 3 - a, nl, nk, ns);       // the swapped interval
      ++steps;
      if (ns < max_intv && j - x >= min_seed_len) {  // j - 1 - x + 1
        if (ns > 0) {
          if (cnt < M) {
            const size_t o = (size_t)t * M + cnt;
            out[o] = x;
            out[tm + o] = j - 1;
            out[2 * tm + o] = nk;
            out[3 * tm + o] = nl;
            out[4 * tm + o] = ns;
          }
          ++cnt;
        }
        break;                                     // go on after the hit
      }
      ck = nk;
      cl = nl;
      cs = ns;
    }
    x = j;                                         // the read's end, or
  }                                                // past the hit or N
  cnt_out[t] = cnt;
  steps_out[t] = steps;
}

constexpr int SAL_BLOCK = 128;       // coordinates (threads) a block

__global__ void __launch_bounds__(SAL_BLOCK)
sa_walk_kernel(Fmi f, const int32_t* __restrict__ samples, int n_samples,
               int compx, const int32_t* __restrict__ pos,   // [N]
               const uint8_t* __restrict__ valid,             // [N]
               int N, int32_t* __restrict__ out,               // [N]
               int32_t* __restrict__ steps_out) {              // [N]
  const int t = blockIdx.x * SAL_BLOCK + threadIdx.x;
  if (t >= N) return;
  int res = 0, steps = 0;
  if (valid[t]) {
    const int mask = (1 << compx) - 1;
    int sp = pos[t], offset = 0;
    for (;;) {
      ++steps;
      if ((sp & mask) == 0) {                      // a sampled row
        int i = sp >> compx;
        i = i < 0 ? 0 : (i >= n_samples ? n_samples - 1 : i);
        res = __ldg(samples + i) + offset;
        break;
      }
      const int4* row = cp_row(f, sp);             // occ_b_and_base
      const int4 cnt = __ldg(row);
      const int4 msk = __ldg(row + 1);
      const int y = sp & 31;
      const unsigned bit = 1u << (31 - y);
      const int b = ((unsigned)msk.x & bit) ? 0
                    : ((unsigned)msk.y & bit) ? 1
                    : ((unsigned)msk.z & bit) ? 2
                    : ((unsigned)msk.w & bit) ? 3 : 4;
      if (b == 4) {                                // the sentinel row
        res = offset;
        break;
      }
      sp = cval(f, b) + sel4(cnt, b)
           + __popc((unsigned)sel4(msk, b) & top_bits(y));
      ++offset;
    }
  }
  out[t] = res;
  steps_out[t] = steps;
}

}  // namespace

// Launch one_pos_kernel on `stream` over T tasks; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a shape
// it cannot take. The caller allocates every buffer (outputs zeroed, the
// stack scratch [2][4][SD + 1][T] int32) and checks shapes and types;
// nothing here synchronises.
extern "C" int one_pos_launch(const void* cp_fused, int nb, int c0, int c1,
                              int c2, int c3, int c4, int sentinel,
                              const void* codes, const void* lens, int B,
                              int L, const void* t_read, const void* t_x,
                              const void* t_mi, const void* t_valid, int T,
                              int chain_restarts, int min_seed_len, int M,
                              int SD, void* stk, void* out, void* cnt,
                              void* steps, void* stream) {
  if (T <= 0) return 0;
  if (nb <= 0 || B <= 0 || L <= 0 || M < 0 || SD <= 0)
    return (int)cudaErrorInvalidValue;
  const Fmi f{(const int4*)cp_fused, nb, c0, c1, c2, c3, c4, sentinel};
  one_pos_kernel<<<(T + BLOCK - 1) / BLOCK, BLOCK, 0,
                   (cudaStream_t)stream>>>(
      f, (const int32_t*)codes, (const int32_t*)lens, B, L,
      (const int32_t*)t_read, (const int32_t*)t_x, (const int32_t*)t_mi,
      (const uint8_t*)t_valid, T, chain_restarts, min_seed_len, M, SD,
      (int32_t*)stk, (int32_t*)out, (int32_t*)cnt, (int32_t*)steps);
  return (int)cudaGetLastError();
}

// Launch seed_strategy_kernel on `stream` over B reads; the return and
// the caller's duties as one_pos_launch (outputs [5][B][M] zeroed).
extern "C" int seed_strategy_launch(const void* cp_fused, int nb, int c0,
                                    int c1, int c2, int c3, int c4,
                                    int sentinel, const void* codes,
                                    const void* lens, int B, int L,
                                    int max_intv, int min_seed_len, int M,
                                    void* out, void* cnt, void* steps,
                                    void* stream) {
  if (B <= 0) return 0;
  if (nb <= 0 || L <= 0 || M < 0) return (int)cudaErrorInvalidValue;
  const Fmi f{(const int4*)cp_fused, nb, c0, c1, c2, c3, c4, sentinel};
  seed_strategy_kernel<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0,
                         (cudaStream_t)stream>>>(
      f, (const int32_t*)codes, (const int32_t*)lens, B, L, max_intv,
      min_seed_len, M, (int32_t*)out, (int32_t*)cnt, (int32_t*)steps);
  return (int)cudaGetLastError();
}

// Launch sa_walk_kernel on `stream` over N coordinates (1 <= compx <= 30;
// the wrapper keeps compx = 0, the full SA, as one gather); the return
// and the caller's duties as one_pos_launch.
extern "C" int sa_walk_launch(const void* cp_fused, int nb, int c0, int c1,
                              int c2, int c3, int c4, int sentinel,
                              const void* samples, int n_samples, int compx,
                              const void* pos, const void* valid, int N,
                              void* out, void* steps, void* stream) {
  if (N <= 0) return 0;
  if (nb <= 0 || n_samples <= 0 || compx < 1 || compx > 30)
    return (int)cudaErrorInvalidValue;
  const Fmi f{(const int4*)cp_fused, nb, c0, c1, c2, c3, c4, sentinel};
  sa_walk_kernel<<<(N + SAL_BLOCK - 1) / SAL_BLOCK, SAL_BLOCK, 0,
                   (cudaStream_t)stream>>>(
      f, (const int32_t*)samples, n_samples, compx, (const int32_t*)pos,
      (const uint8_t*)valid, N, (int32_t*)out, (int32_t*)steps);
  return (int)cudaGetLastError();
}
