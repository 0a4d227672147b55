// SMEM seeding passes 1 and 2 for Hopper (sm_90a): one thread per task,
// the whole forward-then-backward walk in one launch.
//
// Replaces bwa_mem_scale_tpu/ops/smem_oh.py:174 one_pos_machine_oh (a
// jax.lax.while_loop the TPU runs as one program) through the port's
// lockstep counterpart, ops/smem_oh.py::one_pos_machine (~220 small
// PyTorch launches a tick and a host synchronisation every 8 ticks).
// It computes the reference's getSMEMsOnePosOneThread
// (src/FMI_search.cpp:1372-1660) for one task (read, start x, minimum
// interval mi): extend forward from x until the interval falls below mi
// or the read ends, pushing each interval whose size changed; then run
// backward rounds over the interval stack, emitting each SMEM that
// covers x and has at least min_seed_len bases; with chain restarts
// (pass 1) restart at next_x until the read ends, without (pass 2, the
// reseed from SMEM midpoints) stop after one position.
//
// The thread runs those natural nested loops, not the lockstep's tick
// state machine; the lockstep follows the same loops tick for tick, so
// emission order and every output array are the same, overflowed lanes
// included, by keeping its clamp rules:
// - a push at stack count c writes slot min(c, SD) (slot SD is written
//   only once the stack overflowed, and never read) and the count grows;
// - a stack read clamps its index to [0, SD - 1];
// - an emission past max_out is dropped and the count still grows;
// - a lane whose stack count ever exceeded SD returns cnt = max_out + 1,
//   and keeps walking to its end as the lockstep does.
// Every read of a code clamps its column to [0, L - 1], and every
// checkpoint row index to [0, nb - 1], as the lockstep's gathers do.
//
// Layout: the interval stacks of all tasks live in one scratch that the
// wrapper allocates, [2 buffers][4 fields (k, l, s, n)][SD + 1][T] int32,
// lane minor, so a warp's pushes and reads at equal depths coalesce; SD
// is the read length in the deepest retry tier, which rules out fixed
// local arrays. A lane's A stack is buffer wA, its B stack the other, and
// the end of a round flips wA. The outputs m, n, k, l, s are [T, max_out]
// each, zeroed by the wrapper; cnt and the lane's step count are [T].
//
// The occ step: backward_ext_all4 (ops/occ.py) for both ends of the
// interval, two 32-byte checkpoint rows of cp_fused ([nb, 8] int32:
// four exclusive counts, then four one-hot 32-bp block masks, MSB
// first), each fetched as two 16-byte read-only loads, counted with
// __popc under the top-y-bits mask, with the reference's sentinel
// correction. The C array (count[5]) and sentinel_index are launch
// arguments.
//
// What bounds it on this card: a chain of dependent loads, not bytes.
// Each step's checkpoint rows depend on the previous step's interval:
// 0.224 us a step on the 4.6 Mbp table, held in L2 (probe B, PERF.md
// §6), so the longest lane's steps set a latency floor far above the
// bytes the batch moves (64 a step). 32-thread blocks spread a 512-read
// batch over 16 SMs. Left for later work: a warp per read (the lanes of a
// read's positions or stack entries side by side), and the stacks in
// shared memory instead of device memory.

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

// occ(pp, base) for all four bases: one checkpoint row, two 16-byte loads
__device__ __forceinline__ int4 occ4(const Fmi& f, int pp) {
  int r = pp >> 5;                   // arithmetic, as torch's >> on int32
  r = r < 0 ? 0 : (r >= f.nb ? f.nb - 1 : r);
  const int4 cnt = __ldg(f.cp + 2 * (size_t)r);
  const int4 msk = __ldg(f.cp + 2 * (size_t)r + 1);
  const int y = pp & 31;
  // the top y bits; a shift by 32 is undefined, so y = 0 is 0 explicitly
  const unsigned top = y == 0 ? 0u : 0xffffffffu << (32 - y);
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
  nk = sel4(f.c0, f.c1, f.c2, f.c3, c) + sel4(a.x, a.y, a.z, a.w, c);
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
  auto C = [&](int c) {                     // c in [0, 4]
    return c == 4 ? f.c4 : sel4(f.c0, f.c1, f.c2, f.c3, c);
  };

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
