// The readlane seeding engine for Hopper (sm_90a): the read-per-lane SMEM
// machines of bwa_mem_scale_tpu/ops/smem_rl.py over a pool of worker
// lanes, each walk whole in one launch with no host synchronisation
// inside.
// - readlane_one_pos_kernel<STACKS_IN_SHARED, KS, P>: SMEM passes 1 and 2
//   (getSMEMsOnePosOneThread, src/FMI_search.cpp:1372-1660). Replaces
//   bwa_mem_scale_tpu/ops/smem_rl.py:55 one_pos_machine (its
//   jax.lax.while_loop at :596) through ops/smem_rl.py::one_pos_machine.
// - readlane_strategy_kernel<KS, P>: SMEM pass 3
//   (bwtSeedStrategyAllPosOneThread, src/FMI_search.cpp:1662-1730).
//   Replaces bwa_mem_scale_tpu/ops/smem_rl.py:603 seed_strategy_machine
//   (its loop at :764) through ops/smem_rl.py::seed_strategy_machine.
//
// The contract. The JAX machines run `lanes` lanes over a backlog of tasks
// (passes 1-2: (read, x, min_intv); pass 3: reads): a lane that finishes
// its task pulls the next unassigned one, kt_for's dynamic scheduling
// (src/kthread.cpp:41-77). Here too `lanes` worker lanes (one a task when
// lanes is None) pull tasks with atomicAdd on a counter the wrapper
// zeroes; the order of the pulls is not deterministic on the card. A
// task's emissions land in its own output row (out_rows[task] for passes
// 1-2, the read for pass 3), zeros past its count, an emission past M
// dropped while the count grows, so every output array equals the plain
// lockstep machine's whatever the pull order.
//
// What bounds them on this card: each walk's chain of dependent L2 row
// trips. An occ step's two checkpoint rows depend on the interval the
// step before made (0.158 us a dependent row load on the 4.6 Mbp table,
// held in L2, on an NVIDIA H100 80GB HBM3 at 700 W: probe B, PERF.md
// section 6); the bytes (64 a step) take a few microseconds at 3.35 TB/s.
// So the designs keep every other load off that chain and run side by
// side the steps that do not wait on each other.
//
// readlane_one_pos_kernel: a warp a worker lane. The wrapper launches
// `lanes` one-warp blocks, so a 512-task pass runs 512 warps over the 132
// SMs. Lane 0 pulls a task with atomicAdd and broadcasts it; the warp
// zeroes the task's output row, stages the read's codes into its shared
// memory as bytes (16-byte loads, csrc/fmi_step.cuh stage_codes, a
// negative code clipped to 0 as the lockstep does) and runs the task as
// csrc/smem.cu's one_pos_kernel runs one (csrc/one_pos_task.cuh, one body
// for both): the forward walk serially on every lane as one broadcast,
// each backward round as one trip, 32 entries a chunk, its keep/emit rule
// resolved by a ballot and __shfl_up_sync on the two orders along a round
// (csrc/smem.cu's note). Both interval stacks live in the warp's dynamic
// shared memory at the full depth L that no walk can overflow (a forward
// walk from x pushes at most len - x entries), 3,264 bytes at L = 101 (6.5
// KB at int64), carried from task to task (a walk reads only the slots it
// wrote); where the codes and stacks pass 227 KB (L past ~7,000 at int64,
// long reads under -x pacbio), they live in a device scratch [lanes][2][L
// + 1] (STACKS_IN_SHARED false), chosen by shape
// (readlane_stacks_in_shared). A warp pulls its next task with no
// block-wide barrier. A lane's latency floor is the sum of its tasks'
// rounds (forward row fetches plus backward chunks), not their steps.
// The kernel asks for one block an SM at least (__launch_bounds__(WARP,
// 1)), so ptxas gives the int64 and K = 3 forms the registers they need:
// without it they took 64 and the int64 forms spilled 124-152 bytes,
// 1.10-1.13x the time (PERF.md section 6).
//
// readlane_strategy_kernel: a thread a worker lane, RW lanes a one-warp
// block (the wrapper's lanes a warp: 8, fewer where RW slots of codes
// pass 227 KB or the pool is smaller), so the pool spreads over lanes /
// RW SMs. Each pull stages the read's codes into the lane's own slot of
// shared memory (16-byte loads), and the start loop and the walk are one
// flat loop of exactly one ext an iteration, as csrc/smem.cu's
// seed_strategy_kernel: the restart at a hit or an N (`seek`), the INIT of
// the JAX tick, is a state update over shared memory inside the
// iteration, and the end of a read (its row's zeros, the next pull) too.
// A read's walks are one chain of ~L - 1 dependent steps (a walk ends
// where the next begins), so a warp a read would not cut the floor.
//
// Each lane reports its `steps` (occ steps: single bases at every KS, the
// work) and `ticks` (its loop iterations that make an occ trip: passes
// 1-2 forward row fetches plus backward chunks, pass 3 row fetches).
//
// The k-step forms (KS = 2, 3; int32 layout only):
// readlane_one_pos_kernel<.., KS, int> runs one_pos_task's k-step form,
// as one_pos_k_kernel<.., KS> does (csrc/smem.cu's note): the k-gram
// table alone, KS bases a fetch forward, and KS backward rounds a fetch
// where a round fits one chunk. readlane_strategy_kernel<2, int> takes
// two bases a row fetch (a trigram table's bigram groups) through
// csrc/fmi_step.cuh ext_k, from the k-gram table alone too. The int64 forms (P = long
// long, the launch functions ending in 64) run the int64 layout of
// ops/occ.py (csrc/fmi_step.cuh).
//
// The retired design (a thread a worker lane in 32-thread blocks,
// the stacks in a [lanes][2][L + 1] device scratch, each code a global
// load, the INIT/FWD/BSCAN/BTAIL ticks divergent in a warp) took, on
// phase 5's batch on that card, pass 1 0.43532 ms at one lane a task and
// 2.58874 ms at 64 lanes, pass 2 0.09821 ms, pass 3 0.07906 ms (PERF.md
// section 6, with what held it back).

#include "fmi_step.cuh"
#include "one_pos_task.cuh"

namespace {

// zeros into the n words [p, p + n) by one thread: 16-byte stores over
// the aligned body, the few words before and after it one by one
__device__ __forceinline__ void zero_words(int32_t* p, int n) {
  const int head = min(n, (int)((16 - ((uintptr_t)p & 15)) & 15) >> 2);
  const int n4 = (n - head) >> 2;
  int4* body = reinterpret_cast<int4*>(p + head);
  for (int i = 0; i < head; ++i) p[i] = 0;
  for (int i = 0; i < n4; ++i) body[i] = make_int4(0, 0, 0, 0);
  for (int i = head + 4 * n4; i < n; ++i) p[i] = 0;
}

// a row's slots from c0 on zeroed by one thread, field by field
template <typename P>
__device__ __forceinline__ void zero_tail(const SmemRows<P>& rows, int row,
                                          int c0) {
  const size_t o = (size_t)row * rows.M + c0;
  const int n = rows.M - c0;
  P* kls = reinterpret_cast<P*>(rows.out + 2 * rows.tm);
  zero_words(rows.out + o, n);
  zero_words(rows.out + rows.tm + o, n);
  for (int fld = 0; fld < 3; ++fld)
    zero_words(reinterpret_cast<int32_t*>(kls + fld * rows.tm + o),
               n * (int)(sizeof(P) / 4));
}

template <bool STACKS_IN_SHARED, int KS, typename P>
__global__ void __launch_bounds__(WARP, 1)
readlane_one_pos_kernel(Fmi<P> f, Kfmi g,
                        const int32_t* __restrict__ codes,     // [B, L]
                        const int32_t* __restrict__ lens,      // [B]
                        int B, int L,
                        const int32_t* __restrict__ t_read,    // [N]
                        const int32_t* __restrict__ t_x,       // [N]
                        const int32_t* __restrict__ t_mi,      // [N]
                        const uint8_t* __restrict__ t_valid,   // [N]
                        const int32_t* __restrict__ t_row,     // [N]
                        int N, int chain_restarts, int min_seed_len, int M,
                        int R,
                        Ent<P>* __restrict__ scratch,  // [T][2][L + 1] or null
                        int* __restrict__ next_task,   // 0 at the launch
                        int32_t* __restrict__ out,     // [R] rows
                        int32_t* __restrict__ cnt_out,     // [R]
                        int32_t* __restrict__ steps_out,   // [T]
                        int32_t* __restrict__ ticks_out) {  // [T]
  extern __shared__ int4 smem[];
  const int w = blockIdx.x;                        // the worker lane
  const int lane = threadIdx.x;
  const SmemRows<P> rows{out, (size_t)R * M, M};
  // the shared memory: [2][L + 1] stack entries, then the codes
  Ent<P>* stk = STACKS_IN_SHARED ? reinterpret_cast<Ent<P>*>(smem)
                                 : scratch + (size_t)w * 2 * (L + 1);
  int8_t* q = STACKS_IN_SHARED
                  ? reinterpret_cast<int8_t*>(stk + 2 * (L + 1))
                  : reinterpret_cast<int8_t*>(smem);
  const WarpC wc = KS > 1 ? warp_c(g, lane) : WarpC{0, 0, 0};
  int steps = 0, ticks = 0;
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(next_task, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= N) break;
    int rd = t_read[t];
    rd = rd < 0 ? 0 : (rd >= B ? B - 1 : rd);
    const int len = t_valid[t] ? lens[rd] : 0;
    const int row = t_row[t];
    __syncwarp();              // the last task's reads of the codes are done
    rows.zero(row, lane);
    if (len > 0)
      stage_codes<true>(codes + (size_t)rd * L, L, q, lane, WARP);
    __syncwarp();              // the codes, and the zeros before any emission
    // the depth L: no stack overflows, so the count needs no latch
    const TaskCounts c = one_pos_task<KS, P>(
        f, g, wc, q, L, len, t_x[t], t_mi[t], chain_restarts, min_seed_len,
        L, stk, rows, row, lane);
    if (lane == 0) cnt_out[row] = c.cnt;
    steps += c.steps;
    ticks += c.rounds;
  }
  if (lane == 0) {
    steps_out[w] = steps;
    ticks_out[w] = ticks;
  }
}

template <int KS, typename P>
__global__ void __launch_bounds__(WARP)
readlane_strategy_kernel(Fmi<P> f, Kfmi g,
                         const int32_t* __restrict__ codes,    // [B, L]
                         const int32_t* __restrict__ lens,     // [B]
                         int B, int L, int T,
                         int RW,              // worker lanes a block
                         int max_intv, int min_seed_len, int M,
                         int* __restrict__ next_read,    // 0 at the launch
                         int32_t* __restrict__ out,      // [B] rows
                         int32_t* __restrict__ cnt_out,  // [B]
                         int32_t* __restrict__ steps_out,   // [T]
                         int32_t* __restrict__ ticks_out) {  // [T]
  extern __shared__ int4 smem[];
  const int w = blockIdx.x * RW + threadIdx.x;    // the worker lane
  if ((int)threadIdx.x >= RW || w >= T) return;
  int8_t* q = reinterpret_cast<int8_t*>(smem) + threadIdx.x * codes_bytes(L);
  const SmemRows<P> rows{out, (size_t)B * M, M};
  auto code = [&](int i) { return q[i < 0 ? 0 : (i >= L ? L - 1 : i)]; };
  int steps = 0, ticks = 0;
  int rd = -1, len = 0, cnt = 0, x = 0, j = 0, a = 4;
  P ck = 0, cl = 0, cs = 0;
  // The next walk with an ext to make, from start `from`: x the first
  // base at or past it, j = x + 1 a base inside the read (a its code),
  // (ck, cl, cs) x's C-array interval. A walk whose first column is an N
  // makes no ext and goes on past that N. False at the read's end.
  auto seek = [&](int from) -> bool {
    for (x = from;; x = j + 1) {
      while (x < len && code(x) >= 4) ++x;
      j = x + 1;
      if (j >= len) return false;
      a = code(j);
      if (a < 4) break;
    }
    const int xa = code(x);
    ck = cval(f, xa);
    cl = cval(f, 3 - xa);
    cs = cval(f, xa + 1) - ck;
    return true;
  };
  // The next read with a walk to make: the last read's row finished
  // (zeros past its count, the count), the next pulled and its codes
  // staged. False when the backlog is empty.
  auto next = [&]() -> bool {
    for (;;) {
      if (rd >= 0) {
        zero_tail(rows, rd, cnt < M ? cnt : M);
        cnt_out[rd] = cnt;
      }
      rd = atomicAdd(next_read, 1);
      if (rd >= B) return false;
      len = lens[rd];
      cnt = 0;
      if (len > 0) stage_codes<true>(codes + (size_t)rd * L, L, q, 0, 1);
      if (seek(0)) return true;
    }
  };
  bool live = next();
  // one base of the walk, its extension (nk, nl, ns) made and the next
  // base an read: at a hit emit when s > 0 and seek on after it; at the
  // read's end or an N stop or seek; true while the walk goes on
  auto take = [&](P nk, P nl, P ns, int an) {
    ++steps;
    if (ns < max_intv && j + 1 - x >= min_seed_len) {
      if (ns > 0) {
        if (cnt < M) rows.put(rd, cnt, x, j, nk, nl, ns);
        ++cnt;
      }
      live = seek(j + 1);                          // go on after the hit
      return false;
    }
    ck = nk;
    cl = nl;
    cs = ns;
    a = an;
    if (++j >= len) {                              // the read's end
      live = false;
      return false;
    }
    if (a >= 4) {                                  // go on after the N
      live = seek(j + 1);
      return false;
    }
    return true;
  };
  while (live) {                  // one row fetch (KS bases) an iteration
    const int an = code(j + 1);                    // read a step ahead
    ++ticks;
    if constexpr (KS == 1) {
      P nk, nl, ns;
      ext(f, cl, ck, cs, 3 - a, nl, nk, ns);       // the swapped interval
      take(nk, nl, ns, an);
    } else {
      int ch[2] = {3 - a, 3 - (an < 4 ? an : 3)}, bk[2], bl[2], bs[2];
      ext_k<2>(f, g, cl, ck, cs, ch, bk, bl, bs);  // the swapped interval
      if (take(bl[0], bk[0], bs[0], an)) take(bl[1], bk[1], bs[1],
                                              code(j + 1));
    }
    if (!live) live = next();                      // the read's end
  }
  steps_out[w] = steps;
  ticks_out[w] = ticks;
}

template <int KS, typename P>
int one_pos_launch_t(const Fmi<P>& f, const Kfmi& g, const void* codes,
                     const void* lens, int B, int L, const void* t_read,
                     const void* t_x, const void* t_mi, const void* t_valid,
                     const void* t_row, int N, int T, int chain_restarts,
                     int min_seed_len, int M, int R, void* stk, void* ctr,
                     void* out, void* cnt, void* steps, void* ticks,
                     void* stream) {
  if (T <= 0) return 0;
  const bool shared = stacks_in_shared<P>(L, L);
  const size_t bytes = codes_bytes(L) + (shared ? stacks_bytes<P>(L) : 0);
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || B <= 0 || L <= 0
      || N < 0 || M < 0 || R < 0 || bytes > SMEM_MAX || ctr == nullptr
      || (!shared && stk == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = shared ? readlane_one_pos_kernel<true, KS, P>
                       : readlane_one_pos_kernel<false, KS, P>;
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<T, WARP, bytes, (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, B, L,
      (const int32_t*)t_read, (const int32_t*)t_x, (const int32_t*)t_mi,
      (const uint8_t*)t_valid, (const int32_t*)t_row, N, chain_restarts,
      min_seed_len, M, R, (Ent<P>*)stk, (int*)ctr, (int32_t*)out,
      (int32_t*)cnt, (int32_t*)steps, (int32_t*)ticks);
  return (int)cudaGetLastError();
}

template <int KS, typename P>
int strategy_launch_t(const Fmi<P>& f, const Kfmi& g, const void* codes,
                      const void* lens, int B, int L, int T, int RW,
                      int max_intv, int min_seed_len, int M, void* ctr,
                      void* out, void* cnt, void* steps, void* ticks,
                      void* stream) {
  if (T <= 0) return 0;
  const size_t bytes = (size_t)RW * codes_bytes(L);
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || B < 0 || L <= 0 || M < 0
      || RW < 1 || RW > WARP || bytes > SMEM_MAX || ctr == nullptr)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(readlane_strategy_kernel<KS, P>, bytes);
  if (e != cudaSuccess) return (int)e;
  readlane_strategy_kernel<KS, P><<<(T + RW - 1) / RW, RW, bytes,
                                    (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, B, L, T, RW,
      max_intv, min_seed_len, M, (int*)ctr, (int32_t*)out, (int32_t*)cnt,
      (int32_t*)steps, (int32_t*)ticks);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when one warp's codes and stacks at depth L fit its shared memory, so
// readlane_one_pos_launch takes no scratch; 0 when the stacks go to a
// device scratch [T][2][L + 1] entries of 16 bytes.
extern "C" int readlane_stacks_in_shared(int L) {
  return stacks_in_shared<int>(L, L);
}

// The same for readlane_one_pos_launch64 (32-byte entries).
extern "C" int readlane_stacks_in_shared64(int L) {
  return stacks_in_shared<long long>(L, L);
}

// Launch readlane_one_pos_kernel on `stream`: T worker lanes (one-warp
// blocks) over N tasks; returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for arguments it cannot take. The caller
// allocates every buffer: the stack scratch `stk` [T][2][L + 1] entries of
// 16 bytes where readlane_stacks_in_shared is 0 (else null), the counter
// `ctr` (one int, zeroed before the launch), out [2][R][M] int32 then
// [3][R][M] int32 (every row a task owns is written whole), cnt [R],
// steps and ticks [T]; t_row gives each task's row (distinct rows).
// Nothing here synchronises.
extern "C" int readlane_one_pos_launch(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* codes, const void* lens, int B, int L,
    const void* t_read, const void* t_x, const void* t_mi,
    const void* t_valid, const void* t_row, int N, int T,
    int chain_restarts, int min_seed_len, int M, int R, void* stk,
    void* ctr, void* out, void* cnt, void* steps, void* ticks,
    void* stream) {
  return one_pos_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{}, codes,
      lens, B, L, t_read, t_x, t_mi, t_valid, t_row, N, T, chain_restarts,
      min_seed_len, M, R, stk, ctr, out, cnt, steps, ticks, stream);
}

// readlane_one_pos_launch's int64 form: the index at 64 bits with its
// high-word step table `hi` and steps h0-h3 a base (csrc/smem.cu's
// one_pos_launch64); stack entries of 32 bytes
// (readlane_stacks_in_shared64); out [2][R][M] int32 then [3][R][M]
// int64.
extern "C" int readlane_one_pos_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* codes,
    const void* lens, int B, int L, const void* t_read, const void* t_x,
    const void* t_mi, const void* t_valid, const void* t_row, int N, int T,
    int chain_restarts, int min_seed_len, int M, int R, void* stk,
    void* ctr, void* out, void* cnt, void* steps, void* ticks,
    void* stream) {
  return one_pos_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{}, codes, lens, B, L, t_read, t_x, t_mi, t_valid, t_row, N, T,
      chain_restarts, min_seed_len, M, R, stk, ctr, out, cnt, steps, ticks,
      stream);
}

// readlane_one_pos_launch's k-step forms (int32 layout only): the C array
// and the sentinel, then the k-gram table `cpk` ([nb][w4] int4, w4 = 10
// or 42) with its C2 [16] and C3 [64] tables (`c3k` null at ks = 2), ks =
// 2 or 3 bases a row fetch, every occ step from the k-gram rows; the rest
// as readlane_one_pos_launch.
extern "C" int readlane_one_pos_launch_k(
    int c0, int c1, int c2, int c3, int c4, int sentinel, const void* cpk,
    int nb, int w4, const void* c2k, const void* c3k, int ks,
    const void* codes, const void* lens, int B,
    int L, const void* t_read, const void* t_x, const void* t_mi,
    const void* t_valid, const void* t_row, int N, int T,
    int chain_restarts, int min_seed_len, int M, int R, void* stk,
    void* ctr, void* out, void* cnt, void* steps, void* ticks,
    void* stream) {
  const Fmi<int> f = c_only(c0, c1, c2, c3, c4, sentinel);
  const Kfmi g = make_kfmi(cpk, nb, w4, c2k, c3k);
  if (ks == 2)
    return one_pos_launch_t<2>(f, g, codes, lens, B, L, t_read, t_x, t_mi,
                               t_valid, t_row, N, T, chain_restarts,
                               min_seed_len, M, R, stk, ctr, out, cnt, steps,
                               ticks, stream);
  if (ks == 3)
    return one_pos_launch_t<3>(f, g, codes, lens, B, L, t_read, t_x, t_mi,
                               t_valid, t_row, N, T, chain_restarts,
                               min_seed_len, M, R, stk, ctr, out, cnt, steps,
                               ticks, stream);
  return (int)cudaErrorInvalidValue;
}

// Launch readlane_strategy_kernel on `stream`: T worker lanes, rw a
// one-warp block (1-32, rw slots of L codes within 227 KB), over B reads,
// read b emitting into row b of out [2][B][M] int32 then [3][B][M] int32;
// `ctr` one int zeroed before the launch; the return and the caller's
// duties as readlane_one_pos_launch.
extern "C" int readlane_strategy_launch(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* codes, const void* lens, int B, int L, int T,
    int rw, int max_intv, int min_seed_len, int M, void* ctr, void* out,
    void* cnt, void* steps, void* ticks, void* stream) {
  return strategy_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{}, codes,
      lens, B, L, T, rw, max_intv, min_seed_len, M, ctr, out, cnt, steps,
      ticks, stream);
}

// readlane_strategy_launch's int64 form (the index as
// readlane_one_pos_launch64's; out [2][B][M] int32 then [3][B][M] int64).
extern "C" int readlane_strategy_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* codes,
    const void* lens, int B, int L, int T, int rw, int max_intv,
    int min_seed_len, int M, void* ctr, void* out, void* cnt, void* steps,
    void* ticks, void* stream) {
  return strategy_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{}, codes, lens, B, L, T, rw, max_intv, min_seed_len, M, ctr, out,
      cnt, steps, ticks, stream);
}

// readlane_strategy_launch's k-step form (int32 layout only), the index as
// readlane_one_pos_launch_k's (checked against ks): two bases a row fetch
// from the k-gram table (a trigram table's bigram groups), no 1-step rows.
extern "C" int readlane_strategy_launch_k(
    int c0, int c1, int c2, int c3, int c4, int sentinel, const void* cpk,
    int nb, int w4, const void* c2k, const void* c3k, int ks,
    const void* codes, const void* lens, int B, int L, int T, int rw,
    int max_intv, int min_seed_len, int M, void* ctr, void* out, void* cnt,
    void* steps, void* ticks, void* stream) {
  const Kfmi g = make_kfmi(cpk, nb, w4, c2k, c3k);
  if (!kfmi_ok(g, ks)) return (int)cudaErrorInvalidValue;
  return strategy_launch_t<2>(
      c_only(c0, c1, c2, c3, c4, sentinel), g, codes, lens, B, L, T, rw,
      max_intv, min_seed_len, M, ctr, out, cnt, steps, ticks, stream);
}
