// The FM-index walks of the seeding and SA-lookup stages for Hopper
// (sm_90a), each walk whole in one launch with no host synchronisation
// inside. Three kernels live in this source and take the checkpoint-occ
// step (`Fmi`, `occ4`, `ext`) from csrc/fmi_step.cuh, which the sweep's
// kernels (csrc/sweep.cu) include too:
// - one_pos_kernel: SMEM passes 1 and 2 (getSMEMsOnePosOneThread), one
//   warp a task;
// - seed_strategy_kernel: SMEM pass 3 (bwtSeedStrategyAllPosOneThread),
//   one thread a read;
// - sa_walk_kernel: the SA lookup's LF walk (get_sa_entry_compressed),
//   one thread a coordinate (the walk itself is csrc/sal_walk.cuh's).
// Each replaces a jax.lax.while_loop the TPU runs as one program, through
// the port's lockstep counterpart in ops/ (tens to hundreds of small
// PyTorch launches a tick and a host synchronisation every 4-8 ticks).
// Every output array equals the lockstep's, lanes the lockstep steps with
// junk included: every read of a code clamps its column to [0, L - 1],
// and every checkpoint row index to [0, nb - 1], as the lockstep's
// gathers do.
//
// What bounds them on this card: a chain of dependent loads, not bytes.
// Each occ step's checkpoint rows depend on the previous step's interval:
// on an NVIDIA H100 80GB HBM3 at 700 W (every time in this note), 0.224
// us a dependent row load on the 4.6 Mbp table, held in L2 (probe B,
// PERF.md section 6). The bytes a batch moves (64 a step) take a few
// microseconds at 3.35 TB/s; the longest task's chain of round trips
// takes tens to hundreds. So the designs keep every other load off that
// chain (the read's codes and the interval stacks live in shared
// memory), and run side by side the occ steps that do not wait on each
// other (a backward round's entries). Each step's base is read a step
// ahead, so no branch on it waits. Each task reports its `steps` (the ext
// calls: the work, which the bound in chip_smoke.py counts) and, for
// passes 1-2, its `rounds` (the dependent occ round trips on its path:
// the latency floor is the longest task's rounds x 0.224 us). An occ step
// waits on two rows, the later of two L2 trips, so it takes more than
// probe B's one-row tick; on the 4.6 Mbp batch the kernels take 0.3-0.4
// us a round (PERF.md section 6). Each kernel zeroes its own outputs past
// a task's count, so the wrapper launches nothing else.
//
// The occ step is csrc/fmi_step.cuh's (its note): two 32-byte checkpoint
// rows, __popc under the top-y-bits mask, the sentinel correction.
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
// - a task whose stack count ever exceeded SD returns cnt = max_out + 1,
//   and keeps walking to its end as the lockstep does.
// Design: one warp a task (a 32-thread block), so a 512-read pass 1 runs
// 512 warps over the 132 SMs and pass 2's 1,024 tasks 1,024. The warp
// stages the read's codes into shared memory once (16-byte loads, as
// bytes), and both interval stacks live in its dynamic shared memory,
// [2 buffers][SD + 1] entries of int4 (k, l, s, n): 800 B at SD = 24,
// 3,264 B at SD = 101. The forward walk is a chain of dependent
// intervals, so it stays serial: every lane runs it (the loads are one
// broadcast), and lane 0 pushes. A backward round is one round trip:
// lane p takes entry p of the round (cA - 1 - p in the first round, which
// reads the stack from its top, p after that), 32 entries a chunk, and
// all run their ext at once. The serial keep/emit rule then reduces to
// one broadcast, one __shfl_up_sync and one ballot, because along p the
// new sizes ns never decrease and the entries' ends pn never increase:
// the stack holds nested intervals (a longer match has the smaller SA
// interval, and the same base extends nested intervals into nested
// ones), the first round reads the smallest first, a later round reads
// the B stack in the order it was written, and a clamped read past slot
// SD - 1 repeats that slot, which keeps the order. So the entries that
// die (ns < mi) come first, and
// - the round emits at most once, from entry p = 0, when it dies and
//   pn - mA + 1 >= min_seed_len (a later dying entry has a smaller pn);
// - entry p is kept iff ns_p >= mi and ns_p != cur, where cur, the
//   serial rule's curr_s, is -1 for p = 0 or after a dying entry, and
//   ns_(p-1) otherwise (the survivors are consecutive, and each either
//   was kept or equals the last kept);
// - the kept entries go to the other buffer in p order, entry p at slot
//   min(cB + popc(ballot & lanes below), SD);
// - ns of a chunk's last lane carries to the next chunk's lane 0.
// ops/smem_cuda.py::one_pos_twin runs this form and asserts both orders
// on every test case. Where one warp's codes and stacks pass 227 KB (SD
// above ~7,000, reachable only with a large -W), the stacks live in a
// device scratch [T][2][SD + 1] int4 that the wrapper allocates: the
// same kernel, its STACKS_IN_SHARED template argument false, chosen by
// shape (one_pos_stacks_in_shared). The earlier design ran one thread
// a task, 32-thread blocks on 16 SMs, the stacks [2][4][SD + 1][T] in
// device memory and each code a global load: pass 1 0.3581 ms, pass 2
// 0.0553 ms on the 4.6 Mbp batch (PERF.md section 6). The task's walk is
// csrc/one_pos_task.cuh's one_pos_task, which the readlane engine's
// readlane_one_pos_kernel (csrc/readlane.cu) runs too.
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
// max_out + 1 latch). A warp per read would not cut the floor: a walk ends
// where the next one starts, so a read's walks are one chain of ~L - 1
// dependent steps. Design: the block's reads' codes are staged into
// shared memory in one coalesced copy (bytes: 8 x 101 = 808 B), and the
// start loop and the walk are one flat loop of exactly one ext an
// iteration; the restart at a hit or an N (`seek`) is a state update
// over shared memory inside the iteration, so a warp takes its longest
// lane's steps, with no reconvergence at each start. One warp a block,
// 8 reads a warp (P3_READS): a 512-read batch runs 64 warps on 64 SMs.
// The longest lane sets the kernel's time, so idle lanes cost nothing,
// while each step's loads go to as many rows as the warp has reads, and
// the L1 serves a load's distinct rows one after another: 4, 8, 16 and
// 32 reads a block measured 0.0315, 0.0320, 0.0327 and 0.0358 ms on the
// 4.6 Mbp batch (PERF.md section 6), and 8 keeps twice 4's lanes busy at
// larger batches. Reads longer than 29,056 bases take fewer reads a
// block (227 KB of codes). The earlier design loaded each code from
// device memory ahead of its step and nested the walk in the start loop:
// 0.0504 ms on the 4.6 Mbp batch.
//
// ---- sa_walk_kernel (SA lookup)
// Replaces bwa_mem_scale_tpu/ops/sal.py:23 sa_lookup (its LF-walk loops)
// through ops/sal.py::sa_lookup_plain. One thread a coordinate walks from
// its BWT row (csrc/sal_walk.cuh's sa_walk, which csrc/sal.cu's fused SA
// lookup stage shares); an invalid lane returns 0. The walk is geometric
// (a row is sampled with p = 2^-compx), so the longest of 16k lanes walks
// ~60 rows while the mean walks ~8: 128-thread blocks over the SMs, each
// thread retiring as it finds its sample. This bare walk stays behind
// sa_lookup; the main path's expand_and_lookup runs csrc/sal.cu instead.
//
// ---- the k-step forms (KS = 2, 3; int32 layout only)
// Replace the JAX machines' `use2` branches (bwa_mem_scale_tpu/ops/
// smem_oh.py:200-203, :262-306, :328-377 in one_pos_machine_oh; :664-692
// in seed_strategy_machine_oh) through the same plain versions. With a
// k-gram checkpoint table (index/kstep.py; csrc/fmi_step.cuh ext_kt) one
// pair of row fetches takes KS bases. A k-step launch reads that table
// alone: every occ step, forward or backward, reads a 32-byte group of a
// k-gram row (group 0 for a 1-step, the first base's bigram group, the
// pair's trigram group), and the index it takes is the C array and the
// sentinel (c_only): no cp_fused row shares the L2 with the k-gram rows.
// - one_pos_k_kernel<.., KS>: the forward walk takes KS bases a
//   fetch, the groups of both ends loaded side by side, then the steps
//   one after another as the 1-step walk's (a push where the size
//   changes, nx, the last interval), stopping where it stops when the
//   walk ends mid-stride. A backward round whose entries fit one chunk
//   (cA <= 32, and no stack overflowed: cA <= SD) takes KS rounds a
//   fetch: lane p extends entry p by the bases at j, j - 1, ... from one
//   k-gram row an end (every group loaded: a load that waited on where
//   the read's start or an N cuts the round would wait on the codes),
//   and the ballot keep/emit rule above runs KS times in registers, each
//   sub-round over the lanes the one before kept, in lane order: the
//   entry before a lane is the kept lane below it (31 - clz of the mask below, its size by a
//   shuffle), the first kept lane alone can emit (its emission goes to
//   lane 0 by shuffles), and only the last sub-round's kept entries are
//   pushed. The two orders hold at each sub-round, because the same base
//   extends nested intervals into nested ones; ops/smem_cuda.py's twin
//   asserts them there. Where cA > 32 or the stack overflowed the round
//   keeps the chunked 1-step form, on group 0; the two are chosen by
//   shape, warp-uniform, and neither is a fallback on failure. C2 and C3
//   sit in the warp's registers (warp_c), a step's C value one shuffle
//   off the chain of fetches.
// - seed_strategy_kernel<2, int>: pass 3, a thread a read, two bases a
//   row fetch, the second only where the first neither hits nor ends the
//   walk, on a trigram table from its bigram groups; the k-gram table
//   alone. Three bases a fetch on a trigram table took 35 rounds for the
//   longest read against 50 and was slower, 0.02963 ms against 0.02546
//   on phase 5's batch, in turns (a dependent load over that table's
//   footprint costs 0.3443 us against 0.2284 over the bigram table's).
//   A read spread over a group of 4 or 8 lanes (the round's 16-byte
//   pieces round the group, the shares of the occ added by shuffles)
//   issued a quarter or an eighth of the load instructions and was
//   slower too: 0.03089 and 0.03012 ms against 0.02531 at K = 2 (0.03461
//   with the groups' own shuffle masks, for which ptxas tests the warp's
//   convergence before each shuffle; a thread a read in that kernel, its
//   loads predicated on the bases left before a hit, 0.03815). PERF.md
//   section 6.
// Steps count single bases, the same at every KS; rounds count row
// fetches. What bounds them is the chain of dependent fetches, which
// they shorten; a fetch waits on K groups an end instead of one row, on
// a table of 160 (K = 2) or 672 (K = 3) bytes a row of 32 positions
// (PERF.md section 6).
//
// ---- the int64 forms
// Each kernel is a template on its position type P: int for an index of
// fewer than 2^31 positions (the code described above, unchanged), long
// long for the int64 layout of ops/occ.py (hg38's 6.2e9 fw+rc positions,
// or forced on a small index); the launch functions ending in 64 launch
// them. They replace the same JAX loops at pos_dtype int64. In the int64
// forms the intervals (k, l, s), the C array and the sentinel row, the
// stack entries' k, l and s (32-byte entries: 6.5 KB of stacks a warp at
// SD = L = 101, 9.7 KB at 151), the SA samples, coordinates and values,
// and the emitted k, l and s are 64-bit; m, n and every count stay int.
// A checkpoint row stays 32 bytes, one sector a dependent step: it holds
// the low 32 bits of each count, and the high word, a step function of
// the row since counts never fall along the BWT, is the number of the
// base's steps at or before the row in a device table ([4][HI_STEPS] long
// long, ops/occ.py::hi_steps) whose per-base lengths are launch
// arguments. At hg38 no base count reaches 2^32 (A+T over fw+rc is
// ~1.8e9), every length is 0, and a step loads what the int32 form's
// does. An occ step issues both rows' loads before it decodes either,
// and one uniform test of the lengths guards the table's loops: with a
// loop a base between the loads, the first form took 1.95-2.09x the int32
// form's time on the 4.6 Mbp batch, 1.77-1.88x with the loads first, and
// 1.34-1.59x with the guard (the rest is the 64-bit arithmetic of a
// dependent step; PERF.md section 6). The row index is clamped at 64 bits
// before it narrows (pp >> 5 passes int32 once pp passes 2^36). An SA sample is 8 bytes, one load at
// the walk's end (the JAX package's 5-byte samples would be two loads at
// two addresses; 8 bytes cost hg38 6.2 GB of samples against 3.9 GB, and
// the index still fits the card's 80 GB with ~60 GB to spare). Outputs
// [5][T][M] become m and n [2][T][M] int, then k, l and s [3][T][M] long
// long, in one buffer.

#include "fmi_step.cuh"
#include "one_pos_task.cuh"
#include "sal_walk.cuh"

namespace {

// one_pos_kernel's body: task blockIdx.x by the block's one warp
template <bool STACKS_IN_SHARED, int KS, typename P>
__device__ __forceinline__ void one_pos_block(
    const Fmi<P>& f, const Kfmi& g, const int32_t* __restrict__ codes,
    const int32_t* __restrict__ lens, int B, int L,
    const int32_t* __restrict__ t_read, const int32_t* __restrict__ t_x,
    const int32_t* __restrict__ t_mi, const uint8_t* __restrict__ t_valid,
    int T, int chain_restarts, int min_seed_len, int M, int SD,
    Ent<P>* __restrict__ scratch, int32_t* __restrict__ out,
    int32_t* __restrict__ cnt_out, int32_t* __restrict__ steps_out,
    int32_t* __restrict__ rounds_out) {
  extern __shared__ int4 smem[];
  const int t = blockIdx.x;                        // one warp a task
  const int lane = threadIdx.x;
  int rd = t_read[t];
  rd = rd < 0 ? 0 : (rd >= B ? B - 1 : rd);
  const int len = t_valid[t] ? lens[rd] : 0;
  const int mi = t_mi[t];
  const SmemRows<P> rows{out, (size_t)T * M, M};
  // the shared memory: [2][SD + 1] stack entries, then the codes
  Ent<P>* stk = STACKS_IN_SHARED ? reinterpret_cast<Ent<P>*>(smem)
                                 : scratch + (size_t)t * 2 * (SD + 1);
  int8_t* q = STACKS_IN_SHARED
                  ? reinterpret_cast<int8_t*>(stk + 2 * (SD + 1))
                  : reinterpret_cast<int8_t*>(smem);
  rows.zero(t, lane);                              // the output row
  if (len > 0) stage_codes(codes + (size_t)rd * L, L, q, lane, WARP);
  const WarpC wc = KS > 1 ? warp_c(g, lane) : WarpC{0, 0, 0};
  __syncwarp();              // the codes, and the zeros before any emission
  const TaskCounts c = one_pos_task<KS, P>(
      f, g, wc, q, L, len, t_x[t], mi, chain_restarts, min_seed_len, SD,
      stk, rows, t, lane);
  if (lane == 0) {
    cnt_out[t] = c.of ? M + 1 : c.cnt;
    steps_out[t] = c.steps;
    rounds_out[t] = c.rounds;
  }
}

// passes 1-2, the 1-step forms
template <bool STACKS_IN_SHARED, typename P>
__global__ void __launch_bounds__(WARP)
one_pos_kernel(Fmi<P> f, Kfmi g, const int32_t* __restrict__ codes,  // [B, L]
               const int32_t* __restrict__ lens,           // [B]
               int B, int L,
               const int32_t* __restrict__ t_read,         // [T]
               const int32_t* __restrict__ t_x,            // [T]
               const int32_t* __restrict__ t_mi,           // [T]
               const uint8_t* __restrict__ t_valid,        // [T]
               int T, int chain_restarts, int min_seed_len, int M, int SD,
               Ent<P>* __restrict__ scratch,    // [T][2][SD + 1] or null
               int32_t* __restrict__ out,       // [2][T][M] m n, then
                                                // [3][T][M] P: k l s
               int32_t* __restrict__ cnt_out,   // [T]
               int32_t* __restrict__ steps_out,    // [T]
               int32_t* __restrict__ rounds_out) {  // [T]
  one_pos_block<STACKS_IN_SHARED, 1, P>(
      f, g, codes, lens, B, L, t_read, t_x, t_mi, t_valid, T,
      chain_restarts, min_seed_len, M, SD, scratch, out, cnt_out, steps_out,
      rounds_out);
}

// the k-step forms, the same arguments at P = int: one block an SM at
// least (as readlane_one_pos_kernel), so that ptxas gives the state of
// KS sub-rounds the registers it needs rather than the ~64 it gives a
// one-warp kernel by default
template <bool STACKS_IN_SHARED, int KS>
__global__ void __launch_bounds__(WARP, 1)
one_pos_k_kernel(Fmi<int> f, Kfmi g, const int32_t* __restrict__ codes,
                 const int32_t* __restrict__ lens, int B, int L,
                 const int32_t* __restrict__ t_read,
                 const int32_t* __restrict__ t_x,
                 const int32_t* __restrict__ t_mi,
                 const uint8_t* __restrict__ t_valid, int T,
                 int chain_restarts, int min_seed_len, int M, int SD,
                 Ent<int>* __restrict__ scratch, int32_t* __restrict__ out,
                 int32_t* __restrict__ cnt_out,
                 int32_t* __restrict__ steps_out,
                 int32_t* __restrict__ rounds_out) {
  one_pos_block<STACKS_IN_SHARED, KS, int>(
      f, g, codes, lens, B, L, t_read, t_x, t_mi, t_valid, T,
      chain_restarts, min_seed_len, M, SD, scratch, out, cnt_out, steps_out,
      rounds_out);
}


constexpr int P3_THREADS = 32;       // one warp a block, a read a lane

template <int KS, typename P>
__global__ void __launch_bounds__(P3_THREADS)
seed_strategy_kernel(Fmi<P> f, Kfmi g,
                     const int32_t* __restrict__ codes,         // [B, L]
                     const int32_t* __restrict__ lens,          // [B]
                     int B, int L, int R,       // R reads a block, <= 32
                     int max_intv, int min_seed_len, int M,
                     int32_t* __restrict__ out,     // [2][B][M] m n, then
                                                    // [3][B][M] P: k l s
                     int32_t* __restrict__ cnt_out,     // [B]
                     int32_t* __restrict__ steps_out,   // [B]
                     int32_t* __restrict__ rounds_out) {  // [B] (KS > 1)
  extern __shared__ int4 smem[];
  int8_t* sq = reinterpret_cast<int8_t*>(smem);   // [R][L] codes
  const int t0 = blockIdx.x * R;
  const int nr = min(R, B - t0);
  const size_t tm = (size_t)B * M;                 // one output field
  P* kls = reinterpret_cast<P*>(out + 2 * tm);
  for (int fld = 0; fld < 5; ++fld)                // the block's output rows
    for (int i = threadIdx.x; i < nr * M; i += P3_THREADS) {
      if constexpr (sizeof(P) == 4) {
        out[fld * tm + (size_t)t0 * M + i] = 0;
      } else {
        const size_t o = (size_t)t0 * M + i;
        if (fld < 2) out[fld * tm + o] = 0;
        else kls[(fld - 2) * tm + o] = 0;
      }
    }
  stage_codes(codes + (size_t)t0 * L, nr * L, sq, threadIdx.x, P3_THREADS);
  __syncthreads();           // the codes, and the zeros before any emission
  if ((int)threadIdx.x >= nr) return;
  const int t = t0 + threadIdx.x;
  const int8_t* q = sq + (size_t)threadIdx.x * L;
  const int len = lens[t];
  auto code = [&](int i) { return q[i < 0 ? 0 : (i >= L ? L - 1 : i)]; };
  int cnt = 0, steps = 0, x = 0, j = 0, a = 4;
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
  bool live = seek(0);
  // one base of the walk, its extension (nk, nl, ns) made and the next
  // base an read: at a hit emit when s > 0 and seek on after it; at the
  // read's end or an N stop or seek; true while the walk goes on
  auto take = [&](P nk, P nl, P ns, int an) {
    ++steps;
    if (ns < max_intv && j + 1 - x >= min_seed_len) {
      if (ns > 0) {
        if (cnt < M) {
          const size_t o = (size_t)t * M + cnt;
          out[o] = x;
          out[tm + o] = j;
          kls[o] = nk;
          kls[tm + o] = nl;
          kls[2 * tm + o] = ns;
        }
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
  int rounds = 0;
  while (live) {                  // one row fetch (KS bases) an iteration
    const int an = code(j + 1);                    // read a step ahead
    ++rounds;
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
  }
  if constexpr (KS > 1) rounds_out[t] = rounds;
  cnt_out[t] = cnt;
  steps_out[t] = steps;
}

// reads a pass-3 block takes by default: P3_READS, fewer where their
// codes pass 227 KB
constexpr int P3_READS = 8;
int p3_reads(int L) {
  const size_t r = SMEM_MAX / codes_bytes(L);
  return r >= P3_READS ? P3_READS : (int)r;
}


constexpr int SAL_BLOCK = 128;       // coordinates (threads) a block

template <typename P>
__global__ void __launch_bounds__(SAL_BLOCK)
sa_walk_kernel(Fmi<P> f, const P* __restrict__ samples, P n_samples,
               int compx, const P* __restrict__ pos,          // [N]
               const uint8_t* __restrict__ valid,             // [N]
               int N, P* __restrict__ out,                    // [N]
               int32_t* __restrict__ steps_out) {             // [N]
  const int t = blockIdx.x * SAL_BLOCK + threadIdx.x;
  if (t >= N) return;
  P res = 0;
  int steps = 0;
  if (valid[t]) res = sa_walk(f, samples, n_samples, compx, pos[t], steps);
  out[t] = res;
  steps_out[t] = steps;
}

template <int KS, typename P>
int one_pos_launch_t(const Fmi<P>& f, const Kfmi& g, const void* codes,
                     const void* lens, int B, int L, const void* t_read,
                     const void* t_x, const void* t_mi, const void* t_valid,
                     int T, int chain_restarts, int min_seed_len, int M,
                     int SD, void* stk, void* out, void* cnt, void* steps,
                     void* rounds, void* stream) {
  if (T <= 0) return 0;
  const bool shared = stacks_in_shared<P>(L, SD);
  const size_t bytes = codes_bytes(L) + (shared ? stacks_bytes<P>(SD) : 0);
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || B <= 0 || L <= 0
      || M < 0 || SD <= 0 || bytes > SMEM_MAX || (!shared && stk == nullptr))
    return (int)cudaErrorInvalidValue;
  auto kernel = [&] {
    if constexpr (KS > 1)
      return shared ? one_pos_k_kernel<true, KS> : one_pos_k_kernel<false, KS>;
    else
      return shared ? one_pos_kernel<true, P> : one_pos_kernel<false, P>;
  }();
  const cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return (int)e;
  kernel<<<T, WARP, bytes, (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, B, L,
      (const int32_t*)t_read, (const int32_t*)t_x, (const int32_t*)t_mi,
      (const uint8_t*)t_valid, T, chain_restarts, min_seed_len, M, SD,
      (Ent<P>*)stk, (int32_t*)out, (int32_t*)cnt, (int32_t*)steps,
      (int32_t*)rounds);
  return (int)cudaGetLastError();
}

template <int KS, typename P>
int seed_strategy_launch_t(const Fmi<P>& f, const Kfmi& g, const void* codes,
                           const void* lens, int B, int L, int max_intv,
                           int min_seed_len, int M, int reads_per_block,
                           void* out, void* cnt, void* steps, void* rounds,
                           void* stream) {
  if (B <= 0) return 0;
  const int R = reads_per_block > 0 ? reads_per_block : p3_reads(L);
  if (!fmi_ok(f) || (KS > 1 && (!kfmi_ok(g, KS) || rounds == nullptr))
      || L <= 0 || M < 0 || R < 1 || R > P3_THREADS
      || R * codes_bytes(L) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = R * codes_bytes(L);
  const cudaError_t e = allow_smem(seed_strategy_kernel<KS, P>, bytes);
  if (e != cudaSuccess) return (int)e;
  seed_strategy_kernel<KS, P><<<(B + R - 1) / R, P3_THREADS, bytes,
                                (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, B, L, R, max_intv,
      min_seed_len, M, (int32_t*)out, (int32_t*)cnt, (int32_t*)steps,
      (int32_t*)rounds);
  return (int)cudaGetLastError();
}

template <typename P>
int sa_walk_launch_t(const Fmi<P>& f, const void* samples, P n_samples,
                     int compx, const void* pos, const void* valid, int N,
                     void* out, void* steps, void* stream) {
  if (N <= 0) return 0;
  if (!fmi_ok(f) || n_samples <= 0 || compx < 1 || compx > 30)
    return (int)cudaErrorInvalidValue;
  sa_walk_kernel<P><<<(N + SAL_BLOCK - 1) / SAL_BLOCK, SAL_BLOCK, 0,
                      (cudaStream_t)stream>>>(
      f, (const P*)samples, n_samples, compx, (const P*)pos,
      (const uint8_t*)valid, N, (P*)out, (int32_t*)steps);
  return (int)cudaGetLastError();
}

}  // namespace

// 1 when one warp's codes (L) and interval stacks (SD) fit its shared
// memory, so one_pos_launch takes no scratch; 0 when the stacks go to a
// device scratch [T][2][SD + 1] int4 (the codes stay in shared memory).
extern "C" int one_pos_stacks_in_shared(int L, int SD) {
  return stacks_in_shared<int>(L, SD);
}

// The same for one_pos_launch64 (32-byte entries).
extern "C" int one_pos_stacks_in_shared64(int L, int SD) {
  return stacks_in_shared<long long>(L, SD);
}

// Launch one_pos_kernel on `stream` over T tasks, a one-warp block each;
// returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for a shape it cannot take. The caller allocates
// every buffer (the stack scratch [T][2][SD + 1] int4 where
// one_pos_stacks_in_shared is 0, else null; the kernel writes every
// output slot) and checks shapes and types; nothing here synchronises.
extern "C" int one_pos_launch(const void* cp_fused, int nb, int c0, int c1,
                              int c2, int c3, int c4, int sentinel,
                              const void* codes, const void* lens, int B,
                              int L, const void* t_read, const void* t_x,
                              const void* t_mi, const void* t_valid, int T,
                              int chain_restarts, int min_seed_len, int M,
                              int SD, void* stk, void* out, void* cnt,
                              void* steps, void* rounds, void* stream) {
  return one_pos_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{}, codes,
      lens, B, L, t_read, t_x, t_mi, t_valid, T, chain_restarts,
      min_seed_len, M, SD, stk, out, cnt, steps, rounds, stream);
}

// one_pos_launch's int64 form: the index at 64 bits with its high-word
// step table `hi` ([4][HI_STEPS] long long on the device) and steps
// h0-h3 a base; the stack scratch (one_pos_stacks_in_shared64 0)
// [T][2][SD + 1] entries of 32 bytes; out [2][T][M] int32 then
// [3][T][M] int64.
extern "C" int one_pos_launch64(const void* cp_fused, long long nb,
                                long long c0, long long c1, long long c2,
                                long long c3, long long c4,
                                long long sentinel, const void* hi, int h0,
                                int h1, int h2, int h3, const void* codes,
                                const void* lens, int B, int L,
                                const void* t_read, const void* t_x,
                                const void* t_mi, const void* t_valid, int T,
                                int chain_restarts, int min_seed_len, int M,
                                int SD, void* stk, void* out, void* cnt,
                                void* steps, void* rounds, void* stream) {
  return one_pos_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{}, codes, lens, B, L, t_read, t_x, t_mi, t_valid, T,
      chain_restarts, min_seed_len, M, SD, stk, out, cnt, steps, rounds,
      stream);
}

// Launch seed_strategy_kernel on `stream` over B reads, `reads_per_block`
// a block (0: p3_reads(L)); the return and the caller's duties as
// one_pos_launch.
extern "C" int seed_strategy_launch(const void* cp_fused, int nb, int c0,
                                    int c1, int c2, int c3, int c4,
                                    int sentinel, const void* codes,
                                    const void* lens, int B, int L,
                                    int max_intv, int min_seed_len, int M,
                                    int reads_per_block, void* out,
                                    void* cnt, void* steps, void* stream) {
  return seed_strategy_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{}, codes,
      lens, B, L, max_intv, min_seed_len, M, reads_per_block, out, cnt,
      steps, nullptr, stream);
}

// seed_strategy_launch's int64 form (the index as one_pos_launch64's;
// out [2][B][M] int32 then [3][B][M] int64).
extern "C" int seed_strategy_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* codes,
    const void* lens, int B, int L, int max_intv, int min_seed_len, int M,
    int reads_per_block, void* out, void* cnt, void* steps, void* stream) {
  return seed_strategy_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{}, codes, lens, B, L, max_intv, min_seed_len, M, reads_per_block,
      out, cnt, steps, nullptr, stream);
}

// one_pos_launch's k-step forms (int32 layout only): the C array and the
// sentinel, then the k-gram table `cpk` ([nb][w4] int4 in
// ops/occ.py::kstep_rows' layout, w4 = 10 or 42) with its C2 [16] and C3
// [64] tables on the device (`c3k` null at ks = 2), ks = 2 or 3 bases a
// row fetch; the rest as one_pos_launch. No 1-step table: every occ step
// reads the k-gram rows.
extern "C" int one_pos_launch_k(int c0, int c1, int c2, int c3, int c4,
                                int sentinel, const void* cpk, int nb,
                                int w4, const void* c2k, const void* c3k,
                                int ks, const void* codes, const void* lens,
                                int B, int L, const void* t_read,
                                const void* t_x, const void* t_mi,
                                const void* t_valid, int T,
                                int chain_restarts, int min_seed_len, int M,
                                int SD, void* stk, void* out, void* cnt,
                                void* steps, void* rounds, void* stream) {
  const Fmi<int> f = c_only(c0, c1, c2, c3, c4, sentinel);
  const Kfmi g = make_kfmi(cpk, nb, w4, c2k, c3k);
  if (ks == 2)
    return one_pos_launch_t<2>(f, g, codes, lens, B, L, t_read, t_x, t_mi,
                               t_valid, T, chain_restarts, min_seed_len, M,
                               SD, stk, out, cnt, steps, rounds, stream);
  if (ks == 3)
    return one_pos_launch_t<3>(f, g, codes, lens, B, L, t_read, t_x, t_mi,
                               t_valid, T, chain_restarts, min_seed_len, M,
                               SD, stk, out, cnt, steps, rounds, stream);
  return (int)cudaErrorInvalidValue;
}

// seed_strategy_launch's k-step form (int32 layout only), the table as
// one_pos_launch_k's (checked against ks): two bases a row fetch from
// either table's bigram groups; `rounds` [B] gets each read's row fetches.
extern "C" int seed_strategy_launch_k(
    int c0, int c1, int c2, int c3, int c4, int sentinel, const void* cpk,
    int nb, int w4, const void* c2k, const void* c3k, int ks,
    const void* codes, const void* lens, int B, int L, int max_intv,
    int min_seed_len, int M, int reads_per_block, void* out, void* cnt,
    void* steps, void* rounds, void* stream) {
  const Kfmi g = make_kfmi(cpk, nb, w4, c2k, c3k);
  if (!kfmi_ok(g, ks)) return (int)cudaErrorInvalidValue;
  return seed_strategy_launch_t<2>(
      c_only(c0, c1, c2, c3, c4, sentinel), g, codes, lens, B, L, max_intv,
      min_seed_len, M, reads_per_block, out, cnt, steps, rounds, stream);
}

// Launch sa_walk_kernel on `stream` over N coordinates (1 <= compx <= 30;
// the wrapper keeps compx = 0, the full SA, as one gather); the return
// and the caller's duties as one_pos_launch.
extern "C" int sa_walk_launch(const void* cp_fused, int nb, int c0, int c1,
                              int c2, int c3, int c4, int sentinel,
                              const void* samples, int n_samples, int compx,
                              const void* pos, const void* valid, int N,
                              void* out, void* steps, void* stream) {
  return sa_walk_launch_t(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), samples,
      n_samples, compx, pos, valid, N, out, steps, stream);
}

// sa_walk_launch's int64 form: int64 samples, coordinates and values.
extern "C" int sa_walk_launch64(const void* cp_fused, long long nb,
                                long long c0, long long c1, long long c2,
                                long long c3, long long c4,
                                long long sentinel, const void* hi, int h0,
                                int h1, int h2, int h3, const void* samples,
                                long long n_samples, int compx,
                                const void* pos, const void* valid, int N,
                                void* out, void* steps, void* stream) {
  return sa_walk_launch_t(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      samples, n_samples, compx, pos, valid, N, out, steps, stream);
}
