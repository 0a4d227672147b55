// The readlane seeding engine for Hopper (sm_90a): the read-per-lane SMEM
// machines of bwa_mem_scale_tpu/ops/smem_rl.py, one thread a worker lane,
// each walk whole in one launch with no host synchronisation inside.
// - readlane_one_pos_kernel<KS, P>: SMEM passes 1 and 2
//   (getSMEMsOnePosOneThread, src/FMI_search.cpp:1372-1660). Replaces
//   bwa_mem_scale_tpu/ops/smem_rl.py:55 one_pos_machine (its
//   jax.lax.while_loop at :596) through ops/smem_rl.py::one_pos_machine.
// - readlane_strategy_kernel<KS, P>: SMEM pass 3
//   (bwtSeedStrategyAllPosOneThread, src/FMI_search.cpp:1662-1730).
//   Replaces bwa_mem_scale_tpu/ops/smem_rl.py:603 seed_strategy_machine
//   (its loop at :764) through ops/smem_rl.py::seed_strategy_machine.
// Every output array equals the lockstep machine's, for any pull order:
// a task's emissions land in its own output row (out_rows[task] for
// passes 1-2, the read for pass 3), so which lane runs it, and when, does
// not show.
//
// The worker-lane pool. The JAX machines run `lanes` lanes over a backlog
// of tasks (passes 1-2: (read, x, min_intv); pass 3: reads): a lane that
// finishes its task pulls the next unassigned one, kt_for's dynamic
// scheduling (src/kthread.cpp:41-77). Here a lane is a thread: the wrapper
// launches `lanes` threads (one a task when lanes is None), and a lane
// pulls its next task with atomicAdd on a counter the wrapper zeroes. The
// order of the pulls is not deterministic on the card; the outputs do not
// depend on it. Each lane's two interval stacks live in a device scratch
// sized by lanes, not tasks: [lanes][2][L + 1] entries (16 bytes, 32 in
// the int64 form), at the full depth L that no walk can overflow (slot L
// takes a push past it, as the lockstep's dropped scatter), so a 64-lane
// pool of 101 bp reads holds 208 KB of stacks whatever the backlog. A
// lane's stacks carry from task to task; a walk reads only the slots it
// wrote.
//
// The tick. Each iteration of a lane's loop is one tick of the JAX
// machine: INIT (the 1-base interval, no extension), FWD (the forward walk
// from x), BSCAN (a backward round's scan, its first-hit break) and BTAIL
// (the round's distinct-s tail), with the reference's double push of the
// failing forward interval and next_x = j on an interval failure. The
// four phases diverge inside a warp. The loop keeps the TPU tick's shape:
// every lane that extends makes exactly one occ step an iteration, from
// one call site: a FWD lane on its swapped (l, k) interval, a BSCAN or
// BTAIL lane on its stack entry (the JAX machine's _ext_all4,
// bwa_mem_scale_tpu/ops/smem_rl.py:47-52). Only the transitions branch,
// so a warp never issues two dependent row fetches in one iteration for
// two phases.
//
// What bounds it on this card: each lane's chain of dependent L2 row
// trips. An occ step's two checkpoint rows depend on the interval the
// step before made (0.224 us a dependent row load on the 4.6 Mbp table,
// held in L2, on an NVIDIA H100 80GB HBM3 at 700 W: probe B, PERF.md
// section 6), and a backward tick first loads its stack entry from the
// scratch. One thread walks a task's steps one after another, its
// backward rounds' entries included, which the warp form of passes 1-2
// (csrc/smem.cu one_pos_kernel) runs side by side; so a lane's latency
// floor is its steps, not its rounds, and a 512-task pass fills 16 warps
// of the card. With lanes below the task count a lane's chain is the sum
// of its tasks' steps: a smaller pool lengthens the longest lane. What
// the design does about it: nothing else rides the chain (the codes are
// read-only loads of a few lines a read, a step's base is known before
// its fetch), and the pool keeps every lane busy to the backlog's end.
// Measured on that card (PERF.md section 6): 0.78-1.06 us a step of the
// longest lane, five to seven times the trip, with pass 3 (no stacks) at
// 0.78 us a tick too; so the trips alone do not set the time. One warp
// an SM (a 512-lane pass is 16 warps on 16 SMs) hides nothing of a tick's
// dependent chain, and a warp runs the branch of every phase its lanes
// are in. Each lane reports its `steps` (occ steps made: the work, single bases
// at every KS) and `ticks` (the iterations, INIT ticks included).
//
// The k-step forms (KS = 2, 3; int32 layout only, as in JAX) change only
// the forward walk, as the k-step forms of csrc/smem.cu do: one k-gram row
// fetch an end takes KS bases (csrc/fmi_step.cuh ext_k), and the steps then run
// one after another exactly as the 1-step walk's (a push where the size
// changes, nx, the last interval), stopping where it stops mid-stride.
// Every extending lane of passes 1-2 calls ext_k, and fetches only the
// groups of the bases it takes: a backward lane the 1-step group (the row
// K = 1 reads), a forward lane those of its bases up to the read's end or
// an N.
// The JAX machine's backward side entries (the round's next entry beside
// a backward tick, two in the tail at K = 3) are a TPU tick-packing and
// are not copied: a backward tick takes one entry, and the output is the
// same. readlane_strategy_kernel<2, int> takes two bases a fetch (a
// trigram table's bigram groups).
//
// The int64 forms (P = long long, the launch functions ending in 64): the
// intervals, the stack entries' k, l and s and the emitted k, l and s are
// 64-bit over the int64 layout of ops/occ.py (csrc/fmi_step.cuh).
//
// Each kernel writes every slot of each row it owns (zeros past the row's
// count; an emission past M is dropped and the count still grows) and
// each lane's steps and ticks, so the wrapper launches nothing but the
// counter's zeroing.

#include "fmi_step.cuh"

namespace {

constexpr int RL_THREADS = 32;    // one warp a block, a worker lane a thread
constexpr int P_INIT = 0, P_FWD = 1, P_BSCAN = 2, P_BTAIL = 3;

// an interval-stack entry (k, l, s, n): one 16-byte load in the int32
// form, 32 bytes in the int64 form
template <typename P>
struct __align__(16) RlEnt {
  P k, l, s;
  int n;
};

// a read's code at column i clamped to [0, L - 1], N (4) for any code
// past 3, 0 for a negative one (the lockstep's clip)
__device__ __forceinline__ int rl_code(const int32_t* q, int L, int i) {
  const int v = __ldg(q + (i < 0 ? 0 : (i >= L ? L - 1 : i)));
  return v < 0 ? 0 : (v > 4 ? 4 : v);
}

// One output row's writer: [2][R][M] int32 (m, n), then [3][R][M] P (k,
// l, s).
template <typename P>
struct RowOut {
  int32_t* out;
  size_t tm;                         // R x M, one field
  int M;

  __device__ __forceinline__ void put(int row, int c, int m, int n, P k,
                                      P l, P s) const {
    P* kls = reinterpret_cast<P*>(out + 2 * tm);
    const size_t o = (size_t)row * M + c;
    out[o] = m;
    out[tm + o] = n;
    kls[o] = k;
    kls[tm + o] = l;
    kls[2 * tm + o] = s;
  }

  // the row's emission, dropped past M
  __device__ __forceinline__ void emit(int row, int& cnt, int m, int n, P k,
                                       P l, P s) const {
    if (cnt < M) put(row, cnt, m, n, k, l, s);
    ++cnt;
  }

  // zeros past the row's count
  __device__ __forceinline__ void finish(int row, int cnt) const {
    for (int c = cnt < M ? cnt : M; c < M; ++c) put(row, c, 0, 0, 0, 0, 0);
  }
};

template <int KS, typename P>
__global__ void __launch_bounds__(RL_THREADS)
readlane_one_pos_kernel(Fmi<P> f, Kfmi g,
                        const int32_t* __restrict__ codes,     // [B, L]
                        const int32_t* __restrict__ lens,      // [B]
                        int B, int L,
                        const int32_t* __restrict__ t_read,    // [N]
                        const int32_t* __restrict__ t_x,       // [N]
                        const int32_t* __restrict__ t_mi,      // [N]
                        const uint8_t* __restrict__ t_valid,   // [N]
                        const int32_t* __restrict__ t_row,     // [N]
                        int N, int T, int chain_restarts,
                        int min_seed_len, int M, int R,
                        RlEnt<P>* __restrict__ stk,      // [T][2][L + 1]
                        int* __restrict__ next_task,     // 0 at the launch
                        int32_t* __restrict__ out,       // [R] rows
                        int32_t* __restrict__ cnt_out,   // [R]
                        int32_t* __restrict__ steps_out,   // [T]
                        int32_t* __restrict__ ticks_out) {  // [T]
  const int lane = blockIdx.x * RL_THREADS + threadIdx.x;
  if (lane >= T) return;
  const RowOut<P> rows{out, (size_t)R * M, M};
  RlEnt<P>* const st = stk + (size_t)lane * 2 * (L + 1);
  int wA = 0;                        // the A stack's buffer; B is wA ^ 1
  int steps = 0, ticks = 0;
  // the task
  const int32_t* q = codes;
  int row = 0, len = 0, x = 0, cnt = 0, phase = P_INIT;
  P mi = 0;
  // the walk: the column, next_x, the forward interval, the stacks'
  // counts, the A entries' shared m, the scan index and direction, the
  // distinct-s tracker
  int j = 0, nx = 0, cn = 0, cntA = 0, cntB = 0, mA = 0, p = 0;
  bool rev = false;
  P ck = 0, cl = 0, cs = 0, curr_s = -1;
  auto code = [&](int i) { return rl_code(q, L, i); };
  auto push = [&](int buf, int& c, P k, P l, P s, int n) {
    st[buf * (L + 1) + (c < L ? c : L)] = RlEnt<P>{k, l, s, n};
    ++c;
  };
  auto pull = [&]() -> bool {
    const int t = atomicAdd(next_task, 1);
    if (t >= N) return false;
    int rd = t_read[t];
    rd = rd < 0 ? 0 : (rd >= B ? B - 1 : rd);
    q = codes + (size_t)rd * L;
    len = t_valid[t] ? lens[rd] : 0;
    mi = (P)t_mi[t];
    row = t_row[t];
    x = t_x[t];
    cnt = 0;
    phase = P_INIT;
    return true;
  };
  bool live = pull();
  while (live) {                       // one tick an iteration
    ++ticks;
    bool fin = false;
    if (phase == P_INIT) {             // the 1-base interval at x
      const int xa = code(x);
      nx = x + 1;
      if (x < len && xa < 4) {
        ck = cval(f, xa);
        cl = cval(f, 3 - xa);
        cs = cval(f, xa + 1) - ck;
        cn = x;
        j = x + 1;
        cntA = 0;
        phase = P_FWD;
      } else if (chain_restarts && x + 1 < len) {
        ++x;
      } else {
        fin = true;
      }
    } else {
      const bool fwd = phase == P_FWD;
      const int a = code(j);
      RlEnt<P> e{0, 0, 0, 0};
      if (!fwd) {
        const int si = rev ? cntA - 1 - p : p;
        e = st[wA * (L + 1) + (si < 0 ? 0 : (si >= L ? L - 1 : si))];
      }
      const bool dead = phase == P_BSCAN && p == 0
                        && (j < 0 || a >= 4 || cntA == 0);
      const bool need = fwd ? (j < len && a < 4)
                            : (phase == P_BSCAN ? !dead : p < cntA);
      // the tick's one occ step, from one call site (a, the read's base,
      // is < 4 wherever need holds)
      P nk[KS], nl[KS], ns[KS];
#pragma unroll
      for (int d = 0; d < KS; ++d) nk[d] = nl[d] = ns[d] = 0;
      if (need) {
        const P kk = fwd ? cl : e.k, ll = fwd ? ck : e.l, ss = fwd ? cs : e.s;
        if constexpr (KS == 1) {
          ext(f, kk, ll, ss, fwd ? 3 - a : a, nk[0], nl[0], ns[0]);
        } else {
          // a backward step fetches the 1-step group alone, a forward one
          // the groups of its bases up to the read's end or an N
          int c[KS], live = 1;
          c[0] = fwd ? 3 - a : a;
#pragma unroll
          for (int d = 1; d < KS; ++d) {
            const int cd = fwd ? code(j + d) : 4;
            c[d] = fwd ? 3 - (cd < 4 ? cd : 3) : 0;
            live += live == d && j + d < len && cd < 4;
          }
          ext_k<KS>(f, g, kk, ll, ss, c, nk, nl, ns, live);
        }
      }
      if (fwd) {
        // the forward interval after d + 1 bases: (nl[d], nk[d], ns[d])
        bool end;
        if constexpr (KS == 1) {
          const bool fail = need && ns[0] < mi;
          if (need) {
            ++steps;
            if (ns[0] != cs) push(wA, cntA, ck, cl, cs, cn);
          }
          if (j < len) nx = j + 1;
          if (fail) nx = j;
          end = !need || fail;
          if (end) {
            if (cs >= mi) push(wA, cntA, ck, cl, cs, cn);
          } else {
            ck = nl[0];
            cl = nk[0];
            cs = ns[0];
            cn = j;
            ++j;
          }
        } else {
          // KS steps from one fetch, each as the 1-step walk's
          P ek = ck, el = cl, es = cs, pk = ck, pl = cl, ps = cs;
          int en = cn, pn = cn;
          bool gate = true, cont = false;
#pragma unroll
          for (int d = 0; d < KS; ++d) {
            const int jd = j + d;
            const bool run = gate && jd < len && (d == 0 ? a : code(jd)) < 4;
            const P sk = nl[d], sl = nk[d], ss = ns[d];
            if (run) {
              ++steps;
              if (ss != ps) push(wA, cntA, pk, pl, ps, pn);
            }
            const bool fail = run && ss < mi;
            cont = run && !fail;
            if (gate && jd < len) nx = jd + 1;
            if (fail) nx = jd;
            if (cont) {
              ek = sk;
              el = sl;
              es = ss;
              en = jd;
            }
            pk = sk;
            pl = sl;
            ps = ss;
            pn = jd;
            gate = cont;
          }
          end = !cont;
          if (end && es >= mi) push(wA, cntA, ek, el, es, en);
          ck = ek;
          cl = el;
          cs = es;
          cn = en;
          if (cont) j += KS;
        }
        if (end) {                     // backward from x - 1, stack top first
          mA = x;
          phase = P_BSCAN;
          j = x - 1;
          rev = true;
          p = 0;
          curr_s = -1;
          cntB = 0;
        }
      } else if (dead) {               // the position's end
        if (cntA > 0 && e.n - mA + 1 >= min_seed_len)
          rows.emit(row, cnt, mA, e.n, e.k, e.l, e.s);
        if (chain_restarts) {
          const int x2 = nx > x + 1 ? nx : x + 1;
          if (x2 >= len) {
            fin = true;
          } else {
            x = x2;
            phase = P_INIT;
          }
        } else {
          fin = true;
        }
      } else {
        bool keep, over;
        if (need) ++steps;
        if (phase == P_BSCAN) {        // the first hit ends the scan
          const bool die = ns[0] < mi;
          const bool emit_sc = die && e.n - mA + 1 >= min_seed_len;
          keep = !die && ns[0] != curr_s;
          if (emit_sc) rows.emit(row, cnt, mA, e.n, e.k, e.l, e.s);
          if (emit_sc || keep) phase = P_BTAIL;
          ++p;
          over = !(emit_sc || keep) && p >= cntA;
        } else {                       // the tail keeps distinct sizes
          keep = p < cntA && ns[0] >= mi && ns[0] != curr_s;
          ++p;
          over = p >= cntA;
        }
        if (keep) {
          push(wA ^ 1, cntB, nk[0], nl[0], ns[0], e.n);
          curr_s = ns[0];
        }
        if (over) {                    // prev <- curr: the buffers swap
          wA ^= 1;
          cntA = cntB;
          cntB = 0;
          mA = j;
          --j;
          rev = false;
          p = 0;
          curr_s = -1;
          phase = P_BSCAN;
        }
      }
    }
    if (fin) {                         // the task's row, then the next task
      rows.finish(row, cnt);
      cnt_out[row] = cnt;
      live = pull();
    }
  }
  steps_out[lane] = steps;
  ticks_out[lane] = ticks;
}

template <int KS, typename P>
__global__ void __launch_bounds__(RL_THREADS)
readlane_strategy_kernel(Fmi<P> f, Kfmi g,
                         const int32_t* __restrict__ codes,    // [B, L]
                         const int32_t* __restrict__ lens,     // [B]
                         int B, int L, int T, int max_intv,
                         int min_seed_len, int M,
                         int* __restrict__ next_read,    // 0 at the launch
                         int32_t* __restrict__ out,      // [B] rows
                         int32_t* __restrict__ cnt_out,  // [B]
                         int32_t* __restrict__ steps_out,   // [T]
                         int32_t* __restrict__ ticks_out) {  // [T]
  const int lane = blockIdx.x * RL_THREADS + threadIdx.x;
  if (lane >= T) return;
  const RowOut<P> rows{out, (size_t)B * M, M};
  int steps = 0, ticks = 0;
  const int32_t* q = codes;
  int rd = 0, len = 0, x = 0, j = 0, cnt = 0, phase = P_INIT;
  P ck = 0, cl = 0, cs = 0;
  auto code = [&](int i) { return rl_code(q, L, i); };
  auto pull = [&]() -> bool {
    rd = atomicAdd(next_read, 1);
    if (rd >= B) return false;
    q = codes + (size_t)rd * L;
    len = lens[rd];
    x = 0;
    cnt = 0;
    phase = P_INIT;
    return true;
  };
  bool live = pull();
  while (live) {                       // one tick an iteration
    ++ticks;
    bool fin = false;
    if (phase == P_INIT) {
      const int xa = code(x);
      if (x < len && xa < 4) {
        ck = cval(f, xa);
        cl = cval(f, 3 - xa);
        cs = cval(f, xa + 1) - ck;
        j = x + 1;
        phase = P_FWD;
      } else if (x + 1 < len) {
        ++x;
      } else {
        fin = true;
      }
    } else {
      // forward from x: stop at the first j whose size falls below
      // max_intv with at least min_seed_len bases (emitted when s > 0),
      // at an N or at the read's end; the next walk starts at next_x
      const int a = code(j);
      const bool j_in = j < len, r1 = j_in && a < 4;
      bool end;
      int nxv;
      if constexpr (KS == 1) {
        P nk = 0, nl = 0, ns = 0;
        if (r1) {
          ++steps;
          ext(f, cl, ck, cs, 3 - a, nl, nk, ns);   // the swapped interval
        }
        const bool hit = r1 && ns < max_intv && j + 1 - x >= min_seed_len;
        if (hit && ns > 0) rows.emit(rd, cnt, x, j, nk, nl, ns);
        nxv = j_in ? j + 1 : j;
        end = !r1 || hit;
        if (!end) {
          ck = nk;
          cl = nl;
          cs = ns;
          ++j;
        }
      } else {                         // two bases a row fetch
        const int b = code(j + 1);
        P bk[2] = {0, 0}, bl[2] = {0, 0}, bs[2] = {0, 0};
        if (r1) {
          // both groups always: fetching the second only where the
          // read goes on (live) timed 4-6% slower (PERF.md section 6)
          int ch[2] = {3 - a, 3 - (b < 4 ? b : 3)};
          ext_k<2>(f, g, cl, ck, cs, ch, bk, bl, bs);
        }
        const bool hit1 = r1 && bs[0] < max_intv
                          && j + 1 - x >= min_seed_len;
        const bool cont1 = r1 && !hit1;
        const bool j2_in = j + 1 < len;
        const bool r2 = cont1 && j2_in && b < 4;
        const bool hit2 = r2 && bs[1] < max_intv
                          && j + 2 - x >= min_seed_len;
        const bool cont2 = r2 && !hit2;
        steps += (int)r1 + (int)r2;
        if (hit1 && bs[0] > 0)
          rows.emit(rd, cnt, x, j, bl[0], bk[0], bs[0]);
        else if (hit2 && bs[1] > 0)
          rows.emit(rd, cnt, x, j + 1, bl[1], bk[1], bs[1]);
        nxv = cont1 ? (j2_in ? j + 2 : j + 1) : (j_in ? j + 1 : j);
        end = !cont2;
        if (cont2) {
          ck = bl[1];
          cl = bk[1];
          cs = bs[1];
          j += 2;
        }
      }
      if (end) {
        if (nxv >= len) {
          fin = true;
        } else {
          x = nxv;
          phase = P_INIT;
        }
      }
    }
    if (fin) {                         // the read's row, then the next read
      rows.finish(rd, cnt);
      cnt_out[rd] = cnt;
      live = pull();
    }
  }
  steps_out[lane] = steps;
  ticks_out[lane] = ticks;
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
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || B <= 0 || L <= 0
      || N < 0 || M < 0 || R < 0 || stk == nullptr || ctr == nullptr)
    return (int)cudaErrorInvalidValue;
  readlane_one_pos_kernel<KS, P><<<(T + RL_THREADS - 1) / RL_THREADS,
                                   RL_THREADS, 0, (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, B, L,
      (const int32_t*)t_read, (const int32_t*)t_x, (const int32_t*)t_mi,
      (const uint8_t*)t_valid, (const int32_t*)t_row, N, T, chain_restarts,
      min_seed_len, M, R, (RlEnt<P>*)stk, (int*)ctr, (int32_t*)out,
      (int32_t*)cnt, (int32_t*)steps, (int32_t*)ticks);
  return (int)cudaGetLastError();
}

template <int KS, typename P>
int strategy_launch_t(const Fmi<P>& f, const Kfmi& g, const void* codes,
                      const void* lens, int B, int L, int T, int max_intv,
                      int min_seed_len, int M, void* ctr, void* out,
                      void* cnt, void* steps, void* ticks, void* stream) {
  if (T <= 0) return 0;
  if (!fmi_ok(f) || (KS > 1 && !kfmi_ok(g, KS)) || B < 0 || L <= 0 || M < 0
      || ctr == nullptr)
    return (int)cudaErrorInvalidValue;
  readlane_strategy_kernel<KS, P><<<(T + RL_THREADS - 1) / RL_THREADS,
                                    RL_THREADS, 0, (cudaStream_t)stream>>>(
      f, g, (const int32_t*)codes, (const int32_t*)lens, B, L, T, max_intv,
      min_seed_len, M, (int*)ctr, (int32_t*)out, (int32_t*)cnt,
      (int32_t*)steps, (int32_t*)ticks);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch readlane_one_pos_kernel on `stream`: T worker lanes (threads,
// one-warp blocks) over N tasks; returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for arguments it cannot take. The
// caller allocates every buffer: the stacks `stk` [T][2][L + 1] entries of
// 16 bytes, the counter `ctr` (one int, zeroed before the launch), out
// [2][R][M] int32 then [3][R][M] int32 (every row a task owns is written
// whole), cnt [R], steps and ticks [T]; t_row gives each task's row
// (distinct rows). Nothing here synchronises.
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
// one_pos_launch64); stack entries of 32 bytes; out [2][R][M] int32 then
// [3][R][M] int64.
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

// readlane_one_pos_launch's k-step forms (int32 layout only): the k-gram
// table `cpk` ([nb][w4] int4, w4 = 10 or 42) with its C2 [16] and C3
// [64] tables (`c3k` null at ks = 2), the forward walk ks = 2 or 3 bases
// a row fetch; the rest as readlane_one_pos_launch.
extern "C" int readlane_one_pos_launch_k(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* cpk, int w4, const void* c2k,
    const void* c3k, int ks, const void* codes, const void* lens, int B,
    int L, const void* t_read, const void* t_x, const void* t_mi,
    const void* t_valid, const void* t_row, int N, int T,
    int chain_restarts, int min_seed_len, int M, int R, void* stk,
    void* ctr, void* out, void* cnt, void* steps, void* ticks,
    void* stream) {
  const Fmi<int> f = make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel);
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

// Launch readlane_strategy_kernel on `stream`: T worker lanes over B
// reads, read b emitting into row b of out [2][B][M] int32 then [3][B][M]
// int32; `ctr` one int zeroed before the launch; the return and the
// caller's duties as readlane_one_pos_launch.
extern "C" int readlane_strategy_launch(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* codes, const void* lens, int B, int L, int T,
    int max_intv, int min_seed_len, int M, void* ctr, void* out, void* cnt,
    void* steps, void* ticks, void* stream) {
  return strategy_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel), Kfmi{}, codes,
      lens, B, L, T, max_intv, min_seed_len, M, ctr, out, cnt, steps, ticks,
      stream);
}

// readlane_strategy_launch's int64 form (the index as
// readlane_one_pos_launch64's; out [2][B][M] int32 then [3][B][M] int64).
extern "C" int readlane_strategy_launch64(
    const void* cp_fused, long long nb, long long c0, long long c1,
    long long c2, long long c3, long long c4, long long sentinel,
    const void* hi, int h0, int h1, int h2, int h3, const void* codes,
    const void* lens, int B, int L, int T, int max_intv, int min_seed_len,
    int M, void* ctr, void* out, void* cnt, void* steps, void* ticks,
    void* stream) {
  return strategy_launch_t<1>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel, hi, h0, h1, h2,
               h3),
      Kfmi{}, codes, lens, B, L, T, max_intv, min_seed_len, M, ctr, out, cnt,
      steps, ticks, stream);
}

// readlane_strategy_launch's k-step form (int32 layout only): two bases a
// row fetch from the k-gram table (a trigram table's bigram groups).
extern "C" int readlane_strategy_launch_k(
    const void* cp_fused, int nb, int c0, int c1, int c2, int c3, int c4,
    int sentinel, const void* cpk, int w4, const void* c2k,
    const void* codes, const void* lens, int B, int L, int T, int max_intv,
    int min_seed_len, int M, void* ctr, void* out, void* cnt, void* steps,
    void* ticks, void* stream) {
  return strategy_launch_t<2>(
      make_fmi(cp_fused, nb, c0, c1, c2, c3, c4, sentinel),
      make_kfmi(cpk, nb, w4, c2k, nullptr), codes, lens, B, L, T, max_intv,
      min_seed_len, M, ctr, out, cnt, steps, ticks, stream);
}
