// One task of SMEM passes 1 and 2 run by one warp (getSMEMsOnePosOneThread,
// src/FMI_search.cpp:1372-1660), shared by csrc/smem.cu's one_pos_kernel
// (a warp a task) and csrc/readlane.cu's readlane_one_pos_kernel (a warp a
// worker lane pulling tasks): the serial forward walk, then each backward
// round 32 entries a chunk by the ballot rule, as csrc/smem.cu's note on
// one_pos_kernel sets out; in the k-step forms KS backward rounds a fetch
// where a round's entries fit one chunk (csrc/smem.cu's note on them).
// ops/nvcc_build.py hashes a source together with the headers it
// includes, so a change here rebuilds both libraries.

#pragma once

#include "fmi_step.cuh"

namespace {

// An interval-stack entry (k, l, s, n) in x, y, z, w: an int4 in the
// int32 form, 32 bytes in the int64 form.
struct __align__(16) Ent64 {
  long long x, y, z;
  int w, pad;
};

template <typename P>
struct EntOf {
  using T = int4;
};

template <>
struct EntOf<long long> {
  using T = Ent64;
};

template <typename P>
using Ent = typename EntOf<P>::T;

__device__ __forceinline__ int4 make_ent(int k, int l, int s, int n) {
  return make_int4(k, l, s, n);
}

__device__ __forceinline__ Ent64 make_ent(long long k, long long l,
                                          long long s, int n) {
  return Ent64{k, l, s, n, 0};
}

// bytes of one warp's two interval stacks of SD + 1 entries
template <typename P>
__host__ __device__ __forceinline__ size_t stacks_bytes(int SD) {
  return 2 * ((size_t)SD + 1) * sizeof(Ent<P>);
}

// whether one warp's codes (L) and stacks (SD) fit its shared memory
template <typename P>
bool stacks_in_shared(int L, int SD) {
  return codes_bytes(L) + stacks_bytes<P>(SD) <= SMEM_MAX;
}

// The output rows a task emits into: [2][R][M] int32 (m, n), then
// [3][R][M] P (k, l, s), one field tm = R x M entries.
template <typename P>
struct SmemRows {
  int32_t* out;
  size_t tm;
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

  // the row's M slots zeroed by the warp's lanes
  __device__ __forceinline__ void zero(int row, int lane) const {
    for (int i = lane; i < M; i += WARP) put(row, i, 0, 0, 0, 0, 0);
  }
};

// What a task's walk gives back: its emissions' count (lane 0's; the
// other lanes' is 0), its occ steps and dependent round trips, and
// whether a stack count passed SD.
struct TaskCounts {
  int cnt, steps, rounds;
  bool of;
};

// The walk of one task (read codes q staged in shared memory as bytes,
// its length len, start x, minimum interval mi) by the warp's lanes,
// every lane alike but for the emissions, which lane 0 makes into row
// `row` of `rows`; the stacks `stk` are [2][SD + 1] entries. The caller
// zeroes the row and syncs the warp after staging the codes. The k-step
// forms (KS > 1, P int) read the k-gram table `g` alone, their C2 and C3
// values from `wc` (warp_c, once a launch).
template <int KS, typename P>
__device__ __forceinline__ TaskCounts one_pos_task(
    const Fmi<P>& f, const Kfmi& g, const WarpC& wc, const int8_t* q,
    int L, int len, int x, int mi, int chain_restarts, int min_seed_len,
    int SD, Ent<P>* stk, const SmemRows<P>& rows, int row, int lane) {
  static_assert(KS == 1 || sizeof(P) == 4, "k-step forms: int32 only");
  const int M = rows.M;
  auto code = [&](int i) { return q[i < 0 ? 0 : (i >= L ? L - 1 : i)]; };
  auto C = [&](int c) { return cval(f, c); };
  auto slot = [&](int buf, int i) -> Ent<P>& {
    return stk[buf * (SD + 1) + i];
  };
  auto rslot = [&](int i) { return i < 0 ? 0 : (i >= SD ? SD - 1 : i); };
  // the 1-step ext of a chunked backward round: cp_fused's row, or in a
  // k-step form group 0 of the k-gram row (the same counts and masks)
  auto ext1 = [&](P k, P l, P s, int c, P& nk, P& nl, P& ns) {
    if constexpr (KS == 1) {
      ext(f, k, l, s, c, nk, nl, ns);
    } else {
      const int cc[1] = {c}, base[1] = {cval(f, c)};
      int rk[1], rl[1], rs[1];
      ext_kt<1>(g, f.sentinel, k, l, s, cc, base, rk, rl, rs);
      nk = rk[0];
      nl = rl[0];
      ns = rs[0];
    }
  };

  // warp-uniform state, every lane alike, but for cnt: lane 0 emits, and
  // only its count is kept
  int cnt = 0, steps = 0, rounds = 0, wA = 0;
  bool of = false;
  auto push = [&](int buf, int& c, P k, P l, P s, int n) {
    if (lane == 0) slot(buf, c < SD ? c : SD) = make_ent(k, l, s, n);
    ++c;
    of |= c > SD;
  };
  auto emit = [&](int m, int n, P k, P l, P s) {             // lane 0
    if (cnt < M) rows.put(row, cnt, m, n, k, l, s);
    ++cnt;
  };

  for (;;) {                                       // start positions
    const int xa = x < len ? code(x) : 4;
    if (xa >= 4) {
      if (chain_restarts && ++x < len) continue;
      break;
    }
    __syncwarp();              // the last position's reads are done
    // forward extension from x: serial, every lane alike; each step's
    // base is read a step ahead, so the N test waits on no load
    P ck = C(xa), cl = C(3 - xa), cs = C(xa + 1) - C(xa);
    int cn = x;
    int j = x + 1, nx = x + 1, cA = 0, a = code(j);
    // one base of the walk, its extension (nk, nl, ns) made: push the
    // interval where the size changes; false where the size falls below
    // mi (nx = j) and the walk ends
    auto take = [&](P nk, P nl, P ns) {
      ++steps;
      if (ns != cs) push(wA, cA, ck, cl, cs, cn);
      if (ns < mi) {
        nx = j;
        return false;
      }
      ck = nk;
      cl = nl;
      cs = ns;
      cn = j;
      ++j;
      return true;
    };
    if constexpr (KS == 1) {
      while (j < len) {
        nx = j + 1;
        if (a >= 4) break;
        const int an = code(j + 1);
        P nk, nl, ns;
        ext(f, cl, ck, cs, 3 - a, nl, nk, ns);     // the swapped interval
        ++rounds;
        if (!take(nk, nl, ns)) break;
        a = an;
      }
    } else {
      // KS bases a row fetch; a walk that ends mid-stride (an N, the
      // read's end, a size below mi) stops where the 1-step walk stops,
      // with the same pushes, nx and last interval
      bool go = true;
      while (go && j < len) {
        nx = j + 1;
        if (a >= 4) break;
        int cc[KS], ch[KS], base[KS], bk[KS], bl[KS], bs[KS];
        int live = 1;                  // the bases before an N or the end
#pragma unroll
        for (int d = 0; d < KS; ++d) {
          cc[d] = d ? code(j + d) : a;
          ch[d] = 3 - (cc[d] < 4 ? cc[d] : 3);
          if (d && live == d && j + d < len && cc[d] < 4) live = d + 1;
        }
        const int an = code(j + KS);
        kbases<KS>(f, wc, ch, base);
        ext_kt<KS>(g, f.sentinel, cl, ck, cs, ch, base, bk, bl, bs, live);
        ++rounds;
#pragma unroll
        for (int d = 0; d < KS; ++d) {
          if (d) {
            if (j >= len) {
              go = false;
              break;
            }
            nx = j + 1;
            if (cc[d] >= 4) {
              go = false;
              break;
            }
          }
          if (!take(bl[d], bk[d], bs[d])) {
            go = false;
            break;
          }
        }
        a = an;
      }
    }
    if (cs >= mi) push(wA, cA, ck, cl, cs, cn);

    // backward rounds: the first reads the A stack from its top
    int mA = x;
    bool rev = true;
    for (j = x - 1, a = code(j);;) {
      __syncwarp();            // the pushes to the A stack are visible
      if (j < 0 || a >= 4 || cA == 0) {
        if (cA > 0) {
          const Ent<P> e = slot(wA, rslot(rev ? cA - 1 : 0));
          if (lane == 0 && e.w - mA + 1 >= min_seed_len)
            emit(mA, e.w, e.x, e.y, e.z);
        }
        break;
      }
      if constexpr (KS > 1) {
        if (cA <= WARP && cA <= SD) {
          // KS rounds a fetch: lane p extends entry p by the bases at j,
          // j - 1, ... from one k-gram row an end, and the keep/emit rule
          // runs KS times in registers, each sub-round over the lanes the
          // one before kept, in lane order (the same orders hold: the same
          // base extends nested intervals into nested ones)
          const bool act = lane < cA;
          const Ent<P> e = act ? slot(wA, rev ? cA - 1 - lane : lane)
                               : make_ent((P)0, (P)0, (P)0, 0);
          int cc[KS], ch[KS], base[KS], rk[KS] = {}, rl[KS] = {}, rs[KS] = {};
          int live = 1;        // the bases before the read's start or an N
#pragma unroll
          for (int d = 0; d < KS; ++d) {
            cc[d] = d ? (j - d >= 0 ? code(j - d) : 4) : a;
            ch[d] = cc[d] < 4 ? cc[d] : 0;
            if (d && live == d && cc[d] < 4) live = d + 1;
          }
          kbases<KS>(f, wc, ch, base);
          if (act)
            ext_kt<KS>(g, f.sentinel, e.x, e.y, e.z, ch, base, rk, rl, rs,
                       live);
          ++rounds;
          unsigned in = __ballot_sync(FULL, act);  // the sub-round's entries
          P pk = e.x, pl = e.y, ps = e.z;          // each one's interval
          int m = mA;                              // and its match start
          // lane 0 emits lane src's entry at m when it is long enough
          auto emit_lane = [&](int src) {
            const P k0 = __shfl_sync(FULL, pk, src);
            const P l0 = __shfl_sync(FULL, pl, src);
            const P s0 = __shfl_sync(FULL, ps, src);
            const int n0 = __shfl_sync(FULL, e.w, src);
            if (lane == 0 && n0 - m + 1 >= min_seed_len)
              emit(m, n0, k0, l0, s0);
          };
          bool done = false;
#pragma unroll
          for (int d = 0; d < KS; ++d) {
            if (d && (d >= live || in == 0)) {
              // the read's start, an N, or no entry left: the first entry
              // emits when long enough, and the backward rounds end
              if (in) emit_lane(__ffs(in) - 1);
              done = true;
              break;
            }
            const P ns = rs[d];
            const bool mine = (in >> lane) & 1;
            const unsigned below = in & ((1u << lane) - 1);
            steps += __popc(in);
            // only the first entry can emit: it dies and is long enough
            const unsigned em = __ballot_sync(
                FULL, mine && below == 0 && ns < mi
                          && e.w - m + 1 >= min_seed_len);
            if (em) emit_lane(__ffs(em) - 1);
            // the entry before is the kept lane below
            const P up = __shfl_sync(FULL, ns, below ? 31 - __clz(below)
                                                     : lane);
            const P cur = (below == 0 || up < mi) ? (P)-1 : up;
            in = __ballot_sync(FULL, mine && ns >= mi && ns != cur);
            pk = rk[d];
            pl = rl[d];
            ps = rs[d];
            m = j - d;
          }
          if (done) break;
          if ((in >> lane) & 1)          // the last sub-round's kept entries
            slot(wA ^ 1, __popc(in & ((1u << lane) - 1))) =
                make_ent(pk, pl, ps, e.w);
          wA ^= 1;
          cA = __popc(in);
          mA = j - (KS - 1);
          rev = false;
          j -= KS;
          a = code(j);
          continue;
        }
      }
      const int an = code(j - 1);                  // the next round's base
      int cB = 0;
      P prev = 0;
      for (int c0 = 0; c0 < cA; c0 += WARP) {      // a chunk: one trip
        const int p = c0 + lane;
        const bool act = p < cA;
        Ent<P> e = make_ent((P)0, (P)0, (P)0, 0);
        P nk = 0, nl = 0, ns = 0;
        if (act) {
          e = slot(wA, rslot(rev ? cA - 1 - p : p));
          ext1(e.x, e.y, e.z, a, nk, nl, ns);
        }
        steps += min(WARP, cA - c0);
        ++rounds;
        // only entry 0 can emit: it dies and is long enough
        if (p == 0 && ns < mi && e.w - mA + 1 >= min_seed_len)
          emit(mA, e.w, e.x, e.y, e.z);
        P up = __shfl_up_sync(FULL, ns, 1);
        if (lane == 0) up = prev;                  // the last chunk's end
        const P cur = (p == 0 || up < mi) ? (P)-1 : up;
        const bool keep = act && ns >= mi && ns != cur;
        const unsigned kept = __ballot_sync(FULL, keep);
        if (keep) {
          const int i = cB + __popc(kept & ((1u << lane) - 1));
          slot(wA ^ 1, i < SD ? i : SD) = make_ent(nk, nl, ns, e.w);
        }
        cB += __popc(kept);
        if (c0 + WARP < cA) prev = __shfl_sync(FULL, ns, WARP - 1);
      }
      of |= cB > SD;
      wA ^= 1;
      cA = cB;
      mA = j;
      rev = false;
      --j;
      a = an;
    }
    if (!chain_restarts) break;
    x = max(nx, x + 1);
    if (x >= len) break;
  }
  return TaskCounts{cnt, steps, rounds, of};
}

}  // namespace
