// Seed chaining and the chain filter for Hopper (sm_90a): one thread a
// read, each read's whole walk in one launch, no host synchronisation
// inside. Two kernels:
// - chain_seeds_kernel: mem_chain_seeds (src/bwamem.cpp:789-960);
// - chain_filter_kernel: mem_chain_weight and mem_chain_flt
//   (src/bwamem.cpp:452-471, 528-646), and in the same launch the
//   repetitive fraction of mem_chain_seeds' prologue (:836-846).
// They replace bwa_mem_scale_tpu/ops/chain.py:78 chain_seeds_device (its
// jax.lax.while_loop, :242), :299 chain_filter_device (:384, :392) with
// :270 chain_weights, and :246 frac_rep_device, through the port's
// lockstep versions in ops/chain.py (chain_seeds_device and
// chain_filter_frac_rep), which take ~55 PyTorch launches a coordinate
// step, one host synchronisation, and ~2,000 launches for the filter's
// C-wide loops. Each kernel returns its plain version's arrays exactly;
// the TPU's one-hot selects are not ported (a GPU thread indexes its own
// rows directly).
//
// What bounds them on this card: neither bytes nor operations. A read's
// work is a few coordinates and chains, each waiting on loads of rows
// the thread wrote a moment before (the sorted keys, the lower chain's
// seed count and last seed), so the longest read's chain of dependent
// round trips sets the time; the bytes are mostly chain_seeds' zeroed
// [B, C, S] seed planes, written by the wrapper's fill. The design keeps
// that chain short: the lower bound is a binary search over the n live
// keys, and the filter touches only the n live slots. Left for later
// work: a warp a read, the keys in shared memory, ballot-based lower
// bounds.
//
// ---- chain_seeds_kernel
// One thread a read walks its coordinates in order while coord_valid[b,
// c] holds (the coordinates come in SMEM order, then interval order, and
// valid ones are a prefix of the row, ops/sal.py::expand_and_lookup, so
// the walk ends at the first invalid one). For each: the
// seed's query begin and length from its SMEM; rid by bns_intv2rid (an
// upper-bound search over the contig offsets, -1 past l_pac or for a
// span over two contigs, -2 for a span over the strands' junction); a
// seed with rid < 0 is skipped. The lower-bound chain is the last live
// key <= rbeg (an upper bound over the n live keys: the keys past n hold
// BIG = 2^29 - 1, which a reverse-strand rbeg reaches once l_pac passes
// ~268 Mbp, so they are never counted). test_and_merge
// (src/bwamem.cpp:379-421) against it: a contained seed merges, a
// colinear one appends (or sets the overflow flag when the chain holds
// S seeds); otherwise a new chain starts in slot n (or the overflow flag
// is set when n = C) and (rbeg, n) is inserted into the sorted keys at
// the upper bound. The [B, C] rows are written by the kernel (key BIG
// past n, slot 0, rid -1, n_seeds 0); the [4][B][C][S] seed planes
// (qbeg, rbeg, len, score = len) are zeroed by the wrapper, and a seed is
// written to all four. Capacities C and S are launch arguments, so every
// retry tier (64/32, 256/64, 1024/256) takes the same code.
//
// ---- chain_filter_kernel
// One thread a read. Weights: for each live slot the two int64 coverage
// scans (query, reference) over its seeds, the smaller clamped to
// 2^30 - 1; slots at n and past hold no seeds and weigh 0. Order: a
// stable insertion sort of the live slots by weight descending, slots
// under min_chain_weight keyed -1 (so last, in slot order), then the
// empty slots in slot order: the stable argsort over all C positions.
// The overlap loop over sorted positions i in [1, n_heavy) tests each
// kept j < i in order: significant when the query spans overlap by at
// least min_l * mask_level (in double, as the JAX package promotes the
// product to float64) with min_l < max_chain_gap and alt_j implying
// alt_i; a significant j whose first is unset records i; the first
// significant j with w_i < w_j * drop_ratio (double) and
// w_j - w_i >= 2 * min_seed_len drops i and ends the loop. Then kept
// chains pass kept = 1 to the chain named by their first, in index order
// and in place (a 3 can become a 1), and the kept == 1 or 2 chains past
// max_chain_extend are cut. The sorted positions' query span, weight,
// alt flag and first live in a [5][C][B] scratch (lane minor) that the
// wrapper allocates. frac_rep: the serial scan over the read's sorted
// SMEMs with more than max_occ hits, their union's length over the read
// length, in float as the plain version divides.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 32;                  // reads (threads) a block
constexpr int BIG = 0x7fffffff / 4;        // the empty key, int32 max // 4

struct Bns {
  const int64_t* offsets;                  // [n_seqs] contig offsets
  const uint8_t* is_alt;                   // [n_seqs]
  int n_seqs;
  long long l_pac;
};

// bns_depos: the forward-strand position of pos
__device__ __forceinline__ long long depos(const Bns& g, long long pos) {
  return pos >= g.l_pac ? 2 * g.l_pac - 1 - pos : pos;
}

// bns_pos2rid of a forward position: the last contig whose offset is
// <= pos_f (an upper bound, minus one), or -1 at and past l_pac
__device__ int pos2rid(const Bns& g, long long pos_f) {
  if (pos_f >= g.l_pac) return -1;
  int lo = 0, hi = g.n_seqs;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (g.offsets[mid] <= pos_f) lo = mid + 1; else hi = mid;
  }
  return lo - 1;
}

// bns_intv2rid of [rb, re)
__device__ int intv2rid(const Bns& g, int rb, int re) {
  if (rb < g.l_pac && re > g.l_pac) return -2;   // over the junction
  const int rid_b = pos2rid(g, depos(g, rb));
  const int rid_e = pos2rid(g, depos(g, rb < re ? re - 1 : rb));
  return rid_b == rid_e ? rid_b : -1;
}

__global__ void __launch_bounds__(BLOCK)
chain_seeds_kernel(Bns g, const int32_t* __restrict__ rbeg,   // [B, NC]
                   const int32_t* __restrict__ seed_idx,       // [B, NC]
                   const uint8_t* __restrict__ coord_valid,    // [B, NC]
                   const int32_t* __restrict__ sm_m,           // [B, M]
                   const int32_t* __restrict__ sm_n,           // [B, M]
                   int B, int NC, int M, int w, int max_chain_gap, int C,
                   int S,
                   int32_t* __restrict__ key,        // [B, C]
                   int32_t* __restrict__ slot,       // [B, C]
                   int32_t* __restrict__ n_out,      // [B]
                   int32_t* __restrict__ rid_t,      // [B, C]
                   int32_t* __restrict__ n_seeds,    // [B, C]
                   int32_t* __restrict__ seeds,      // [4][B][C][S], zeroed
                   uint8_t* __restrict__ overflow,   // [B]
                   int32_t* __restrict__ steps_out) {  // [B]
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  int32_t* ky = key + (size_t)b * C;
  int32_t* sl = slot + (size_t)b * C;
  int32_t* rd = rid_t + (size_t)b * C;
  int32_t* ns = n_seeds + (size_t)b * C;
  for (int c = 0; c < C; ++c) {
    ky[c] = BIG;
    sl[c] = 0;
    rd[c] = -1;
    ns[c] = 0;
  }
  const size_t plane = (size_t)B * C * S;
  int32_t* sq = seeds + (size_t)b * C * S;        // [C][S] each
  int32_t* sr = sq + plane;
  int32_t* sn = sr + plane;
  int32_t* ss = sn + plane;
  const int32_t* m = sm_m + (size_t)b * M;
  const int32_t* e = sm_n + (size_t)b * M;
  auto put = [&](int at, int q, int r, int len) {
    sq[at] = q;
    sr[at] = r;
    sn[at] = len;
    ss[at] = len;
  };
  const uint8_t* valid = coord_valid + (size_t)b * NC;
  int n = 0, c = 0;
  bool of = false;
  for (; c < NC && valid[c]; ++c) {
    const int s_rbeg = rbeg[(size_t)b * NC + c];
    int si = seed_idx[(size_t)b * NC + c];
    si = si < 0 ? 0 : (si >= M ? M - 1 : si);
    const int s_qbeg = m[si];
    const int s_len = e[si] + 1 - s_qbeg;
    const int rid = intv2rid(g, s_rbeg, s_rbeg + s_len);
    if (rid < 0) continue;
    int pos = 0, hi = n;                 // upper bound of rbeg, live keys
    while (pos < hi) {
      const int mid = (pos + hi) >> 1;
      if (ky[mid] <= s_rbeg) pos = mid + 1; else hi = mid;
    }
    bool merged = false;
    if (pos > 0) {                       // test_and_merge with the lower
      const int ls = sl[pos - 1];
      const int ln = ns[ls];
      const int li = ln - 1 < 0 ? 0 : (ln - 1 >= S ? S - 1 : ln - 1);
      const int at = ls * S;
      const int last_q = sq[at + li], last_r = sr[at + li];
      const int last_len = sn[at + li];
      const int first_q = sq[at], first_r = sr[at];
      const bool same_rid = rid == rd[ls];
      const bool contained = same_rid && s_qbeg >= first_q
                             && s_qbeg + s_len <= last_q + last_len
                             && s_rbeg >= first_r
                             && s_rbeg + s_len <= last_r + last_len;
      const bool diff_strand = (last_r < g.l_pac || first_r < g.l_pac)
                               && s_rbeg >= g.l_pac;
      const int x = s_qbeg - last_q, y = s_rbeg - last_r;
      const bool growable = same_rid && !contained && !diff_strand
                            && y >= 0 && x - y <= w && y - x <= w
                            && x - last_len < max_chain_gap
                            && y - last_len < max_chain_gap;
      if (growable) {
        if (ln >= S) {
          of = true;                     // the chain is full
        } else {
          put(at + ln, s_qbeg, s_rbeg, s_len);
          ns[ls] = ln + 1;
        }
      }
      merged = contained || growable;
    }
    if (merged) continue;
    if (n >= C) {                        // no slot for a new chain
      of = true;
      continue;
    }
    put(n * S, s_qbeg, s_rbeg, s_len);
    ns[n] = 1;
    rd[n] = rid;
    for (int k = n; k > pos; --k) {      // the sorted insert
      ky[k] = ky[k - 1];
      sl[k] = sl[k - 1];
    }
    ky[pos] = s_rbeg;
    sl[pos] = n;
    ++n;
  }
  n_out[b] = n;
  overflow[b] = of;
  steps_out[b] = c;
}

// the coverage weight of one slot's seeds on one axis (int64 scan)
__device__ __forceinline__ long long cover(const int32_t* beg,
                                           const int32_t* len, int k) {
  long long end = 0, sum = 0;
  for (int i = 0; i < k; ++i) {
    const long long bb = beg[i], ll = len[i];
    sum += bb >= end ? ll : (bb + ll > end ? bb + ll - end : 0);
    end = bb + ll > end ? bb + ll : end;
  }
  return sum;
}

__global__ void __launch_bounds__(BLOCK)
chain_filter_kernel(Bns g, int B, int C, int S,
                    const int32_t* __restrict__ n_chains,  // [B]
                    const int32_t* __restrict__ rid_t,     // [B, C]
                    const int32_t* __restrict__ n_seeds,   // [B, C]
                    const int32_t* __restrict__ seed_qbeg,  // [B, C, S]
                    const int32_t* __restrict__ seed_rbeg,  // [B, C, S]
                    const int32_t* __restrict__ seed_len,   // [B, C, S]
                    int min_chain_weight, double mask_level,
                    int max_chain_gap, double drop_ratio, int min_seed_len,
                    int max_chain_extend,
                    const int32_t* __restrict__ sm_m,       // [B, M]
                    const int32_t* __restrict__ sm_n,       // [B, M]
                    const int32_t* __restrict__ sm_s,       // [B, M]
                    const int32_t* __restrict__ sm_cnt,     // [B]
                    int M, const int32_t* __restrict__ lens,  // [B]
                    int max_occ,
                    int32_t* __restrict__ scratch,    // [5][C][B]
                    int32_t* __restrict__ order,      // [B, C]
                    int32_t* __restrict__ kept,       // [B, C]
                    int32_t* __restrict__ w_slot,     // [B, C]
                    float* __restrict__ frac_rep,     // [B]
                    int32_t* __restrict__ steps_out) {  // [B]
  const int b = blockIdx.x * BLOCK + threadIdx.x;
  if (b >= B) return;
  int nch = n_chains[b];
  nch = nch < 0 ? 0 : (nch > C ? C : nch);
  const int32_t* ns = n_seeds + (size_t)b * C;
  const int32_t* rd = rid_t + (size_t)b * C;
  const size_t row = (size_t)b * C * S;
  int32_t* ord = order + (size_t)b * C;
  int32_t* kp = kept + (size_t)b * C;
  int32_t* ws = w_slot + (size_t)b * C;
  // the sorted positions' fields, lane minor: a warp at one position
  // reads one line
  const size_t sc = (size_t)C * B;
  auto at = [&](int f, int j) -> int32_t& {
    return scratch[f * sc + (size_t)j * B + b];
  };
  enum { QB, QE, W, ALT, FIRST };
  int steps = 0;

  // weights by slot, and the stable order by weight descending
  int n_heavy = 0;
  for (int c = 0; c < nch; ++c) {
    int k = ns[c];
    k = k < 0 ? 0 : (k > S ? S : k);
    const size_t o = row + (size_t)c * S;
    const long long wq = cover(seed_qbeg + o, seed_len + o, k);
    const long long wr = cover(seed_rbeg + o, seed_len + o, k);
    const long long wm = wq < wr ? wq : wr;
    const int wt = wm > (1 << 30) - 1 ? (1 << 30) - 1 : (int)wm;
    ws[c] = wt;
    const bool heavy = wt >= min_chain_weight;
    const int key = heavy ? wt : -1;
    n_heavy += heavy;
    int j = c;                           // insertion, ties stay in order
    while (j > 0 && at(W, j - 1) < key) {
      ord[j] = ord[j - 1];
      at(W, j) = at(W, j - 1);
      --j;
    }
    ord[j] = c;
    at(W, j) = key;
    ++steps;
  }
  for (int c = nch; c < C; ++c) {
    ws[c] = 0;
    ord[c] = c;
  }
  for (int j = 0; j < C; ++j) kp[j] = 0;
  for (int j = 0; j < n_heavy; ++j) {
    const int s = ord[j];
    int k = ns[s] - 1;
    k = k < 0 ? 0 : (k >= S ? S - 1 : k);
    const size_t o = row + (size_t)s * S;
    const int rid = rd[s];
    at(QB, j) = seed_qbeg[o];
    at(QE, j) = seed_qbeg[o + k] + seed_len[o + k];
    at(ALT, j) = rid >= 0 && g.is_alt[rid];
    at(FIRST, j) = -1;
  }

  // the overlap loop
  if (n_heavy > 0) kp[0] = 3;
  for (int i = 1; i < n_heavy; ++i) {
    const int bi = at(QB, i), ei = at(QE, i), wi = at(W, i);
    const bool alt_i = at(ALT, i);
    bool large = false, drop = false;
    for (int j = 0; j < i; ++j) {
      ++steps;
      if (kp[j] <= 0 || (at(ALT, j) && !alt_i)) continue;
      const int bj = at(QB, j), ej = at(QE, j);
      const int b_max = bj > bi ? bj : bi, e_min = ej < ei ? ej : ei;
      const int min_l = ej - bj < ei - bi ? ej - bj : ei - bi;
      if (e_min <= b_max || min_l >= max_chain_gap
          || !((double)(e_min - b_max) >= (double)min_l * mask_level))
        continue;
      large = true;                      // significant
      if (at(FIRST, j) < 0) at(FIRST, j) = i;
      const int wj = at(W, j);
      if ((double)wi < (double)wj * drop_ratio
          && wj - wi >= (min_seed_len << 1)) {
        drop = true;                     // the first dominating j
        break;
      }
    }
    kp[i] = drop ? 0 : (large ? 2 : 3);
  }
  // chains named by a kept chain's first are kept = 1, in index order
  for (int i = 0; i < n_heavy; ++i) {
    const int f = at(FIRST, i);
    if (kp[i] > 0 && f >= 0) kp[f] = 1;
  }
  // cap the kept == 1 or 2 chains
  int r12 = 0;
  for (int i = 0; i < n_heavy; ++i) {
    const int k = kp[i];
    if ((k == 1 || k == 2) && ++r12 >= max_chain_extend) kp[i] = 0;
  }

  // frac_rep over the (m, n)-sorted SMEMs
  int cnt = sm_cnt[b];
  cnt = cnt < 0 ? 0 : (cnt > M ? M : cnt);
  const size_t sm = (size_t)b * M;
  int fb = 0, fe = 0, l_rep = 0;
  for (int i = 0; i < cnt; ++i) {
    if (sm_s[sm + i] <= max_occ) continue;
    const int sb = sm_m[sm + i], se = sm_n[sm + i] + 1;
    if (sb > fe) {
      l_rep += fe - fb;
      fb = sb;
      fe = se;
    } else if (se > fe) {
      fe = se;
    }
  }
  l_rep += fe - fb;
  const int len = lens[b];
  frac_rep[b] = (float)l_rep / (float)(len > 1 ? len : 1);
  steps_out[b] = steps;
}

}  // namespace

// Launch chain_seeds_kernel on `stream` over B reads; returns
// cudaGetLastError() (0 on success), cudaErrorInvalidValue for a shape
// it cannot take. The caller allocates every buffer (the seed planes
// [4][B][C][S] zeroed) and checks devices and types; nothing here
// synchronises.
extern "C" int chain_seeds_launch(const void* offsets, const void* is_alt,
                                  int n_seqs, long long l_pac,
                                  const void* rbeg, const void* seed_idx,
                                  const void* coord_valid, const void* sm_m,
                                  const void* sm_n, int B, int NC, int M,
                                  int w, int max_chain_gap, int C, int S,
                                  void* key, void* slot, void* n,
                                  void* rid, void* n_seeds, void* seeds,
                                  void* overflow, void* steps,
                                  void* stream) {
  if (B <= 0) return 0;
  if (n_seqs <= 0 || NC <= 0 || M <= 0 || C <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  const Bns g{(const int64_t*)offsets, (const uint8_t*)is_alt, n_seqs,
              l_pac};
  chain_seeds_kernel<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0,
                       (cudaStream_t)stream>>>(
      g, (const int32_t*)rbeg, (const int32_t*)seed_idx,
      (const uint8_t*)coord_valid, (const int32_t*)sm_m, (const int32_t*)sm_n, B,
      NC, M, w, max_chain_gap, C, S, (int32_t*)key, (int32_t*)slot,
      (int32_t*)n, (int32_t*)rid, (int32_t*)n_seeds, (int32_t*)seeds,
      (uint8_t*)overflow, (int32_t*)steps);
  return (int)cudaGetLastError();
}

// Launch chain_filter_kernel on `stream` over B reads (the scratch
// [5][C][B] int32); the return and the caller's duties as
// chain_seeds_launch.
extern "C" int chain_filter_launch(const void* offsets, const void* is_alt,
                                   int n_seqs, long long l_pac, int B, int C,
                                   int S, const void* n_chains,
                                   const void* rid, const void* n_seeds,
                                   const void* seed_qbeg,
                                   const void* seed_rbeg,
                                   const void* seed_len,
                                   int min_chain_weight, double mask_level,
                                   int max_chain_gap, double drop_ratio,
                                   int min_seed_len, int max_chain_extend,
                                   const void* sm_m, const void* sm_n,
                                   const void* sm_s, const void* sm_cnt,
                                   int M, const void* lens, int max_occ,
                                   void* scratch, void* order, void* kept,
                                   void* w_slot, void* frac_rep,
                                   void* steps, void* stream) {
  if (B <= 0) return 0;
  if (n_seqs <= 0 || C <= 0 || S <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const Bns g{(const int64_t*)offsets, (const uint8_t*)is_alt, n_seqs,
              l_pac};
  chain_filter_kernel<<<(B + BLOCK - 1) / BLOCK, BLOCK, 0,
                        (cudaStream_t)stream>>>(
      g, B, C, S, (const int32_t*)n_chains, (const int32_t*)rid,
      (const int32_t*)n_seeds, (const int32_t*)seed_qbeg,
      (const int32_t*)seed_rbeg, (const int32_t*)seed_len, min_chain_weight,
      mask_level, max_chain_gap, drop_ratio, min_seed_len,
      max_chain_extend, (const int32_t*)sm_m, (const int32_t*)sm_n,
      (const int32_t*)sm_s, (const int32_t*)sm_cnt, M, (const int32_t*)lens,
      max_occ, (int32_t*)scratch, (int32_t*)order, (int32_t*)kept,
      (int32_t*)w_slot, (float*)frac_rep, (int32_t*)steps);
  return (int)cudaGetLastError();
}
