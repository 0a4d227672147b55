// Seed chaining and the chain filter for Hopper (sm_90a): one warp a
// read, the read's chain state in dynamic shared memory, each read's whole
// walk in one launch, no host synchronisation inside. Two kernels:
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
// the TPU's one-hot selects are not ported (a GPU indexes its own rows
// directly).
//
// What bounds them on this card: on the 4.6 Mbp batch, chain_seeds'
// bytes (its [4, B, C, S] seed planes, 16.8 MB at the main path's
// shapes, each element written once by the kernel: no fill outside it);
// on reads from repeats (hundreds of coordinates, tens of chains), the
// longest read's chain of dependent rounds: every coordinate's
// test_and_merge waits on the state the one before left, and every
// overlap test of the filter on the chains kept before it. The design
// keeps that chain in shared memory and short:
// - a warp a read, one warp a block (1 to 8 reads a block measured
//   within 3% of each other on the H100, PERF.md section 6), so a read's
//   C-wide loops run 32 entries a step and every global row of the read
//   is read or written coalesced;
// - the chain state by slot in dynamic shared memory (7 words a chain
//   for either kernel), so no step waits on an L2 trip for state the
//   warp itself wrote;
// - the per-coordinate work that needs no chain state (the SMEM row, the
//   contig search, the lower chain) done 32 coordinates at once, one a
//   lane, the next 32 coordinates' loads in flight meanwhile.
// Each read reports its `steps` (chain_seeds: coordinates walked;
// chain_filter: live chains weighed plus overlap tests, as the one-thread
// design counted them) and its `rounds`: the warp's dependent steps, each
// a shared-memory or global trip the next step waits on (listed below
// for each kernel). The latency floor is the longest read's rounds x the
// cost of a round measured on the card (csrc/round_probe.cu: a dependent
// shared-memory load, a shuffle and a ballot; chip_smoke.py).
//
// ---- chain_seeds_kernel
// One warp walks a read's coordinates in order while coord_valid[b, c]
// holds (the coordinates come in SMEM order, then interval order, and
// valid ones are a prefix of the row, ops/sal.py::expand_and_lookup, so
// the walk ends at the first invalid one), 32 at a time (a stage): a
// ballot over coord_valid finds where the prefix ends, and lane l
// computes its coordinate's seed: the SMEM index clamped to [0, M - 1],
// the query begin and length from the SMEM, and rid by bns_intv2rid (-1
// past l_pac or for a span over two contigs, -2 for a span over the
// strands' junction; a seed with rid < 0 is skipped). The reference
// keeps the chains in a B-tree by anchor (the first seed's rbeg) and
// tests a seed against the chain of the last anchor <= rbeg; the
// one-thread design kept the anchors as a sorted array, each new one
// after those equal to it. Slots are handed out in that same order of
// insertion, so that chain is the live slot of the largest (anchor,
// slot) with anchor <= rbeg: lane l finds its seed's lower chain at the
// stage's start, a pass over the n live anchors, and only the n live
// slots count (an anchor is never the empty-key marker BIG = 2^29 - 1,
// which a reverse-strand rbeg reaches once l_pac passes ~268 Mbp). Then
// the stage's seeds are tested side by side, each lane its own against
// the same shared-memory state: test_and_merge (src/bwamem.cpp:379-421),
// where a contained seed merges, a colinear one appends (or sets the
// overflow flag when the chain holds S seeds), and any other starts a
// new chain in slot n (or sets the flag when n = C). The seeds before
// the first one that appends or starts a chain are final: a merge by
// containment or an overflow leaves the state as it was, so each saw
// the state the serial walk would show it. That seed is committed (new
// chain: every later lane whose rbeg its anchor does not pass, and whose
// lower anchor it reaches, takes it as its lower chain, the new slot
// being the largest), and the rest are tested again. The state by slot:
// rid, the seed count, the first seed (q, r; r is the anchor) and the
// last seed (q, r, len); the lockstep reads the last seed at index
// clamp(n_seeds - 1, 0, S - 1), which is n_seeds - 1 for every live slot
// (a chain starts at one seed and grows only below S), so the last
// appended seed is that seed. A seed goes to the four [B, C, S] planes
// (qbeg, rbeg, len, score = len) when it is made, one plane a lane. At
// the end the warp writes the sorted [B, C] rows, each live slot at its
// rank (the anchors smaller than its own, plus the equal anchors of
// earlier slots; keys compared 32 a shuffle round; key BIG and slot 0
// past n), rid (-1 past n) and n_seeds (0 past n) by slot, and zeroes
// the plane positions no seed wrote (s >= n_seeds of each slot, all of
// the slots past n), so each output element is written once. Rounds: 2
// for the first stage's loads (the coordinates, then the SMEM rows they
// name; later stages' are loaded one and two stages ahead), 1 a stage
// for the contig search, ceil(n / 32) a stage for the lower chains, 1 a
// test of the stage's seeds, and ceil(n / 32)^2 for the ranks.
// Capacities C and S are launch arguments, so every retry tier (64/32,
// 256/64, 1024/256) takes the same code.
//
// ---- chain_filter_kernel
// One warp a read. Weights: lanes over the live slots, each running its
// slot's two int64 coverage scans (query, reference) over its seeds, 8
// seeds' loads at a time, the smaller clamped to 2^30 - 1; slots at n
// and past hold no seeds and weigh 0. Order: slots under
// min_chain_weight take key -1, and a live slot's sorted position is
// #{live slots with a larger key} + #{earlier live slots with the same
// key} (keys compared 32 a shuffle round); the empty
// slots follow in slot order. This is the stable argsort over all C
// positions the plain version takes, since no live key falls below -1 (a
// weight is a sum of seed lengths). The sorted positions' query span,
// key, alt flag, first overlap and kept value live in shared memory. The
// serial overlap loop over sorted positions i in [1, n_heavy) tests the
// kept j < i in order: j is significant when the query spans overlap by
// at least min_l * mask_level (in double, as the JAX package promotes the
// product to float64) with min_l < max_chain_gap and alt_j implying
// alt_i; dominating when also w_i < w_j * drop_ratio (double) and w_j -
// w_i >= 2 * min_seed_len; every significant j up to the first
// dominating one, j*, records i as its first if it has none, and i is
// dropped at j*. Only "kept" depends on earlier rows, so the loop runs in
// blocks of 32 rows in two phases. A: lane l takes row i0 + l and builds
// its 32-bit words of the significant and of the dominating j < i, kept
// or not (j 32 a shuffle round); the words of the block's rows go to
// shared memory. B: the rows in order, lane l over words 32 c + l of the
// row, with the kept and first-set bits of those words in its registers
// (c < 7: C up to 7,168): j* is the lowest set bit of the first word
// whose dominating bits, masked by kept, are non-zero (a ballot); the
// significant kept bits up to j* not yet first-set record i; i's kept
// bit is set unless j* exists. This is the serial loop's result because
// kept[j] for j < i is final when i is tested and each first write
// touches its own j; its steps grow by j* + 1, or by i when nothing
// dominates (the serial loop's visited j). Then kept chains pass kept = 1
// to the chain their first names; the serial pass goes in index order,
// and a chain it revives (0 -> 1) was dropped in the overlap loop, so its
// first is unset: the pass runs 32 at a time. Last, the kept == 1 or 2
// chains past max_chain_extend are cut by an inclusive prefix count, 32
// a ballot. frac_rep: the read's SMEMs staged 32 at a time, a ballot over
// s > max_occ, and the serial union scan over those (broadcast by
// shuffles), its length over the read length in float, as the plain
// version divides. Rounds: 2 a chunk of live slots (their seed counts,
// then their seeds), a chunk of live slots' ranks 1 a chunk of keys plus
// 1 for their sorted fields, 1 a block's word of phase A, 1 a row's
// chunk of words of phase B, 1 a chunk of each of the two kept passes and
// 1 a chunk of SMEMs.
//
// ---- the int64 forms
// Each kernel is a template on its position type P: int (the code above,
// unchanged) or long long, for an index of 2^31 positions or more (hg38)
// or one forced to the int64 layout (ops/occ.py); the launch functions
// ending in 64 launch them, and replace the same JAX loops at pos_dtype
// int64. What widens: rbeg, the keys, the seeds' rbeg plane (the int32
// form's [4][B][C][S] planes become qbeg, len and score [3][B][C][S]
// int32 and rbeg [B][C][S] int64), the first and last seeds' r in the
// chain state (9 words a chain: FR and LR 64-bit, at the front of shared
// memory; 64.8 KB at C = 1,800), and the SMEM sizes frac_rep reads; the
// filter's shared state holds no position and keeps its size. The lower
// chain's search compares 64-bit keys (a shuffle of a long long is two)
// with four running maxima of (key, slot) kept as pairs, since a 64-bit
// key and a slot no longer pack into one word; the slots arrive in
// increasing order, so a key not below a maximum's replaces it. The empty
// key is the type's maximum // 4 (2^61 - 1 at int64), which no position
// reaches.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BIG = 0x7fffffff / 4;        // the empty key, int32 max // 4
constexpr unsigned SIGN = 0x80000000u;     // an int32's sign bit
// the empty key of a position type: its maximum // 4
template <typename P>
__host__ __device__ constexpr P big_key() {
  return sizeof(P) == 4 ? (P)BIG : (P)(0x7fffffffffffffffLL / 4);
}
// shared memory a read takes, in 4-byte words: chain_seeds 7 a chain
// (rid, n_seeds, first q r, last q r len; 9 at int64, whose r are two
// words each); chain_filter 7 a chain (key by slot; QB QE W ALT FIRST kept
// by sorted position) and 64 a 32 chains (a block of 32 rows' two bit
// masks), at either position type
constexpr int SEEDS_WORDS_A_CHAIN = 7;
template <typename P>
__host__ __device__ constexpr size_t seeds_words(int C) {
  return (size_t)(SEEDS_WORDS_A_CHAIN + 2 * (sizeof(P) / 4 - 1)) * C;
}
__host__ __device__ constexpr size_t filter_words(int C) {
  return (size_t)7 * C + (size_t)64 * ((C + 31) / 32);
}
// chunks of 32 words of 32 positions that the filter keeps a row's kept
// and first-set bits in, a word a lane: C up to 7,168
constexpr int WORD_CHUNKS = 7;
// the shared memory a block can take on Hopper (227 KB, dynamic only
// past the 48 KB default)
constexpr size_t SMEM_MAX = 232448;
constexpr size_t SMEM_DEFAULT = 49152;

struct Bns {
  const int64_t* offsets;                  // [n_seqs] contig offsets
  const uint8_t* is_alt;                   // [n_seqs]
  int n_seqs;
  int top;                                 // the largest power of 2 <= n_seqs
  long long l_pac;
};

Bns make_bns(const void* offsets, const void* is_alt, int n_seqs,
             long long l_pac) {
  int top = 1;
  while (2 * top <= n_seqs) top *= 2;
  return Bns{(const int64_t*)offsets, (const uint8_t*)is_alt, n_seqs, top,
             l_pac};
}

// bns_depos: the forward-strand position of pos
__device__ __forceinline__ long long depos(const Bns& g, long long pos) {
  return pos >= g.l_pac ? 2 * g.l_pac - 1 - pos : pos;
}

// bns_intv2rid of [rb, re): -2 over the strands' junction; else the
// contig of each end's forward position (bns_pos2rid: the last contig
// whose offset is <= it, -1 at and past l_pac), -1 when they differ. Both
// ends' upper-bound searches run side by side in the same fixed steps
// for every lane (no branch), the offsets on the read-only path (L1).
template <typename P>
__device__ int intv2rid(const Bns& g, P rb, P re) {
  const long long pb = depos(g, rb), pe = depos(g, rb < re ? re - 1 : rb);
  int nb = 0, ne = 0;                      // offsets <= pb, <= pe
  for (int step = g.top; step > 0; step >>= 1) {
    const int ib = nb + step, ie = ne + step;
    const int64_t ob = __ldg(g.offsets + (ib < g.n_seqs ? ib : g.n_seqs) - 1);
    const int64_t oe = __ldg(g.offsets + (ie < g.n_seqs ? ie : g.n_seqs) - 1);
    nb += (ib <= g.n_seqs) & (ob <= pb) ? step : 0;
    ne += (ie <= g.n_seqs) & (oe <= pe) ? step : 0;
  }
  const int rid_b = pb >= g.l_pac ? -1 : nb - 1;
  const int rid_e = pe >= g.l_pac ? -1 : ne - 1;
  const int rid = rid_b == rid_e ? rid_b : -1;
  return rb < g.l_pac && re > g.l_pac ? -2 : rid;
}

template <typename P>
__global__ void __launch_bounds__(WARP)
chain_seeds_kernel(Bns g, const P* __restrict__ rbeg,         // [B, NC]
                   const int32_t* __restrict__ seed_idx,       // [B, NC]
                   const uint8_t* __restrict__ coord_valid,    // [B, NC]
                   const int32_t* __restrict__ sm_m,           // [B, M]
                   const int32_t* __restrict__ sm_n,           // [B, M]
                   int B, int NC, int M, int w, int max_chain_gap, int C,
                   int S,
                   P* __restrict__ key,              // [B, C]
                   int32_t* __restrict__ slot,       // [B, C]
                   int32_t* __restrict__ n_out,      // [B]
                   int32_t* __restrict__ rid_t,      // [B, C]
                   int32_t* __restrict__ n_seeds,    // [B, C]
                   int32_t* __restrict__ seeds,      // [4][B][C][S], or
                                                     // [3][B][C][S] at int64
                   uint8_t* __restrict__ overflow,   // [B]
                   int32_t* __restrict__ steps_out,  // [B]
                   int32_t* __restrict__ rounds_out,  // [B]
                   P* __restrict__ seed_rbeg) {      // [B][C][S] at int64
  constexpr bool W64 = sizeof(P) == 8;
  extern __shared__ int32_t smem[];
  const int l = threadIdx.x, b = blockIdx.x;
  // by slot: rid, seed count, first seed (q, r: r is the key), last seed
  // (q, r, len); at int64 the two r arrays first, 8-byte aligned
  int32_t *RD, *NS, *FQ, *LQ, *LL;
  P *FR, *LR;
  if constexpr (W64) {
    FR = reinterpret_cast<P*>(smem);
    LR = FR + C;
    RD = reinterpret_cast<int32_t*>(LR + C);
    NS = RD + C;
    FQ = NS + C;
    LQ = FQ + C;
    LL = LQ + C;
  } else {
    RD = smem;
    NS = RD + C;
    FQ = NS + C;
    FR = FQ + C;
    LQ = FR + C;
    LR = LQ + C;
    LL = LR + C;
  }
  const size_t plane = (size_t)B * C * S;
  int32_t* sq = seeds + (size_t)b * C * S;        // [C][S] of plane 0
  P* sr = W64 ? seed_rbeg + (size_t)b * C * S : nullptr;
  const int32_t* m = sm_m + (size_t)b * M;
  const int32_t* e = sm_n + (size_t)b * M;
  const P* rb_row = rbeg + (size_t)b * NC;
  const int32_t* si_row = seed_idx + (size_t)b * NC;
  const uint8_t* valid = coord_valid + (size_t)b * NC;
  // lane p < 4 writes plane p of a seed: qbeg, rbeg, len, score = len (at
  // int64 lanes 0-2 the int32 planes qbeg, len, score, lane 3 rbeg)
  auto put = [&](int at, int q, P r, int len) {
    if constexpr (W64) {
      if (l < 3) sq[l * plane + at] = l == 0 ? q : len;
      else if (l == 3) sr[at] = r;
    } else {
      if (l < 4) sq[l * plane + at] = l == 0 ? q : (l == 1 ? r : len);
    }
  };
  int n = 0, steps = 0, rounds = 0;
  bool of = false;
  // slot 0's state is read (and its result masked) by seeds with no
  // lower chain, before any chain starts there: zeros, not junk
  if constexpr (W64) {
    FR[0] = LR[0] = 0;
    RD[0] = NS[0] = FQ[0] = LQ[0] = LL[0] = 0;
  } else {
    for (int k = 0; k < SEEDS_WORDS_A_CHAIN; ++k) RD[k * C] = 0;
  }
  // lane l's coordinate, loaded two chunks ahead, and its SMEM row, one
  // chunk ahead: the loads only, so nothing waits on them until they are
  // used (the first chunk's loads wait: 2 rounds)
  auto coord = [&](int c, int& v, P& r, int& si) {
    const bool in = c < NC;
    v = in ? valid[c] : 0;
    r = in ? rb_row[c] : 0;
    si = in ? si_row[c] : 0;
  };
  auto clamp_m = [&](int si) { return si < 0 ? 0 : (si >= M ? M - 1 : si); };
  int v0, v1, si0, si1;
  P r0, r1;
  coord(l, v0, r0, si0);
  coord(WARP + l, v1, r1, si1);
  int q0 = m[clamp_m(si0)], e0 = e[clamp_m(si0)];
  rounds += 2;
  for (int c0 = 0; c0 < NC; c0 += WARP) {
    const bool v = v0 != 0;
    const P my_rbeg = r0;
    const int my_qbeg = q0, my_len = e0 + 1 - q0;
    v0 = v1;                             // the next chunk, and the one after
    r0 = r1;
    q0 = m[clamp_m(si1)];
    e0 = e[clamp_m(si1)];
    coord(c0 + 2 * WARP + l, v1, r1, si1);
    const int my_rid = v ? intv2rid(g, my_rbeg, my_rbeg + my_len) : -1;
    const unsigned vm = __ballot_sync(FULL, v);
    const int cnt = vm == FULL ? WARP : __ffs(~vm) - 1;
    ++rounds;                            // the contig search
    // lane l's lower chain: the live slot of the largest (key, slot) with
    // key <= rbeg, the last of those keys in the sorted order; the keys
    // 32 a shuffle round, four running maxima of the packed pair (the key
    // with its sign bit flipped, which keeps the order, then slot + 1;
    // 0 for none) so that no step waits on the one before; at int64 the
    // maxima are (key, slot + 1) pairs
    int low;
    P low_key;
    if constexpr (W64) {
      P bk[4] = {0, 0, 0, 0};
      int bs[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < n; k0 += WARP) {
        const P theirs = k0 + l < n ? FR[k0 + l] : 0;
#pragma unroll
        for (int t = 0; t < WARP; ++t) {
          const P k = __shfl_sync(FULL, theirs, t);
          const bool take = (k <= my_rbeg) & (k0 + t < n)
                            & ((bs[t & 3] == 0) | (k >= bk[t & 3]));
          bk[t & 3] = take ? k : bk[t & 3];
          bs[t & 3] = take ? k0 + t + 1 : bs[t & 3];
        }
      }
      P kk = bk[0];
      int ss = bs[0];
#pragma unroll
      for (int i = 1; i < 4; ++i) {
        const bool more = (bs[i] != 0)
                          & ((ss == 0) | (bk[i] > kk)
                             | ((bk[i] == kk) & (bs[i] > ss)));
        kk = more ? bk[i] : kk;
        ss = more ? bs[i] : ss;
      }
      low = ss - 1;
      low_key = kk;
    } else {
      unsigned long long best[4] = {0, 0, 0, 0};
      for (int k0 = 0; k0 < n; k0 += WARP) {
        const int theirs = k0 + l < n ? FR[k0 + l] : 0;
#pragma unroll
        for (int t = 0; t < WARP; ++t) {
          const int k = __shfl_sync(FULL, theirs, t);
          const unsigned long long cand =
              (k <= my_rbeg) & (k0 + t < n)
                  ? (unsigned long long)((unsigned)k ^ SIGN) << 32
                        | (unsigned)(k0 + t + 1)
                  : 0;
          best[t & 3] = cand > best[t & 3] ? cand : best[t & 3];
        }
      }
      const unsigned long long top =
          max(max(best[0], best[1]), max(best[2], best[3]));
      low = (int)(top & 0xffffffff) - 1;
      low_key = (int)((unsigned)(top >> 32) ^ SIGN);
    }
    rounds += (n + WARP - 1) / WARP;
    // the chunk's seeds side by side: each seed not yet final is tested
    // against the current state; those before the first that would change
    // it (an append, a new chain) are final, since a merge by containment,
    // a full chain or a missing slot leaves the state as it was; that
    // seed is committed, and the rest are tested again
    for (int done = 0; done < cnt;) {
      // every test evaluated, the lower chain's state read from slot 0
      // when there is none: no branch
      const bool tested = (l >= done) & (l < cnt) & (my_rid >= 0);
      const bool has_low = low >= 0;
      const int ls = has_low ? low : 0;
      const int ln = NS[ls];
      const int last_q = LQ[ls], last_len = LL[ls], first_q = FQ[ls];
      const P last_r = LR[ls], first_r = FR[ls];
      const bool same_rid = has_low & (my_rid == RD[ls]);
      const bool contained = same_rid & (my_qbeg >= first_q)
                             & (my_qbeg + my_len <= last_q + last_len)
                             & (my_rbeg >= first_r)
                             & (my_rbeg + my_len <= last_r + last_len);
      const bool diff_strand =
          ((last_r < g.l_pac) | (first_r < g.l_pac)) & (my_rbeg >= g.l_pac);
      const int x = my_qbeg - last_q;
      const P y = my_rbeg - last_r;
      const bool growable = same_rid & !contained & !diff_strand
                            & (y >= 0) & (x - y <= w) & (y - x <= w)
                            & (x - last_len < max_chain_gap)
                            & (y - last_len < max_chain_gap);
      const bool fresh = !(contained | growable);  // a new chain, if any
      // 1 append, 2 new chain; a full chain or no free slot: overflow
      const int act = !tested ? 0
                      : growable ? (ln < S ? 1 : 0)
                                 : (fresh & (n < C) ? 2 : 0);
      const bool my_of =
          tested & ((growable & (ln >= S)) | (fresh & (n >= C)));
      ++rounds;
      const unsigned changes = __ballot_sync(FULL, act != 0);
      const int f = changes ? __ffs(changes) - 1 : cnt;
      if (__ballot_sync(FULL, my_of && l < f)) of = true;
      if (f >= cnt) break;
      const P s_rbeg = __shfl_sync(FULL, my_rbeg, f);
      const int s_qbeg = __shfl_sync(FULL, my_qbeg, f);
      const int s_len = __shfl_sync(FULL, my_len, f);
      // every lane stores every state word itself (the same values), so
      // a lane reads only its own stores, and every lane's test read the
      // state before the ballot let any lane on: no __syncwarp
      if (__shfl_sync(FULL, act, f) == 1) {      // seed f appends
        const int to = __shfl_sync(FULL, low, f);
        const int f_ln = __shfl_sync(FULL, ln, f);
        put(to * S + f_ln, s_qbeg, s_rbeg, s_len);
        NS[to] = f_ln + 1;
        LQ[to] = s_qbeg;
        LR[to] = s_rbeg;
        LL[to] = s_len;
      } else {                           // seed f starts a chain in slot n
        put(n * S, s_qbeg, s_rbeg, s_len);
        RD[n] = __shfl_sync(FULL, my_rid, f);
        NS[n] = 1;
        FQ[n] = LQ[n] = s_qbeg;
        FR[n] = LR[n] = s_rbeg;
        LL[n] = s_len;
        // the largest slot yet: the lower chain of every later seed
        // whose rbeg it does not pass, unless a larger key is
        if (s_rbeg <= my_rbeg && (low < 0 || s_rbeg >= low_key)) {
          low = n;
          low_key = s_rbeg;
        }
        ++n;
      }
      done = f + 1;
    }
    steps = c0 + cnt;
    if (cnt < WARP) break;
  }
  // the [B, C] rows: slot c at its rank among the live keys (ascending,
  // equal keys in slot order, which is the order they were inserted in)
  const size_t row = (size_t)b * C;
  for (int c0 = 0; c0 < n; c0 += WARP) {
    const int c = c0 + l;
    const P mine = c < n ? FR[c] : 0;
    int r = 0;
    for (int c1 = 0; c1 < n; c1 += WARP) {
      const P theirs = c1 + l < n ? FR[c1 + l] : 0;
      const int t_end = n - c1 < WARP ? n - c1 : WARP;
      for (int t = 0; t < t_end; ++t) {
        const P kk = __shfl_sync(FULL, theirs, t);
        r += kk < mine || (kk == mine && c1 + t < c);
      }
      ++rounds;
    }
    if (c < n) {
      key[row + r] = mine;
      slot[row + r] = c;
    }
  }
  for (int c = l; c < C; c += WARP) {
    const bool live = c < n;
    if (!live) {
      key[row + c] = big_key<P>();
      slot[row + c] = 0;
    }
    rid_t[row + c] = live ? RD[c] : -1;
    n_seeds[row + c] = live ? NS[c] : 0;
  }
  // zero the plane positions no seed wrote; where S is a multiple of 4,
  // 16 bytes a store (a slot's row then starts 16-byte aligned; at int64
  // the rbeg plane's 4 positions are 32 bytes, two stores), the positions
  // before the first whole 16 bytes past n_seeds one by one
  auto zero = [&](size_t at) {
    sq[at] = 0;
    sq[plane + at] = 0;
    sq[2 * plane + at] = 0;
    if constexpr (W64) sr[at] = 0;
    else sq[3 * plane + at] = 0;
  };
  if (S % 4 == 0) {
    const int S4 = S / 4;
    const int4 z = make_int4(0, 0, 0, 0);
    for (int e4 = l; e4 < C * S4; e4 += WARP) {
      const int c = e4 / S4, s0 = 4 * (e4 - c * S4);
      const int ns = c < n ? NS[c] : 0;
      const size_t at = (size_t)c * S + s0;
      if (s0 >= ns) {
        for (int p = 0; p < (W64 ? 3 : 4); ++p)
          *reinterpret_cast<int4*>(sq + p * plane + at) = z;
        if constexpr (W64) {
          reinterpret_cast<int4*>(sr + at)[0] = z;
          reinterpret_cast<int4*>(sr + at)[1] = z;
        }
      } else {
        for (int s = ns; s < s0 + 4; ++s) zero((size_t)c * S + s);
      }
    }
  } else {
    for (int c = 0; c < C; ++c) {
      const int ns = c < n ? NS[c] : 0;
      for (int s = ns + l; s < S; s += WARP) zero((size_t)c * S + s);
    }
  }
  if (l == 0) {
    n_out[b] = n;
    overflow[b] = of;
    steps_out[b] = steps;
    rounds_out[b] = rounds;
  }
}

// one seed of a coverage scan (int64): the length it adds past `end`
__device__ __forceinline__ void cover_step(long long& end, long long& sum,
                                           long long bb, long long ll) {
  sum += bb >= end ? ll : (bb + ll > end ? bb + ll - end : 0);
  end = bb + ll > end ? bb + ll : end;
}

// a slot's two coverage weights over its k seeds (query, reference), the
// seeds loaded 8 at a time so that their loads wait together
template <typename P>
__device__ __forceinline__ void weigh(const int32_t* qb, const P* rb,
                                      const int32_t* len, int k,
                                      long long& wq, long long& wr) {
  long long eq = 0, er = 0;
  wq = wr = 0;
  for (int i0 = 0; i0 < k; i0 += 8) {
    int q[8], ln[8];
    P r[8];
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      const bool in = i0 + t < k;
      q[t] = in ? qb[i0 + t] : 0;
      r[t] = in ? rb[i0 + t] : 0;
      ln[t] = in ? len[i0 + t] : 0;
    }
#pragma unroll
    for (int t = 0; t < 8; ++t) {
      if (i0 + t < k) {
        cover_step(eq, wq, q[t], ln[t]);
        cover_step(er, wr, r[t], ln[t]);
      }
    }
  }
}

template <typename P>
__global__ void __launch_bounds__(WARP)
chain_filter_kernel(Bns g, int C, int S,
                    const int32_t* __restrict__ n_chains,  // [B]
                    const int32_t* __restrict__ rid_t,     // [B, C]
                    const int32_t* __restrict__ n_seeds,   // [B, C]
                    const int32_t* __restrict__ seed_qbeg,  // [B, C, S]
                    const P* __restrict__ seed_rbeg,        // [B, C, S]
                    const int32_t* __restrict__ seed_len,   // [B, C, S]
                    int min_chain_weight, double mask_level,
                    int max_chain_gap, double drop_ratio, int min_seed_len,
                    int max_chain_extend,
                    const int32_t* __restrict__ sm_m,       // [B, M]
                    const int32_t* __restrict__ sm_n,       // [B, M]
                    const P* __restrict__ sm_s,             // [B, M]
                    const int32_t* __restrict__ sm_cnt,     // [B]
                    int M, const int32_t* __restrict__ lens,  // [B]
                    int max_occ,
                    int32_t* __restrict__ order,      // [B, C]
                    int32_t* __restrict__ kept,       // [B, C]
                    int32_t* __restrict__ w_slot,     // [B, C]
                    float* __restrict__ frac_rep,     // [B]
                    int32_t* __restrict__ steps_out,  // [B]
                    int32_t* __restrict__ rounds_out) {  // [B]
  extern __shared__ int32_t smem[];
  const int l = threadIdx.x, b = blockIdx.x;
  const int Q = (C + WARP - 1) / WARP;    // 32-bit words over C positions
  int32_t* KEY = smem;                   // by slot
  int32_t* QB = KEY + C;                 // by sorted position
  int32_t* QE = QB + C;
  int32_t* W = QE + C;
  int32_t* ALT = W + C;
  int32_t* FIRST = ALT + C;
  int32_t* KP = FIRST + C;
  // a block of 32 rows' bits of the significant and the dominating j < i
  unsigned* SIGM = (unsigned*)(KP + C);  // [32][Q]
  unsigned* DOMM = SIGM + WARP * Q;      // [32][Q]
  int nch = n_chains[b];
  nch = nch < 0 ? 0 : (nch > C ? C : nch);
  const int32_t* ns = n_seeds + (size_t)b * C;
  const int32_t* rd = rid_t + (size_t)b * C;
  const size_t row = (size_t)b * C * S;
  int32_t* ord = order + (size_t)b * C;
  int32_t* kp = kept + (size_t)b * C;
  int32_t* ws = w_slot + (size_t)b * C;
  int steps = nch, rounds = 0;

  // weights by slot, a lane a slot; the empty slots keep their place
  int n_heavy = 0;
  for (int c0 = 0; c0 < C; c0 += WARP) {
    const int c = c0 + l;
    bool heavy = false;
    if (c < nch) {
      int k = ns[c];
      k = k < 0 ? 0 : (k > S ? S : k);
      const size_t o = row + (size_t)c * S;
      long long wq, wr;
      weigh(seed_qbeg + o, seed_rbeg + o, seed_len + o, k, wq, wr);
      const long long wm = wq < wr ? wq : wr;
      const int wt = wm > (1 << 30) - 1 ? (1 << 30) - 1 : (int)wm;
      ws[c] = wt;
      heavy = wt >= min_chain_weight;
      KEY[c] = heavy ? wt : -1;
    } else if (c < C) {
      ws[c] = 0;
      ord[c] = c;
    }
    n_heavy += __popc(__ballot_sync(FULL, heavy));
    if (c0 < nch) rounds += 2;
  }
  __syncwarp();
  // the stable order by rank, and the sorted positions' fields
  for (int c0 = 0; c0 < nch; c0 += WARP) {
    const int c = c0 + l;
    const int mine = c < nch ? KEY[c] : 0;
    int r = 0;
    for (int c1 = 0; c1 < nch; c1 += WARP) {
      const int theirs = c1 + l < nch ? KEY[c1 + l] : 0;
      const int t_end = nch - c1 < WARP ? nch - c1 : WARP;
      for (int t = 0; t < t_end; ++t) {
        const int kk = __shfl_sync(FULL, theirs, t);
        r += kk > mine || (kk == mine && c1 + t < c);
      }
      ++rounds;
    }
    ++rounds;
    if (c < nch) {
      ord[r] = c;
      if (r < n_heavy) {
        int k = ns[c] - 1;
        k = k < 0 ? 0 : (k >= S ? S - 1 : k);
        const size_t o = row + (size_t)c * S;
        const int rid = rd[c];
        QB[r] = seed_qbeg[o];
        QE[r] = seed_qbeg[o + k] + seed_len[o + k];
        W[r] = mine;
        ALT[r] = rid >= 0 && g.is_alt[rid];
        FIRST[r] = -1;
      }
    }
  }
  // the kept (> 0) and first-set bits of positions 32 q .. 32 q + 31,
  // word q = 32 c + l in lane l's kw[c] and fs[c]
  unsigned kw[WORD_CHUNKS], fs[WORD_CHUNKS];
#pragma unroll
  for (int c = 0; c < WORD_CHUNKS; ++c) {
    kw[c] = c == 0 && l == 0 && n_heavy > 0;   // position 0 is kept (3)
    fs[c] = 0;
  }
  if (n_heavy > 0) KP[0] = 3;            // every lane stores the same
  __syncwarp();

  // the overlap loop, a block of 32 rows (sorted positions) at a time
  for (int i0 = 0; i0 < n_heavy; i0 += WARP) {
    const int i_end = i0 + WARP < n_heavy ? i0 + WARP : n_heavy;
    // lane l's row i0 + l: its bits of the significant j < i (the query
    // spans overlap by min_l * mask_level, in double, min_l <
    // max_chain_gap, alt_j implies alt_i) and of the dominating ones
    // (also w_i < w_j * drop_ratio in double and w_j - w_i >= 2 *
    // min_seed_len), whether or not j is kept; j 32 a shuffle round
    {
      const int i = i0 + l;
      int bi = 0, ei = 0, wi = 0, ai = 0;
      if (i < n_heavy) {
        bi = QB[i];
        ei = QE[i];
        wi = W[i];
        ai = ALT[i];
      }
      for (int q = 0; q * WARP < i_end - 1; ++q) {
        const int jl = q * WARP + l;
        int bj = 0, ej = 0, wj = 0, aj = 0;
        if (jl < n_heavy) {
          bj = QB[jl];
          ej = QE[jl];
          wj = W[jl];
          aj = ALT[jl];
        }
        unsigned sig = 0, dom = 0;
#pragma unroll 4
        for (int t = 0; t < WARP; ++t) {
          const int j = q * WARP + t;
          const int bt = __shfl_sync(FULL, bj, t);
          const int et = __shfl_sync(FULL, ej, t);
          const int wt = __shfl_sync(FULL, wj, t);
          const int at = __shfl_sync(FULL, aj, t);
          const int b_max = bt > bi ? bt : bi, e_min = et < ei ? et : ei;
          const int min_l = et - bt < ei - bi ? et - bt : ei - bi;
          // every test evaluated (& in place of &&): no branch
          const bool s_ij = (j < i) & !(at & !ai) & (e_min > b_max)
                            & (min_l < max_chain_gap)
                            & ((double)(e_min - b_max)
                               >= (double)min_l * mask_level);
          const bool d_ij = s_ij & ((double)wi < (double)wt * drop_ratio)
                            & (wt - wi >= (min_seed_len << 1));
          sig |= (unsigned)s_ij << t;
          dom |= (unsigned)d_ij << t;
        }
        SIGM[l * Q + q] = sig;
        DOMM[l * Q + q] = dom;
        ++rounds;
      }
    }
    __syncwarp();
    // the block's rows in order, lanes over the words of j < i: j* is the
    // lowest dominating kept j; the significant kept j <= j* whose first
    // is unset record i; i is dropped if j* exists. Nothing here waits on
    // shared memory but the masks, the next row's first chunk of them
    // loaded while this row is tested
    const int i_first = i0 > 0 ? i0 : 1;
    unsigned d_next = 0, s_next = 0;
    if (i_first < i_end && l < (i_first + WARP - 1) / WARP) {
      d_next = DOMM[(i_first - i0) * Q + l];
      s_next = SIGM[(i_first - i0) * Q + l];
    }
    for (int i = i_first; i < i_end; ++i) {
      const int r = i - i0, Qi = (i + WARP - 1) / WARP;
      const unsigned d0 = d_next, s0 = s_next;
      d_next = s_next = 0;
      if (i + 1 < i_end && l < (i + WARP) / WARP) {
        d_next = DOMM[(r + 1) * Q + l];
        s_next = SIGM[(r + 1) * Q + l];
      }
      int jstar = -1;
      bool large = false;
#pragma unroll
      for (int c = 0; c < WORD_CHUNKS; ++c) {
        if (c * WARP >= Qi) break;
        const int q = c * WARP + l;
        unsigned d = 0, sm = 0;
        if (c == 0) {
          d = d0;
          sm = s0;
        } else if (q < Qi) {
          d = DOMM[r * Q + q];
          sm = SIGM[r * Q + q];
        }
        d &= kw[c];
        sm &= kw[c];
        const unsigned dq = __ballot_sync(FULL, d != 0);
        if (dq) {                        // lanes past j* see nothing
          const int qs = __ffs(dq) - 1;
          const int bit = __ffs(__shfl_sync(FULL, d, qs)) - 1;
          jstar = (c * WARP + qs) * WARP + bit;
          sm = l < qs ? sm : (l == qs ? sm & ((2u << bit) - 1) : 0);
        }
        large |= __ballot_sync(FULL, sm != 0) != 0;
        unsigned fresh = sm & ~fs[c];    // the firsts no row set yet
        fs[c] |= fresh;
        for (; fresh; fresh &= fresh - 1)
          FIRST[q * WARP + __ffs(fresh) - 1] = i;
        ++rounds;
        if (dq) break;
      }
      const int k = jstar >= 0 ? 0 : (large ? 2 : 3);
      steps += jstar >= 0 ? jstar + 1 : i;
      KP[i] = k;                         // every lane stores the same
      const int wq = i / WARP;           // i's kept bit: word wq
#pragma unroll
      for (int c = 0; c < WORD_CHUNKS; ++c)
        if (k > 0 && c * WARP + l == wq) kw[c] |= 1u << (i % WARP);
    }
    __syncwarp();                        // the masks, for the next block
  }
  // chains named by a kept chain's first are kept = 1
  for (int i0 = 0; i0 < n_heavy; i0 += WARP) {
    const int i = i0 + l;
    const int f = i < n_heavy && KP[i] > 0 ? FIRST[i] : -1;
    __syncwarp();
    if (f >= 0) KP[f] = 1;
    __syncwarp();
    ++rounds;
  }
  // cap the kept == 1 or 2 chains: an inclusive prefix count
  int r12 = 0;
  for (int i0 = 0; i0 < n_heavy; i0 += WARP) {
    const int i = i0 + l;
    const int k = i < n_heavy ? KP[i] : 0;
    const bool is12 = k == 1 || k == 2;
    const unsigned m12 = __ballot_sync(FULL, is12);
    if (is12 && r12 + __popc(m12 & ((2u << l) - 1)) >= max_chain_extend)
      KP[i] = 0;
    r12 += __popc(m12);
    ++rounds;
  }
  __syncwarp();
  for (int j = l; j < C; j += WARP) kp[j] = j < n_heavy ? KP[j] : 0;

  // frac_rep over the (m, n)-sorted SMEMs
  int cnt = sm_cnt[b];
  cnt = cnt < 0 ? 0 : (cnt > M ? M : cnt);
  const size_t sm = (size_t)b * M;
  int fb = 0, fe = 0, l_rep = 0;
  for (int i0 = 0; i0 < cnt; i0 += WARP) {
    const int i = i0 + l;
    int sb = 0, se = 0;
    const bool over = i < cnt && sm_s[sm + i] > max_occ;
    if (over) {
      sb = sm_m[sm + i];
      se = sm_n[sm + i] + 1;
    }
    ++rounds;
    for (unsigned om = __ballot_sync(FULL, over); om; om &= om - 1) {
      const int t = __ffs(om) - 1;
      const int tb = __shfl_sync(FULL, sb, t), te = __shfl_sync(FULL, se, t);
      if (tb > fe) {
        l_rep += fe - fb;
        fb = tb;
        fe = te;
      } else if (te > fe) {
        fe = te;
      }
    }
  }
  l_rep += fe - fb;
  if (l == 0) {
    const int len = lens[b];
    frac_rep[b] = (float)l_rep / (float)(len > 1 ? len : 1);
    steps_out[b] = steps;
    rounds_out[b] = rounds;
  }
}

// Raise a kernel's dynamic shared memory limit past the 48 KB default
// when `bytes` needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= SMEM_DEFAULT) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename P>
int chain_seeds_launch_t(const Bns& g, const void* rbeg, const void* seed_idx,
                         const void* coord_valid, const void* sm_m,
                         const void* sm_n, int B, int NC, int M, int w,
                         int max_chain_gap, int C, int S, void* key,
                         void* slot, void* n, void* rid, void* n_seeds,
                         void* seeds, void* overflow, void* steps,
                         void* rounds, void* seed_rbeg, void* stream) {
  if (B <= 0) return 0;
  const size_t bytes = 4 * seeds_words<P>(C);
  if (g.n_seqs <= 0 || NC <= 0 || M <= 0 || C <= 0 || S <= 0
      || bytes > SMEM_MAX || (sizeof(P) == 8 && seed_rbeg == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(chain_seeds_kernel<P>, bytes);
  if (err != cudaSuccess) return (int)err;
  chain_seeds_kernel<P><<<B, WARP, bytes, (cudaStream_t)stream>>>(
      g, (const P*)rbeg, (const int32_t*)seed_idx,
      (const uint8_t*)coord_valid, (const int32_t*)sm_m,
      (const int32_t*)sm_n, B, NC, M, w, max_chain_gap, C, S, (P*)key,
      (int32_t*)slot, (int32_t*)n, (int32_t*)rid, (int32_t*)n_seeds,
      (int32_t*)seeds, (uint8_t*)overflow, (int32_t*)steps,
      (int32_t*)rounds, (P*)seed_rbeg);
  return (int)cudaGetLastError();
}

template <typename P>
int chain_filter_launch_t(const Bns& g, int B, int C, int S,
                          const void* n_chains, const void* rid,
                          const void* n_seeds, const void* seed_qbeg,
                          const void* seed_rbeg, const void* seed_len,
                          int min_chain_weight, double mask_level,
                          int max_chain_gap, double drop_ratio,
                          int min_seed_len, int max_chain_extend,
                          const void* sm_m, const void* sm_n,
                          const void* sm_s, const void* sm_cnt, int M,
                          const void* lens, int max_occ, void* order,
                          void* kept, void* w_slot, void* frac_rep,
                          void* steps, void* rounds, void* stream) {
  if (B <= 0) return 0;
  const size_t bytes = 4 * filter_words(C);
  if (g.n_seqs <= 0 || C <= 0 || S <= 0 || M <= 0 || bytes > SMEM_MAX
      || C > WORD_CHUNKS * WARP * WARP)
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = allow_smem(chain_filter_kernel<P>, bytes);
  if (err != cudaSuccess) return (int)err;
  chain_filter_kernel<P><<<B, WARP, bytes, (cudaStream_t)stream>>>(
      g, C, S, (const int32_t*)n_chains, (const int32_t*)rid,
      (const int32_t*)n_seeds, (const int32_t*)seed_qbeg,
      (const P*)seed_rbeg, (const int32_t*)seed_len, min_chain_weight,
      mask_level, max_chain_gap, drop_ratio, min_seed_len,
      max_chain_extend, (const int32_t*)sm_m, (const int32_t*)sm_n,
      (const P*)sm_s, (const int32_t*)sm_cnt, M, (const int32_t*)lens,
      max_occ, (int32_t*)order, (int32_t*)kept, (int32_t*)w_slot,
      (float*)frac_rep, (int32_t*)steps, (int32_t*)rounds);
  return (int)cudaGetLastError();
}

}  // namespace

// The most chains a read may hold: one read's state in one block's
// shared memory (kernel 0 chain_seeds_kernel, 1 chain_filter_kernel; 2
// and 3 their int64 forms).
extern "C" int chain_max_chains(int kernel) {
  const bool filter = kernel & 1;
  auto words = [&](int C) {
    return filter ? filter_words(C)
                  : kernel == 2 ? seeds_words<long long>(C)
                                : seeds_words<int>(C);
  };
  int C = (int)(SMEM_MAX / (4 * 7));
  while (4 * words(C) > SMEM_MAX
         || (filter && C > WORD_CHUNKS * WARP * WARP))
    --C;
  return C;
}

// Launch chain_seeds_kernel on `stream` over B reads, a one-warp block a
// read; returns cudaGetLastError() (0 on success), cudaErrorInvalidValue
// for a shape it cannot take (C past chain_max_chains(0)). The caller
// allocates every buffer (the kernel writes every element once) and
// checks devices and types; nothing here synchronises.
extern "C" int chain_seeds_launch(const void* offsets, const void* is_alt,
                                  int n_seqs, long long l_pac,
                                  const void* rbeg, const void* seed_idx,
                                  const void* coord_valid, const void* sm_m,
                                  const void* sm_n, int B, int NC, int M,
                                  int w, int max_chain_gap, int C, int S,
                                  void* key, void* slot,
                                  void* n, void* rid, void* n_seeds,
                                  void* seeds, void* overflow, void* steps,
                                  void* rounds, void* stream) {
  return chain_seeds_launch_t<int>(
      make_bns(offsets, is_alt, n_seqs, l_pac), rbeg, seed_idx, coord_valid,
      sm_m, sm_n, B, NC, M, w, max_chain_gap, C, S, key, slot, n, rid,
      n_seeds, seeds, overflow, steps, rounds, nullptr, stream);
}

// chain_seeds_launch's int64 form: rbeg and key int64, seeds the
// [3][B][C][S] int32 planes qbeg, len and score, seed_rbeg the [B][C][S]
// int64 plane (C up to chain_max_chains(2)).
extern "C" int chain_seeds_launch64(const void* offsets, const void* is_alt,
                                    int n_seqs, long long l_pac,
                                    const void* rbeg, const void* seed_idx,
                                    const void* coord_valid,
                                    const void* sm_m, const void* sm_n,
                                    int B, int NC, int M, int w,
                                    int max_chain_gap, int C, int S,
                                    void* key, void* slot, void* n,
                                    void* rid, void* n_seeds, void* seeds,
                                    void* overflow, void* steps,
                                    void* rounds, void* seed_rbeg,
                                    void* stream) {
  return chain_seeds_launch_t<long long>(
      make_bns(offsets, is_alt, n_seqs, l_pac), rbeg, seed_idx, coord_valid,
      sm_m, sm_n, B, NC, M, w, max_chain_gap, C, S, key, slot, n, rid,
      n_seeds, seeds, overflow, steps, rounds, seed_rbeg, stream);
}

// Launch chain_filter_kernel on `stream` over B reads, a one-warp block a
// read; the return and the caller's duties as chain_seeds_launch (C up to
// chain_max_chains(1)).
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
                                   void* order, void* kept, void* w_slot,
                                   void* frac_rep, void* steps, void* rounds,
                                   void* stream) {
  return chain_filter_launch_t<int>(
      make_bns(offsets, is_alt, n_seqs, l_pac), B, C, S, n_chains, rid,
      n_seeds, seed_qbeg, seed_rbeg, seed_len, min_chain_weight, mask_level,
      max_chain_gap, drop_ratio, min_seed_len, max_chain_extend, sm_m, sm_n,
      sm_s, sm_cnt, M, lens, max_occ, order, kept, w_slot, frac_rep, steps,
      rounds, stream);
}

// chain_filter_launch's int64 form: seed_rbeg and sm_s int64.
extern "C" int chain_filter_launch64(
    const void* offsets, const void* is_alt, int n_seqs, long long l_pac,
    int B, int C, int S, const void* n_chains, const void* rid,
    const void* n_seeds, const void* seed_qbeg, const void* seed_rbeg,
    const void* seed_len, int min_chain_weight, double mask_level,
    int max_chain_gap, double drop_ratio, int min_seed_len,
    int max_chain_extend, const void* sm_m, const void* sm_n,
    const void* sm_s, const void* sm_cnt, int M, const void* lens,
    int max_occ, void* order, void* kept, void* w_slot, void* frac_rep,
    void* steps, void* rounds, void* stream) {
  return chain_filter_launch_t<long long>(
      make_bns(offsets, is_alt, n_seqs, l_pac), B, C, S, n_chains, rid,
      n_seeds, seed_qbeg, seed_rbeg, seed_len, min_chain_weight, mask_level,
      max_chain_gap, drop_ratio, min_seed_len, max_chain_extend, sm_m, sm_n,
      sm_s, sm_cnt, M, lens, max_occ, order, kept, w_slot, frac_rep, steps,
      rounds, stream);
}
