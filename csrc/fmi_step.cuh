// The checkpoint-occ step that every FM walk of the port takes, shared by
// csrc/smem.cu (SMEM passes 1-3, the SA walk) and csrc/sweep.cu (the
// position-parallel sweep). ops/nvcc_build.py hashes a source together with
// the headers it includes, so a change here rebuilds both libraries.
//
// The occ step: backward_ext_all4 (ops/occ.py) for both ends of the
// interval, two 32-byte checkpoint rows of cp_fused ([nb, 8] int32: four
// exclusive counts, then four one-hot 32-bp block masks, MSB first), each
// fetched as two 16-byte read-only loads, counted with __popc under the
// top-y-bits mask, with the reference's sentinel correction. `Fmi<P>` holds
// the index at the position type P: int for the int32 layout of
// ops/occ.py, long long for the int64 one, whose rows keep the counts' low
// words and take each base's high word from a step table (csrc/smem.cu's
// note, "the int64 forms"). The C array (count[5]) and sentinel_index are
// launch arguments. Each row index is clamped to [0, nb - 1], as the
// lockstep's gathers clamp theirs.
//
// The k-step (ext_kt, int32 layout only): with a k-gram checkpoint table
// (index/kstep.py; ops/occ.py::kstep_rows lays it out on the device) one
// pair of row fetches extends an interval by KS = 2 or 3 bases
// (ops/occ.py::_two_steps). A row of the table is 32-byte groups: the
// 1-step row (counts1 | masks1, cp_fused's), then for each first base c1
// the bigram counts and masks of (c1, 0..3), then at KS = 3 for each pair
// p = 4 c1 + c2 the trigram counts and masks of (p, 0..3). Each step reads
// one group an end, two 16-byte read-only loads, all issued before any is
// used: 4 loads an end at KS = 2, 6 at KS = 3, the bases known before the
// fetch (the read's). A 1-step on the table is ext_kt<1> (group 0), so a
// launch that holds the table reads no other. Step d takes its C value
// (C, then C2[c1 c2], then C3[c1 c2 c3]: ext_kt takes them from the
// caller, who keeps C2 and C3 in registers (WarpC) or shared memory; ext_k
// loads them and calls ext_kt), its group's occ at the interval's start,
// the group's sizes for the l update above its base, and its own sentinel
// correction on the interval before it (the second on (k1, s1), not on
// (k, s)): pairs whose second step crosses the text start belong to no
// bigram class, and the embedded 1-step counts keep those walks exact.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
// the shared memory a block can take on Hopper (227 KB, dynamic only
// past 48 KB, after cudaFuncAttributeMaxDynamicSharedMemorySize)
constexpr size_t SMEM_MAX = 232448;
constexpr size_t SMEM_DEFAULT = 49152;
// the high-word steps a base may have on the int64 layout (ops/occ.py's
// HI_STEPS)
constexpr int HI_STEPS = 8;

// The index as each form takes it: the checkpoint table ([nb][2] int4:
// counts, masks), the C array and the sentinel row at the form's position
// type; the int64 form also the high-word step table ([4][HI_STEPS] long
// long on the device) and each base's number of steps.
template <typename P>
struct Fmi;

template <>
struct Fmi<int> {
  const int4* cp;
  int nb;
  int c0, c1, c2, c3, c4;            // the C array
  int sentinel;
};

template <>
struct Fmi<long long> {
  const int4* cp;                    // counts' low 32 bits, masks
  long long nb;
  long long c0, c1, c2, c3, c4;
  long long sentinel;
  const long long* hi;               // [4][HI_STEPS] rows where it steps
  int h0, h1, h2, h3;                // steps a base
};

template <typename T>
__device__ __forceinline__ T sel4(T a, T b, T c, T d, int i) {
  return i == 0 ? a : (i == 1 ? b : (i == 2 ? c : d));
}

__device__ __forceinline__ int sel4(const int4& v, int i) {
  return sel4(v.x, v.y, v.z, v.w, i);
}

// the four occ values of the int64 form
struct Occ64 {
  long long x, y, z, w;
};

__device__ __forceinline__ long long sel4(const Occ64& v, int i) {
  return sel4(v.x, v.y, v.z, v.w, i);
}

// C[c] for c in [0, 4]
template <typename P>
__device__ __forceinline__ P cval(const Fmi<P>& f, int c) {
  return c == 4 ? f.c4 : sel4(f.c0, f.c1, f.c2, f.c3, c);
}

// the top y bits of a 32-bit word; a shift by 32 is undefined, so y = 0
// is 0 explicitly
__device__ __forceinline__ unsigned top_bits(int y) {
  return y == 0 ? 0u : 0xffffffffu << (32 - y);
}

// the checkpoint row holding position pp, clamped to [0, nb) at the
// position type's width
template <typename P>
__device__ __forceinline__ P row_of(const Fmi<P>& f, P pp) {
  P r = pp >> 5;                     // arithmetic, as torch's >>
  return r < 0 ? 0 : (r >= f.nb ? f.nb - 1 : r);
}

template <typename P>
__device__ __forceinline__ const int4* cp_row(const Fmi<P>& f, P pp) {
  return f.cp + 2 * (size_t)row_of(f, pp);
}

// the int64 layout's high word of base c's count at row r: its n steps
// at or before r, times 2^32
__device__ __forceinline__ long long hi_word(const Fmi<long long>& f, int c,
                                             int n, long long r) {
  int h = 0;
  for (int j = 0; j < n; ++j) h += r >= __ldg(f.hi + c * HI_STEPS + j);
  return (long long)h << 32;
}

// whether any base's count passes 2^32 (none at hg38): one uniform test
// guards the step-table loops, so an empty table costs a step one branch
__device__ __forceinline__ bool has_steps(const Fmi<long long>& f) {
  return (f.h0 | f.h1 | f.h2 | f.h3) != 0;
}

// a count of row r: the stored word (int32), or on the int64 layout the
// low word with the high word of base c (n steps) above it
__device__ __forceinline__ int row_count(const Fmi<int>&, int v, int, int,
                                         int) {
  return v;
}

__device__ __forceinline__ long long row_count(const Fmi<long long>& f,
                                               int v, int c, int n,
                                               long long r) {
  return (long long)(unsigned)v + (has_steps(f) ? hi_word(f, c, n, r) : 0);
}

// base c's steps: none on the int32 layout
__device__ __forceinline__ int n_steps(const Fmi<int>&, int) { return 0; }

__device__ __forceinline__ int n_steps(const Fmi<long long>& f, int c) {
  return sel4(f.h0, f.h1, f.h2, f.h3, c);
}

// occ(pp, base) for all four bases: one checkpoint row, two 16-byte loads
__device__ __forceinline__ int4 occ4(const Fmi<int>& f, int pp) {
  const int4* row = cp_row(f, pp);
  const int4 cnt = __ldg(row);
  const int4 msk = __ldg(row + 1);
  const unsigned top = top_bits(pp & 31);
  return make_int4(cnt.x + __popc((unsigned)msk.x & top),
                   cnt.y + __popc((unsigned)msk.y & top),
                   cnt.z + __popc((unsigned)msk.z & top),
                   cnt.w + __popc((unsigned)msk.w & top));
}

// The int64 form's occ4 in two halves, so that an occ step issues both
// of its rows' loads before any step-table loop: a loop is a branch, and
// the loads after a branch would wait for the rows before it (two L2
// trips in a row instead of side by side).
struct Row64 {
  long long r;
  int4 cnt, msk;
  unsigned top;
};

__device__ __forceinline__ Row64 load_row(const Fmi<long long>& f,
                                          long long pp) {
  const long long r = row_of(f, pp);
  const int4* row = f.cp + 2 * (size_t)r;
  return Row64{r, __ldg(row), __ldg(row + 1), top_bits((int)(pp & 31))};
}

// a row's occ from its low count words (the high words apart)
__device__ __forceinline__ Occ64 occ_low(const Row64& w) {
  auto one = [&](int v, int m) {
    return (long long)(unsigned)v + __popc((unsigned)m & w.top);
  };
  return Occ64{one(w.cnt.x, w.msk.x), one(w.cnt.y, w.msk.y),
               one(w.cnt.z, w.msk.z), one(w.cnt.w, w.msk.w)};
}

// the high words of a row's four counts, added to its occ
__device__ __forceinline__ void add_hi(const Fmi<long long>& f,
                                       const Row64& w, Occ64& o) {
  o.x += hi_word(f, 0, f.h0, w.r);
  o.y += hi_word(f, 1, f.h1, w.r);
  o.z += hi_word(f, 2, f.h2, w.r);
  o.w += hi_word(f, 3, f.h3, w.r);
}

// The backward extension of (k, l, s) by base c in [0, 3]
// (ops/occ.py::backward_ext_all4, then the base's column).
// occ4's four values in each form
template <typename P>
struct OccOf {
  using T = int4;
};

template <>
struct OccOf<long long> {
  using T = Occ64;
};

// the occ of both ends of (k, k + s): int32 rows as loaded; int64 both
// rows' loads first
__device__ __forceinline__ void occ_pair(const Fmi<int>& f, int k, int e,
                                         int4& a, int4& b) {
  a = occ4(f, k);
  b = occ4(f, e);
}

__device__ __forceinline__ void occ_pair(const Fmi<long long>& f,
                                         long long k, long long e, Occ64& a,
                                         Occ64& b) {
  const Row64 ra = load_row(f, k), rb = load_row(f, e);
  a = occ_low(ra);
  b = occ_low(rb);
  if (has_steps(f)) {
    add_hi(f, ra, a);
    add_hi(f, rb, b);
  }
}

template <typename P>
__device__ __forceinline__ void ext(const Fmi<P>& f, P k, P l, P s, int c,
                                    P& nk, P& nl, P& ns) {
  typename OccOf<P>::T a, b;
  occ_pair(f, k, k + s, a, b);
  const P s0 = b.x - a.x, s1 = b.y - a.y, s2 = b.z - a.z, s3 = b.w - a.w;
  const P sent = (k <= f.sentinel) & (k + s > f.sentinel);
  // l of base c: l + sent + the sizes of the bases above c
  nl = l + sent + (c < 3 ? s3 : 0) + (c < 2 ? s2 : 0) + (c < 1 ? s1 : 0);
  nk = cval(f, c) + sel4(a, c);
  ns = sel4(s0, s1, s2, s3, c);
}

// The k-gram table as the k-step forms take it.
struct Kfmi {
  const int4* cp;                    // [nb][w4] int4 (kstep_rows' layout)
  int nb, w4;                        // rows; int4s a row (10 or 42)
  const int* c2;                     // C2 [16], on the device
  const int* c3;                     // C3 [64] (KS = 3), or null
};

// the four occ values of 32-byte group g of a k-gram row: counts plus the
// popcounts of the masks under the top-y-bits mask
__device__ __forceinline__ int4 occ_group(const int4& cnt, const int4& msk,
                                          unsigned top) {
  return make_int4(cnt.x + __popc((unsigned)msk.x & top),
                   cnt.y + __popc((unsigned)msk.y & top),
                   cnt.z + __popc((unsigned)msk.z & top),
                   cnt.w + __popc((unsigned)msk.w & top));
}

// The backward extension of (k, l, s) by bases c[0], ..., c[KS - 1] (each
// in [0, 3]) from one k-gram row at k and one at k + s: (nk, nl, ns)[d]
// is the interval after d + 1 bases, equal to d + 1 chained ext calls.
// base[d] is step d's C value (C[c1], C2[c1 c2], C3[c1 c2 c3]), which the
// caller keeps off the chain (a warp's registers, WarpC); `sentinel` is
// the index's. Only the first `live` steps' groups are fetched (1 <= live
// <= KS): a caller that takes fewer bases (a backward step, a read's last
// bases) says how many, and reads no result past them.
template <int KS>
__device__ __forceinline__ void ext_kt(const Kfmi& g, int sentinel, int k,
                                       int l, int s, const int (&c)[KS],
                                       const int (&base)[KS], int (&nk)[KS],
                                       int (&nl)[KS], int (&ns)[KS],
                                       int live = KS) {
  auto row = [&](int pp) {
    const int r = pp >> 5;
    return g.cp + (size_t)(r < 0 ? 0 : (r >= g.nb ? g.nb - 1 : r)) * g.w4;
  };
  const int4* ra = row(k);
  const int4* rb = row(k + s);
  int grp[KS];
  grp[0] = 0;
  if constexpr (KS > 1) grp[1] = 1 + c[0];
  if constexpr (KS > 2) grp[KS - 1] = 5 + 4 * c[0] + c[1];
  int4 ac[KS], am[KS], bc[KS], bm[KS];
#pragma unroll
  for (int d = 0; d < KS; ++d) {     // every load before any use
    const int4 z = make_int4(0, 0, 0, 0);
    const bool on = d < live;
    ac[d] = on ? __ldg(ra + 2 * grp[d]) : z;
    am[d] = on ? __ldg(ra + 2 * grp[d] + 1) : z;
    bc[d] = on ? __ldg(rb + 2 * grp[d]) : z;
    bm[d] = on ? __ldg(rb + 2 * grp[d] + 1) : z;
  }
  const unsigned ta = top_bits(k & 31), tb = top_bits((k + s) & 31);
#pragma unroll
  for (int d = 0; d < KS; ++d) {
    const int4 a = occ_group(ac[d], am[d], ta);
    const int4 b = occ_group(bc[d], bm[d], tb);
    const int s0 = b.x - a.x, s1 = b.y - a.y, s2 = b.z - a.z, s3 = b.w - a.w;
    const int e = c[d];
    const int sent = (k <= sentinel) & (k + s > sentinel);
    nl[d] = l + sent + (e < 3 ? s3 : 0) + (e < 2 ? s2 : 0) + (e < 1 ? s1 : 0);
    nk[d] = base[d] + sel4(a, e);
    ns[d] = sel4(s0, s1, s2, s3, e);
    k = nk[d];
    l = nl[d];
    s = ns[d];
  }
}

// ext_kt with the C values loaded beside the rows (C2 and C3 from the
// table's arrays on the device), for a caller that keeps no WarpC.
template <int KS>
__device__ __forceinline__ void ext_k(const Fmi<int>& f, const Kfmi& g,
                                      int k, int l, int s,
                                      const int (&c)[KS], int (&nk)[KS],
                                      int (&nl)[KS], int (&ns)[KS],
                                      int live = KS) {
  int base[KS];
  base[0] = cval(f, c[0]);
  if constexpr (KS > 1)
    base[1] = live > 1 ? __ldg(g.c2 + 4 * c[0] + c[1]) : 0;
  if constexpr (KS > 2)
    base[KS - 1] = live > 2 ? __ldg(g.c3 + 16 * c[0] + 4 * c[1] + c[2]) : 0;
  ext_kt<KS>(g, f.sentinel, k, l, s, c, base, nk, nl, ns, live);
}

// C2 and C3 in a warp's registers, loaded once a launch: lane i holds
// C2[i & 15], C3[i] and C3[32 + i] (C3's zeros at KS = 2). A step's C
// value comes by a shuffle, off the chain of row fetches; the index must
// be the same on every lane, and every lane must take part.
struct WarpC {
  int c2, c3a, c3b;

  __device__ __forceinline__ int C2(int i) const {
    return __shfl_sync(FULL, c2, i);
  }
  __device__ __forceinline__ int C3(int i) const {
    const int lo = __shfl_sync(FULL, c3a, i & 31);
    const int hi = __shfl_sync(FULL, c3b, i & 31);
    return i < 32 ? lo : hi;
  }
};

__device__ __forceinline__ WarpC warp_c(const Kfmi& g, int lane) {
  if (g.cp == nullptr) return WarpC{0, 0, 0};
  const bool c3 = g.c3 != nullptr;
  return WarpC{__ldg(g.c2 + (lane & 15)), c3 ? __ldg(g.c3 + lane) : 0,
               c3 ? __ldg(g.c3 + 32 + lane) : 0};
}

// the C values of KS steps over bases c (each in [0, 3]), every lane alike
template <int KS>
__device__ __forceinline__ void kbases(const Fmi<int>& f, const WarpC& w,
                                       const int (&c)[KS], int (&base)[KS]) {
  base[0] = cval(f, c[0]);
  if constexpr (KS > 1) base[1] = w.C2(4 * c[0] + c[1]);
  if constexpr (KS > 2) base[2] = w.C3(16 * c[0] + 4 * c[1] + c[2]);
}

// Copy n int32 codes from src (4-byte aligned) into dst as bytes,
// threads tid of nthr: the 16-byte aligned body of [src, src + n) as
// int4 loads, the few words before and after it one by one. A code >= 4
// is an N to every walk, so it is stored as 4; with CLIP_LOW a negative
// code is stored as 0 (the readlane machines' clip).
template <bool CLIP_LOW = false>
__device__ __forceinline__ void stage_codes(const int32_t* src, int n,
                                            int8_t* dst, int tid,
                                            int nthr) {
  const int head = min(n, (int)((16 - ((uintptr_t)src & 15)) & 15) >> 2);
  const int n4 = (n - head) >> 2;
  const int4* body = reinterpret_cast<const int4*>(src + head);
  auto put = [&](int i, int v) {
    dst[i] = (int8_t)(v < 4 ? (CLIP_LOW && v < 0 ? 0 : v) : 4);
  };
  for (int i = tid; i < n4; i += nthr) {
    const int4 v = __ldg(body + i);
    const int b = head + 4 * i;
    put(b, v.x);
    put(b + 1, v.y);
    put(b + 2, v.z);
    put(b + 3, v.w);
  }
  for (int i = tid; i < head; i += nthr) put(i, __ldg(src + i));
  for (int i = head + 4 * n4 + tid; i < n; i += nthr) put(i, __ldg(src + i));
}

// bytes of shared memory for L codes, rounded up to 16 (the stacks
// follow them)
__host__ __device__ __forceinline__ size_t codes_bytes(int L) {
  return ((size_t)L + 15) & ~(size_t)15;
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

// The form's index from its launch arguments.
Fmi<int> make_fmi(const void* cp, int nb, int c0, int c1, int c2, int c3,
                  int c4, int sentinel) {
  return Fmi<int>{(const int4*)cp, nb, c0, c1, c2, c3, c4, sentinel};
}

Fmi<long long> make_fmi(const void* cp, long long nb, long long c0,
                        long long c1, long long c2, long long c3,
                        long long c4, long long sentinel, const void* hi,
                        int h0, int h1, int h2, int h3) {
  return Fmi<long long>{(const int4*)cp, nb, c0, c1, c2, c3, c4, sentinel,
                        (const long long*)hi, h0, h1, h2, h3};
}

// The index of a k-step launch that reads the k-gram table alone: the C
// array and the sentinel, no 1-step rows (nb 1 for fmi_ok, cp null).
Fmi<int> c_only(int c0, int c1, int c2, int c3, int c4, int sentinel) {
  return Fmi<int>{nullptr, 1, c0, c1, c2, c3, c4, sentinel};
}

// the k-gram table of a launch at KS bases a fetch
Kfmi make_kfmi(const void* cp, int nb, int w4, const void* c2,
               const void* c3) {
  return Kfmi{(const int4*)cp, nb, w4, (const int*)c2, (const int*)c3};
}

bool kfmi_ok(const Kfmi& g, int ks) {
  return g.cp != nullptr && g.nb > 0 && g.c2 != nullptr
         && ((ks == 2 && g.w4 >= 10) || (ks == 3 && g.w4 == 42
                                         && g.c3 != nullptr));
}

// the index a launch can take: rows, and on the int64 layout a step
// table with 0 to HI_STEPS steps a base
bool fmi_ok(const Fmi<int>& f) { return f.nb > 0; }

bool fmi_ok(const Fmi<long long>& f) {
  auto ok = [](int h) { return h >= 0 && h <= HI_STEPS; };
  return f.nb > 0 && f.hi != nullptr && ok(f.h0) && ok(f.h1) && ok(f.h2)
         && ok(f.h3);
}
}  // namespace
