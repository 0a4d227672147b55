// The EMF perfect-match probe for Hopper (sm_90a): one warp a read.
//
// Replaces bwa_mem_scale_tpu/ops/emf.py:89 emf_lookup (its multi-location
// rescue jax.lax.while_loop, :200, included) and computes the same
// function as the plain version, ops/emf.py::emf_lookup, value for value:
//   has_n      any code >= 4 in the read's first min(len, L) columns;
//   too_short  len < S (the seed length);
//   fwle       the seed fw = clip(codes[:S], 0, 3) is lexicographically
//              <= its reverse complement (ties: true); the canonical
//              seed is the smaller;
//   h          h = S, then h = fmix64((h ^ word) * MG) over the canonical
//              seed's big-endian 2-bit words of 32 bases; fp = h >> 32;
//   probe      slots (h + j) & (ncap - 1), j < max_probe, live up to the
//              first empty one (loc < 0); the first live slot whose
//              fingerprint matches is the candidate;
//   check      forward: loc + len <= l_pac and ref[loc + i] == codes[i]
//              for i < min(len, L); reverse: pos_rc = loc - (len - S) >= 0
//              and ref[pos_rc + i] == 3 - clip(codes[len - 1 - i]); each
//              position clamped into [0, 2 l_pac) as ops/occ.ref_byte
//              clamps it, the column clamped into [0, L);
//   rescue     a read with a candidate, len > S, no N, neither check
//              passed and a multi-location entry scans the entry's list
//              ml_locs[lo:hi] in order, each entry's orientation
//              fwless[slot] != fwle, flipped past the forward sublist
//              (ml_nfw); the first entry that checks wins;
//   outputs    code (0 short, 1 N, 2 miss, 3 fw, 4 rc), slot (the
//              candidate's, else the first probed one), loc (the match,
//              else -1), n_loc (cnt[slot] with a candidate, else 0).
// Every read is hashed, probed and checked whatever its code, as in the
// plain version: a too-short read from its padded columns, a read with an
// N with N clipped to 3.
//
// Layout: codes [B, L] int32 row-major, lens [B] int32, ref [2 l_pac]
// uint8 fw+rc bytes (both position layouts keep it; bases 0-3), the
// table's loc and list entries int64, fp the uint32 fingerprints as int32
// bits, cnt and mlidx int32, fwless uint8, ml_off int64 [nml + 1], ml_nfw
// int32. Warp w of the grid owns read w; no read length is assumed.
//
// What bounds it: the probe is a chain of dependent global trips with
// next to no arithmetic, and each trip on a genome-scale table misses the
// 50 MB L2, so the bytes bound (the codes, 12 bytes a probed slot and 9
// a candidate, the windows, the outputs over 3.35 TB/s) sits far below
// the latency floor: the longest read's dependent trips x one HBM trip.
// So no round of the read or of a window waits on an __any_sync of an
// earlier one, and the kernel makes the three trips the function needs:
// 1. the read: every lane issues all of its ceil(L / 32) column loads at
//    once (no exit between rounds) and stages the codes and their reverse
//    complement into shared memory as bytes; has_n, fwle and the hash
//    come from there;
// 2. the probe: each probed slot's loc, fp, cnt, mlidx and fwless in the
//    same round, 32 slots a round (a second round only where the first 32
//    slots hold neither a candidate nor an empty slot);
// 3. the windows: the forward and the reverse window in one round, lanes
//    0-15 on the forward one, 16-31 on the reverse, each lane one 16-byte
//    load of the reference a chunk (a byte at a time, clamped into [0, 2
//    l_pac) as ops/occ.ref_byte clamps, only where a chunk crosses the
//    reference's ends), compared a word at a time with no exit between
//    chunks; the rescue list's offsets ride with this trip.
// A read through the rescue makes two more trips a group of entries: the
// group's list entries, then their windows, several entries at a time
// across the lanes (8 lanes an entry up to 113 columns); the first entry
// in list order that checks wins, as in the plain version. A warp a read
// stays: at 101 bp a warp's trips are the same three whether it owns one
// read or several, and several reads a warp would serialise their
// windows' chunks. ops/emf_cuda.py::emf_lookup_twin follows these rounds
// and counts the trips; phase 11 of chip_smoke.py takes its floor from
// that count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                  // reads (warps) a block
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_MAX = 232448;       // a block's shared memory
constexpr size_t SMEM_DEFAULT = 49152;
constexpr unsigned long long M1 = 0xFF51AFD7ED558CCDull;
constexpr unsigned long long M2 = 0xC4CEB9FE1A85EC53ull;
constexpr unsigned long long MG = 0x9E3779B97F4A7C15ull;
enum { NO_TABLE, WITH_N, NOT_MATCHED, FW_MATCHED, RC_MATCHED };

struct Table {
  const long long* loc;        // [ncap]
  const int32_t* fp;           // [ncap]
  const int32_t* cnt;          // [ncap]
  const uint8_t* fwless;       // [ncap]
  const int32_t* mlidx;        // [ncap]
  const long long* ml_off;     // [nml + 1]
  const int32_t* ml_nfw;       // [nml]
  const long long* ml_locs;    // [n_locs]
  long long ncap, n_locs, l_pac;
  int seed_len, max_probe;
};

__device__ __forceinline__ unsigned long long fmix64(unsigned long long k) {
  k ^= k >> 33;
  k *= M1;
  k ^= k >> 33;
  k *= M2;
  k ^= k >> 33;
  return k;
}

__device__ __forceinline__ int clip3(int c) {
  return c < 0 ? 0 : (c > 3 ? 3 : c);
}

// a code as the staged byte: the N test (>= 4), the clip and the compare
// with a reference base (0-3) all read the same from it
__device__ __forceinline__ int8_t code_byte(int c) {
  return (int8_t)(c < 0 ? -1 : (c > 5 ? 5 : c));
}

// bytes of shared memory a warp stages its read in: the codes and their
// reverse complement, L bytes each rounded up to 16, each with 32 bytes
// of padding before and after (a window's chunk reads up to 19 bytes past
// its start, which may lie 15 before column 0 or up to L - 1)
__host__ __device__ __forceinline__ size_t read_bytes(int L) {
  return 2 * (((size_t)L + 15) & ~(size_t)15) + 96;
}

// Whether this lane's chunks of a window hold a mismatch: the window is
// ref[start + i] against w[i] (the staged codes, or their reverse
// complement) for i < n; its 16-byte aligned chunks ci = c0, c0 + step,
// ... A chunk inside [0, l2) of an aligned reference is one 16-byte load,
// any other byte by byte with ops/occ.ref_byte's clamp; it is compared a
// word at a time (__vcmpne4) against the read's bytes at the same
// offset, the bytes outside [0, n) masked off.
__device__ __forceinline__ bool window_bad(const uint8_t* ref, long long l2,
                                           bool aligned, const uint8_t* w,
                                           int n, long long start, int c0,
                                           int step) {
  if (n <= 0) return false;
  const long long first = start & ~15ll;
  const int nc = (int)((((start + n - 1) & ~15ll) - first) >> 4) + 1;
  bool bad = false;
  for (int ci = c0; ci < nc; ci += step) {
    const long long a = first + 16ll * ci;
    const int off = (int)(a - start);            // in [-15, n)
    union { uint4 v; uint32_t x[4]; uint8_t b[16]; } r;
    if (aligned && a >= 0 && a + 16 <= l2) {
      r.v = __ldg(reinterpret_cast<const uint4*>(ref + a));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const long long p = a + j < 0 ? 0 : (a + j > l2 - 1 ? l2 - 1 : a + j);
        r.b[j] = __ldg(ref + p);
      }
    }
    const uintptr_t at = reinterpret_cast<uintptr_t>(w + off);
    const uint32_t* ww = reinterpret_cast<const uint32_t*>(at & ~(uintptr_t)3);
    const unsigned sh = 8 * (unsigned)(at & 3);
    uint32_t e[5];
#pragma unroll
    for (int k = 0; k < 5; ++k) e[k] = ww[k];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int lo = -(off + 4 * k), hi = off + 4 * k + 4 - n;
      const int l0 = lo < 0 ? 0 : lo, h0 = hi < 0 ? 0 : hi;
      const uint32_t mask = (l0 >= 4 || h0 >= 4) ? 0u
          : (0xffffffffu << (8 * l0)) & (0xffffffffu >> (8 * h0));
      const uint32_t want = __funnelshift_r(e[k], e[k + 1], sh);
      bad |= (__vcmpne4(r.x[k], want) & mask) != 0;
    }
  }
  return bad;
}

__global__ void __launch_bounds__(WARPS * 32)
emf_lookup_kernel(const int32_t* __restrict__ codes,   // [B, L]
                  const int32_t* __restrict__ lens,    // [B]
                  int B, int L, const uint8_t* __restrict__ ref, Table t,
                  int32_t* __restrict__ out_code,
                  int32_t* __restrict__ out_slot,
                  long long* __restrict__ out_loc,
                  int32_t* __restrict__ out_nloc) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int b = blockIdx.x * (blockDim.x >> 5) + w;
  if (b >= B) return;                              // whole warps only
  uint8_t* base = reinterpret_cast<uint8_t*>(smem) + read_bytes(L) * w;
  int8_t* q = reinterpret_cast<int8_t*>(base + 32);   // the codes
  uint8_t* rq = base + 64 + ((L + 15) & ~15);          // reverse complement
  const int32_t* row = codes + (size_t)b * L;
  const int len = lens[b];
  const int n = len < 0 ? 0 : (len > L ? L : len);   // in-length columns
  const int S = t.seed_len;
  const long long l2 = 2 * t.l_pac;
  const bool aligned = ((uintptr_t)ref & 15) == 0;

  // trip 1: the read, four rounds of loads before any is used
  bool nf = false;
  for (int c0 = 0; c0 < L; c0 += 128) {
    int v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c0 + 32 * u + lane;
      v[u] = i < L ? __ldg(row + i) : 4;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = c0 + 32 * u + lane;
      if (i < L) q[i] = code_byte(v[u]);
      nf |= i < n && v[u] >= 4;
    }
  }
  const bool has_n = __any_sync(FULL, nf);
  const bool too_short = len < S;
  __syncwarp();
  for (int i = lane; i < L; i += 32) {
    int k = len - 1 - i;
    k = k < 0 ? 0 : (k > L - 1 ? L - 1 : k);
    rq[i] = (uint8_t)(3 - clip3(q[k]));
  }
  __syncwarp();

  // orientation: the first column where the seed and its reverse
  // complement differ (S <= L, checked by the wrapper)
  bool fwle = true, decided = false;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int i = c0 + lane;
    int f = 0, r = 0;
    if (i < S) {
      f = clip3(q[i]);
      r = 3 - clip3(q[S - 1 - i]);
    }
    const unsigned d = __ballot_sync(FULL, i < S && f != r);
    if (d && !decided) {
      fwle = __shfl_sync(FULL, f < r, __ffs(d) - 1);
      decided = true;
    }
  }

  // pack and hash: lane t holds base 32w + t of word w at bit 2(31 - t)
  unsigned long long h = (unsigned long long)S;
  for (int wd = 0; wd * 32 < S; ++wd) {
    const int i = wd * 32 + lane;
    unsigned v = 0;
    if (i < S)
      v = fwle ? (unsigned)clip3(q[i]) : (unsigned)(3 - clip3(q[S - 1 - i]));
    const unsigned hi =
        __reduce_or_sync(FULL, lane < 16 ? v << (2 * (15 - lane)) : 0u);
    const unsigned lo =
        __reduce_or_sync(FULL, lane >= 16 ? v << (2 * (31 - lane)) : 0u);
    const unsigned long long word = ((unsigned long long)hi << 32) | lo;
    h = fmix64((h ^ word) * MG);
  }
  const unsigned fpq = (unsigned)(h >> 32);

  // trip 2: linear probe, 32 slots a round, every field of a slot at once
  const unsigned long long mask = (unsigned long long)(t.ncap - 1);
  bool has_cand = false;
  long long slot = (long long)(h & mask);           // the first probed slot
  long long loc = 0;
  int cnt = 0, mli = -1, fwl = 0;
  for (int r0 = 0; r0 < t.max_probe; r0 += 32) {
    const int j = r0 + lane;
    const long long s = (long long)((h + (unsigned long long)j) & mask);
    long long lj = -1;
    unsigned fj = 0;
    int cj = 0, mj = -1, wj = 0;
    if (j < t.max_probe) {
      lj = __ldg(t.loc + s);
      fj = (unsigned)__ldg(t.fp + s);
      cj = __ldg(t.cnt + s);
      mj = __ldg(t.mlidx + s);
      wj = __ldg(t.fwless + s);
    }
    const unsigned empty = __ballot_sync(FULL, j < t.max_probe && lj < 0);
    unsigned cand =
        __ballot_sync(FULL, j < t.max_probe && lj >= 0 && fj == fpq);
    if (empty) cand &= (1u << (__ffs(empty) - 1)) - 1;   // live slots only
    if (cand) {
      const int src = __ffs(cand) - 1;
      has_cand = true;
      slot = __shfl_sync(FULL, s, src);
      loc = __shfl_sync(FULL, lj, src);
      cnt = __shfl_sync(FULL, cj, src);
      mli = __shfl_sync(FULL, mj, src);
      fwl = __shfl_sync(FULL, wj, src);
      break;
    }
    if (empty) break;
  }

  // trip 3: both windows at the candidate in one round, the rescue
  // list's offsets beside them
  bool fwm = false, rcm = false;
  const long long pos_rc = loc - (long long)(len - S);
  const bool rescue_ok =
      has_cand && len > S && !has_n && !too_short && mli >= 0;
  long long lo = 0, hi = 0, nfw = 0;
  if (rescue_ok) {
    lo = __ldg(t.ml_off + mli);
    hi = __ldg(t.ml_off + mli + 1);
    nfw = __ldg(t.ml_nfw + mli);
  }
  if (has_cand) {
    const bool okf = loc + len <= t.l_pac, okr = pos_rc >= 0;
    const bool rev = lane >= 16;
    const bool ok = rev ? okr : okf;
    const bool bad = ok && window_bad(ref, l2, aligned,
                                      rev ? rq : (const uint8_t*)q, n,
                                      rev ? pos_rc : loc, lane & 15, 16);
    const unsigned bm = __ballot_sync(FULL, bad);
    fwm = okf && !(bm & 0xffffu);
    rcm = okr && !(bm >> 16);
  }

  // the multi-location rescue: the entry's list in the reference's order,
  // a group of entries a trip, then their windows side by side
  if (rescue_ok && !fwm && !rcm) {
    const long long nfw_end = lo + nfw;
    const bool is_rev0 = (fwl != 0) != fwle;
    const int cpw = (n + 30) >> 4;                 // chunks a window
    const int lpe = cpw <= 8 ? 8 : (cpw <= 16 ? 16 : 32);
    const int G = 32 / lpe;                        // entries a group
    const int e = lane / lpe;
    for (long long e0 = lo; e0 < hi; e0 += G) {
      long long my = 0;
      if (lane < G && e0 + lane < hi) {
        long long cc = e0 + lane;
        cc = cc < 0 ? 0 : (cc > t.n_locs - 1 ? t.n_locs - 1 : cc);
        my = __ldg(t.ml_locs + cc);
      }
      const long long loc_c = __shfl_sync(FULL, my, e);
      const long long c = e0 + e;
      const bool isrev = c < nfw_end ? is_rev0 : !is_rev0;
      const long long posr = loc_c - (long long)(len - S);
      const bool okb = c < hi && (isrev ? posr >= 0 : loc_c + len <= t.l_pac);
      const bool bad = !okb || window_bad(ref, l2, aligned,
                                          isrev ? rq : (const uint8_t*)q, n,
                                          isrev ? posr : loc_c, lane % lpe,
                                          lpe);
      const unsigned bm = __ballot_sync(FULL, bad);
      const unsigned emask = lpe == 32 ? FULL : (1u << lpe) - 1;
      int win = -1;
      for (int g = 0; g < G && win < 0; ++g)
        if (!((bm >> (g * lpe)) & emask)) win = g;
      if (win >= 0) {
        loc = __shfl_sync(FULL, loc_c, win * lpe);
        if (__shfl_sync(FULL, (int)isrev, win * lpe))
          rcm = true;
        else
          fwm = true;
        break;
      }
    }
  }

  if (lane == 0) {
    out_code[b] = too_short ? NO_TABLE
                : has_n     ? WITH_N
                : fwm       ? FW_MATCHED
                : rcm       ? RC_MATCHED
                            : NOT_MATCHED;
    out_slot[b] = (int32_t)slot;
    out_loc[b] = (fwm || rcm) ? loc : -1;
    out_nloc[b] = has_cand ? cnt : 0;
  }
}

}  // namespace

extern "C" int emf_lookup_launch(
    const void* codes, const void* lens, int B, int L, const void* ref,
    long long l_pac, const void* loc, const void* fp, const void* cnt,
    const void* fwless, const void* mlidx, const void* ml_off,
    const void* ml_nfw, const void* ml_locs, long long ncap,
    long long n_locs, int seed_len, int max_probe, void* out_code,
    void* out_slot, void* out_loc, void* out_nloc, void* stream) {
  if (B <= 0) return 0;
  if (L < seed_len || seed_len < 1 || max_probe < 1 || ncap < 1
      || (ncap & (ncap - 1)) || n_locs < 1 || l_pac < 1)
    return (int)cudaErrorInvalidValue;
  const Table t{(const long long*)loc, (const int32_t*)fp,
                (const int32_t*)cnt, (const uint8_t*)fwless,
                (const int32_t*)mlidx, (const long long*)ml_off,
                (const int32_t*)ml_nfw, (const long long*)ml_locs,
                ncap, n_locs, l_pac, seed_len, max_probe};
  const size_t per = read_bytes(L);
  if (per > SMEM_MAX) return (int)cudaErrorInvalidValue;
  const int wpb = per * WARPS <= SMEM_MAX ? WARPS : (int)(SMEM_MAX / per);
  const size_t bytes = per * wpb;
  if (bytes > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        emf_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  emf_lookup_kernel<<<(B + wpb - 1) / wpb, wpb * 32, bytes,
                      (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const int32_t*)lens, B, L,
      (const uint8_t*)ref, t, (int32_t*)out_code, (int32_t*)out_slot,
      (long long*)out_loc, (int32_t*)out_nloc);
  return (int)cudaGetLastError();
}
