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
// uint8 fw+rc bytes (both position layouts keep it), the table's loc and
// list entries int64, fp the uint32 fingerprints as int32 bits, cnt and
// mlidx int32, fwless uint8, ml_off int64 [nml + 1], ml_nfw int32. Warp w
// of the grid owns read w; lanes stride over a read's columns 32 at a
// time, so no read length is assumed.
//
// What bounds it: the probe is a chain of dependent global trips (the
// read, the slot rows, the reference window, in a rescue the list's
// offsets and each entry's window) with next to no arithmetic, and each
// trip on a genome-scale table misses the 50 MB L2. So the bytes bound
// (the codes, 12 bytes a probed slot, the windows, the outputs over 3.35
// TB/s) sits far below the latency floor (the longest read's trips x one
// dependent HBM trip). The design keeps each trip one coalesced load of
// the warp: 32 slot rows a round, 32 window columns a round with an early
// exit (__any_sync), the hash in registers from two
// __reduce_or_sync a word. A warp a read leaves lanes idle on 101 bp
// reads; that is for a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;                  // reads (warps) a block
constexpr unsigned FULL = 0xffffffffu;
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

// ops/occ.ref_byte: the position clamped into [0, 2 l_pac)
__device__ __forceinline__ int ref_at(const uint8_t* ref, long long p,
                                      long long l2) {
  p = p < 0 ? 0 : (p > l2 - 1 ? l2 - 1 : p);
  return (int)__ldg(ref + p);
}

// whether ref[start + i] equals the read's column i (rev: its reverse
// complement, 3 - clip(codes[clamp(len - 1 - i, 0, L - 1)])) for every
// i < n, 32 columns a round, stopping at the first round with a mismatch
__device__ bool window_matches(const int32_t* row, int len, int n, int L,
                               const uint8_t* ref, long long start,
                               long long l2, bool rev, int lane) {
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int i = c0 + lane;
    bool bad = false;
    if (i < n) {
      int want;
      if (rev) {
        int k = len - 1 - i;
        k = k < 0 ? 0 : (k > L - 1 ? L - 1 : k);
        want = 3 - clip3(row[k]);
      } else {
        want = row[i];
      }
      bad = ref_at(ref, start + i, l2) != want;
    }
    if (__any_sync(FULL, bad)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(WARPS * 32)
emf_lookup_kernel(const int32_t* __restrict__ codes,   // [B, L]
                  const int32_t* __restrict__ lens,    // [B]
                  int B, int L, const uint8_t* __restrict__ ref, Table t,
                  int32_t* __restrict__ out_code,
                  int32_t* __restrict__ out_slot,
                  long long* __restrict__ out_loc,
                  int32_t* __restrict__ out_nloc) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                              // whole warps only
  const int32_t* row = codes + (size_t)b * L;
  const int len = lens[b];
  const int n = len < 0 ? 0 : (len > L ? L : len);   // in-length columns
  const int S = t.seed_len;
  const long long l2 = 2 * t.l_pac;

  // flags
  bool has_n = false;
  for (int c0 = 0; c0 < n && !has_n; c0 += 32) {
    const int i = c0 + lane;
    has_n = __any_sync(FULL, i < n && row[i] >= 4);
  }
  const bool too_short = len < S;

  // orientation: the first column where the seed and its reverse
  // complement differ (S <= L, checked by the wrapper)
  bool fwle = true;
  for (int c0 = 0; c0 < S; c0 += 32) {
    const int i = c0 + lane;
    int f = 0, r = 0;
    if (i < S) {
      f = clip3(row[i]);
      r = 3 - clip3(row[S - 1 - i]);
    }
    const unsigned d = __ballot_sync(FULL, i < S && f != r);
    if (d) {
      const int src = __ffs(d) - 1;
      fwle = __shfl_sync(FULL, f < r, src);
      break;
    }
  }

  // pack and hash: lane t holds base 32w + t of word w at bit 2(31 - t)
  unsigned long long h = (unsigned long long)S;
  for (int w = 0; w * 32 < S; ++w) {
    const int i = w * 32 + lane;
    unsigned v = 0;
    if (i < S)
      v = fwle ? (unsigned)clip3(row[i])
               : (unsigned)(3 - clip3(row[S - 1 - i]));
    const unsigned hi =
        __reduce_or_sync(FULL, lane < 16 ? v << (2 * (15 - lane)) : 0u);
    const unsigned lo =
        __reduce_or_sync(FULL, lane >= 16 ? v << (2 * (31 - lane)) : 0u);
    const unsigned long long word = ((unsigned long long)hi << 32) | lo;
    h = fmix64((h ^ word) * MG);
  }
  const unsigned fpq = (unsigned)(h >> 32);

  // linear probe, 32 slots a round, to the first candidate or empty slot
  const unsigned long long mask = (unsigned long long)(t.ncap - 1);
  bool has_cand = false;
  long long slot = (long long)(h & mask);           // the first probed slot
  long long loc = 0;
  for (int r0 = 0; r0 < t.max_probe; r0 += 32) {
    const int j = r0 + lane;
    const long long s = (long long)((h + (unsigned long long)j) & mask);
    long long lj = -1;
    unsigned fj = 0;
    if (j < t.max_probe) {
      lj = __ldg(t.loc + s);
      fj = (unsigned)__ldg(t.fp + s);
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
      break;
    }
    if (empty) break;
  }

  // the full read against the reference at the candidate
  bool fwm = false, rcm = false;
  const long long pos_rc = loc - (long long)(len - S);
  if (has_cand) {
    if (loc + len <= t.l_pac)
      fwm = window_matches(row, len, n, L, ref, loc, l2, false, lane);
    if (pos_rc >= 0)
      rcm = window_matches(row, len, n, L, ref, pos_rc, l2, true, lane);
  }

  // the multi-location rescue: the entry's list in the reference's order
  if (has_cand && len > S && !fwm && !rcm && !has_n && !too_short) {
    const int mi = __ldg(t.mlidx + slot);
    if (mi >= 0) {
      const long long lo = __ldg(t.ml_off + mi);
      const long long hi = __ldg(t.ml_off + mi + 1);
      const long long nfw = lo + __ldg(t.ml_nfw + mi);
      const bool is_rev0 = (__ldg(t.fwless + slot) != 0) != fwle;
      for (long long c = lo; c < hi; ++c) {
        const long long cc = c < 0 ? 0 : (c > t.n_locs - 1 ? t.n_locs - 1 : c);
        const long long loc_c = __ldg(t.ml_locs + cc);
        const bool isrev = c < nfw ? is_rev0 : !is_rev0;
        const long long posr = loc_c - (long long)(len - S);
        const bool okb = isrev ? posr >= 0 : loc_c + len <= t.l_pac;
        if (okb && window_matches(row, len, n, L, ref, isrev ? posr : loc_c,
                                  l2, isrev, lane)) {
          if (isrev) rcm = true; else fwm = true;
          loc = loc_c;
          break;
        }
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
    out_nloc[b] = has_cand ? __ldg(t.cnt + slot) : 0;
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
  emf_lookup_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0,
                      (cudaStream_t)stream>>>(
      (const int32_t*)codes, (const int32_t*)lens, B, L,
      (const uint8_t*)ref, t, (int32_t*)out_code, (int32_t*)out_slot,
      (long long*)out_loc, (int32_t*)out_nloc);
  return (int)cudaGetLastError();
}
