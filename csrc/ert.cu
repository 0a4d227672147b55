// ERT seeding for Hopper (sm_90a): the trie descent from every (read, start
// column) lane, whole in one launch with no host synchronisation inside.
//
// ---- ert_extend_kernel
// Replaces bwa_mem_scale_tpu/ops/ert.py:107 ert_extend_all_positions (its
// jax.lax.while_loop at :218, body :161-213), through the port's lockstep
// counterpart ops/ert.py::ert_extend_all_positions (a host synchronisation
// every 8 ticks, tens of small PyTorch launches a tick). Every output
// equals the lockstep's, bit for bit, and so do each lane's node and leaf
// steps.
//
// What it computes. The trie (ops/ert.py::DeviceErt) is rec [N + 1][4]
// (encoding, payload) pairs of int64, one 16-byte pair a child: encoding
// >= 0 a node id, -1 empty, -(SA row) - 2 a single occurrence; payload
// (lo_or_pos << 24) | min(cnt, 2^24 - 1), lo_or_pos the child's SA range
// start, or for a single occurrence its reference position. So k of a
// single occurrence comes from the encoding and its leaf walk from the
// payload. Row `root` is the synthetic root. Lane (b, p), p < L: from the
// root's pair for its base (an N clipped to 3), s the count, E = p + 1
// when the base is inside the read and s >= mi (with check_initial, else
// s >= 1); the lane goes on only when s > 0 (and s >= mi with
// check_initial). Then one step a column j = p + t: an N or the read's
// end retires it with no record; on a node the pair of its child for the
// base (size, k, and on reaching a single occurrence the leaf offset
// leaf_pos = position - p); on a leaf one reference byte at leaf_pos + j,
// bounded by seq_len (2 l_pac, not the allocation), compared with the
// base, size 1 or 0. A size below mi retires the lane (died_s when
// merged); otherwise E = j + 1. Merged with pass 3 (p3_max_intv, p3_stop >
// 0), the first step with t + 1 >= p3_stop whose size falls below
// p3_max_intv is recorded (f3_E = j and the step's k and size), whether
// the lane goes on or not. A node at the trie's depth cap has four empty
// children, so a walk on nodes stops there; leaf walks are uncapped. The
// lockstep advances every lane by one shared t; here each lane runs its
// own t, which gives each lane the same j and the same records, since no
// lane's state reads another's.
//
// What bounds it on this card: a lane's node steps are a chain of
// dependent loads (each pair's address is the previous pair's encoding),
// one 16-byte pair (one 32-byte sector) a step; past the top levels the
// record of a bacterial genome (425 MB at 4.6 Mbp) lies far outside the 50
// MB L2, so each deep step is an HBM trip. The bytes a launch moves (16 a
// node step, 1 a leaf step) take microseconds at 3.35 TB/s, so the floor
// is latency: the longest lane's node steps plus its leaf words (16
// reference bytes a word), times a dependent trip, both measured in the
// run (chip_smoke.py phase 12).
//
// Design: one block a read (row), its codes staged into dynamic shared
// memory as bytes clipped into [0, 4] (stage_codes of csrc/fmi_step.cuh,
// as csrc/sweep.cu), padded with N codes, and the root's four pairs too;
// one thread a start column, min(256, L rounded up to 32) threads a block
// striding over the columns. A lane walks its node steps one pair a step.
// Once it reaches a single occurrence, its leaf walk compares 16 reference
// bytes a load: from the reference position on, an aligned 16-byte word of
// `ref` and the next (two loads to start, one a word after), funnel-
// shifted to the lane's offset, against 16 staged codes read the same way
// from shared memory; the first mismatch or N of a word is the lowest
// nonzero byte of (ref ^ codes) | (codes & 4), by __ffsll. The lockstep's
// rules are kept: a run of matches ends before the read's end or an N (no
// step there), or at a mismatch or seq_len (a step of size 0); pass 3's
// record falls at the first step with t + 1 >= p3_stop whose size is below
// p3_max_intv, inside a word or at its end; a size below mi ends the walk
// (with mi > 1 the first leaf step does). Each lane's node and leaf steps
// are the lockstep's counts, the leaf steps added a run at a time. A warp
// runs as long as its longest lane (lanes before a mismatch stop near it,
// lanes after it run on; the per-lane steps show the divergence). Outputs
// [4][B][L] int32 (E, f3_E, node steps, leaf steps), [6][B][L] P (k, l, s,
// f3_k, f3_l, f3_ss; the l planes are 0, as the trie holds no
// reverse-complement interval) and [3][B][L] bytes (f3_s, died_s, valid),
// every slot written.
//
// ---- the int64 form
// A template on its position type P (int, long long), as every FM-walk
// kernel of the port: ert_extend_launch64 writes k, s and the records at
// int64, for an index on the int64 layout of ops/occ.py. Node ids and leaf
// positions are int64 in both forms.

#include "fmi_step.cuh"

namespace {

constexpr int ERT_BLOCK = 256;       // the most threads a block takes
// blocks an SM: 8 x 256 threads fill it at 32 registers a thread (ptxas:
// no spills), so that node walks keep as many trips in flight as the
// per-byte design did (uncapped, 39 registers and 5 blocks, the depth-cap
// batch's reseed ran longer than that design's)
constexpr int ERT_MIN_BLOCKS = 8;
constexpr int CNT_BITS = 24;
constexpr long long CNT_MASK = (1LL << CNT_BITS) - 1;
constexpr int WORD = 16;             // reference bytes a leaf load
constexpr int FRONT = 16;            // N codes staged before column 0
// the staged codes: 16 N codes, the L codes rounded up to 16, then two
// words of N codes, so that a word read from any column in [-16, L]
// stays inside
__host__ __device__ __forceinline__ size_t ert_codes_bytes(int L) {
  return FRONT + codes_bytes(L) + 2 * WORD;
}

// The 8 staged codes from column c on (c >= -16), as one 8-byte word
// (little-endian), from 4-byte aligned words of shared memory.
__device__ __forceinline__ unsigned long long codes8(const int8_t* q,
                                                     int c) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(q + (c & ~3));
  const int sh = (c & 3) * 8;
  const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
  return __funnelshift_r(w0, w1, sh)
         | (unsigned long long)__funnelshift_r(w1, w2, sh) << 32;
}

// The first stop byte (an N code, or a code that differs from its
// reference byte) under the mask, of 8 reference bytes r against the 8
// staged codes from column c on; 8 when there is none.
__device__ __forceinline__ int stop8(unsigned long long r, const int8_t* q,
                                     int c, unsigned long long mask) {
  constexpr unsigned long long NBIT = 0x0404040404040404ULL;
  const unsigned long long cw = codes8(q, c);
  const unsigned long long x = ((r ^ cw) | (cw & NBIT)) & mask;
  return x ? (__ffsll(x) - 1) >> 3 : 8;
}

// The first column c in [j, limit) whose staged code is an N or differs
// from the reference byte at lp + c, else limit: one aligned 16-byte word
// of the reference a step (the first word's bytes before lp + j masked
// off), its two halves against the 8 codes of their columns each. The
// caller keeps limit <= seq_len - lp, so every word read starts inside
// ref[0, seq_len).
__device__ __forceinline__ int run_end(const uint8_t* __restrict__ ref,
                                       long long lp, const int8_t* q, int j,
                                       int limit) {
  const int off = (int)((uintptr_t)(ref + lp + j) & 15);
  int col = j - off;                   // the column of the word's first byte
  auto word = [&]() {                  // the word at column col
    return __ldg(reinterpret_cast<const ulonglong2*>(ref + lp + col));
  };
  ulonglong2 r = word();
  int at = stop8(r.x, q, col, off < 8 ? ~0ULL << (8 * off) : 0);
  if (at == 8)
    at += stop8(r.y, q, col + 8, off < 8 ? ~0ULL : ~0ULL << (8 * (off - 8)));
  while (at == WORD) {
    col += WORD;
    if (col >= limit) return limit;
    r = word();
    at = stop8(r.x, q, col, ~0ULL);
    if (at == 8) at += stop8(r.y, q, col + 8, ~0ULL);
  }
  return min(col + at, limit);
}

template <typename P>
__global__ void __launch_bounds__(ERT_BLOCK, ERT_MIN_BLOCKS)
ert_extend_kernel(const longlong2* __restrict__ rec,   // [N + 1][4]
                  long long root, const uint8_t* __restrict__ ref,
                  long long seq_len,
                  const int32_t* __restrict__ codes,   // [B, L]
                  const int32_t* __restrict__ lens,    // [B]
                  const int32_t* __restrict__ mis,     // [B]
                  int B, int L, int check_initial, int p3_max_intv,
                  int p3_stop,
                  int32_t* __restrict__ out_i,         // [4][B][L]
                  P* __restrict__ out_p,               // [6][B][L]
                  uint8_t* __restrict__ out_b) {       // [3][B][L]
  extern __shared__ int4 smem[];
  int8_t* q = reinterpret_cast<int8_t*>(smem) + FRONT; // the read's codes
  __shared__ longlong2 top[4];                         // the root's pairs
  const int b = blockIdx.x;
  const int len = lens[b];
  const P mi = (P)mis[b];
  const bool merge = p3_max_intv > 0 && p3_stop > 0;
  stage_codes<true>(codes + (size_t)b * L, L, q, threadIdx.x, blockDim.x);
  for (int i = threadIdx.x; i < (int)ert_codes_bytes(L) - L;
       i += blockDim.x)
    q[i < FRONT ? i - FRONT : L + i - FRONT] = 4;
  if (threadIdx.x < 4) top[threadIdx.x] = __ldg(rec + root * 4 + threadIdx.x);
  __syncthreads();
  const size_t plane = (size_t)B * L;  // an output plane
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    const int c0 = q[p];
    const bool base_ok = p < len && c0 < 4;
    const size_t o = (size_t)b * L + p;
    out_b[2 * plane + o] = base_ok;
    const longlong2 r0 = top[c0 < 4 ? c0 : 3];
    P s = (P)(r0.y & CNT_MASK);
    const P lop = (P)(r0.y >> CNT_BITS);
    const bool leaf0 = r0.x <= -2;
    P k = leaf0 ? (P)(-r0.x - 2) : lop;
    long long lp = leaf0 ? (long long)lop - p : 0;     // the leaf offset
    bool act = base_ok && (!check_initial || s >= mi) && s > 0;
    int E = base_ok && s >= (check_initial ? mi : (P)1) ? p + 1 : p;
    long long cur = act ? r0.x : -1;                   // >= 0: on a node
    if (!act) k = s = 0;
    bool died = false, f3s = false;
    int node_steps = 0, leaf_steps = 0;
    // pass 3's record at column j (the step's k and size), when it is the
    // first; written at once
    auto record = [&](int j, P nk, P ns) {
      if (merge && !f3s && ns < (P)p3_max_intv && j - p + 1 >= p3_stop) {
        f3s = true;
        out_i[plane + o] = j;
        out_p[3 * plane + o] = nk;
        out_p[5 * plane + o] = ns;
      }
    };
    int j = p + 1;
    for (; act && cur >= 0; ++j) {     // node steps, one a column
      const int a = q[j];
      if (j >= len || a >= 4) {        // an N or the read's end
        act = false;
        break;
      }
      const longlong2 r = __ldg(rec + cur * 4 + a);
      const long long n_lop = r.y >> CNT_BITS;
      const P ns = (P)(r.y & CNT_MASK);
      const P nk = r.x <= -2 ? (P)(-r.x - 2) : (P)n_lop;
      ++node_steps;
      record(j, nk, ns);
      if (ns < mi) {                   // a size failure
        died = merge;
        act = false;
        break;
      }
      if (r.x <= -2) lp = n_lop - p;   // a single occurrence from here on
      E = j + 1;
      k = nk;
      s = ns;
      cur = r.x >= 0 ? r.x : -1;
    }
    out_i[2 * plane + o] = node_steps;
    if (act && mi > (P)1) {            // a leaf step's size is at most 1
      const int a = q[j];
      if (j < len && a < 4) {
        const long long rpos = lp + j;
        const P ns = rpos >= 0 && rpos < seq_len
                     && (int)__ldg(ref + rpos) == a;
        ++leaf_steps;
        record(j, k, ns);
        died = merge;
      }
    } else if (act) {                  // runs of matches, word by word
      while (true) {
        const long long lim = min((long long)len, seq_len - lp);
        const int e = lp + j < 0 || lim <= j
                          ? j : run_end(ref, lp, q, j, (int)lim);
        if (e > j) {                   // leaf steps of size 1 at [j, e)
          leaf_steps += e - j;
          const int c3 = max(j, p + p3_stop - 1);   // the record's column
          if (p3_max_intv > 1 && c3 < e) record(c3, k, (P)1);
          E = e;
          s = 1;
        }
        if (e >= len || q[e] >= 4) break;   // no step at an N or the end
        ++leaf_steps;                  // a mismatch or past seq_len: size 0
        record(e, k, (P)0);
        if ((P)0 < mi) {
          died = merge;
          break;
        }
        E = e + 1;
        s = 0;
        j = e + 1;
      }
    }
    out_i[o] = E;
    out_i[3 * plane + o] = leaf_steps;
    out_p[o] = k;
    out_p[plane + o] = 0;
    out_p[2 * plane + o] = s;
    out_p[4 * plane + o] = 0;
    if (!f3s) {                        // no record: its slots are 0
      out_i[plane + o] = 0;
      out_p[3 * plane + o] = 0;
      out_p[5 * plane + o] = 0;
    }
    out_b[o] = f3s;
    out_b[plane + o] = died;
  }
}

// threads a block: L rounded up to a warp, at most ERT_BLOCK
int ert_threads(int L) {
  const int t = (L + WARP - 1) / WARP * WARP;
  return t < ERT_BLOCK ? t : ERT_BLOCK;
}

template <typename P>
int ert_extend_launch_t(const void* rec, long long root, const void* ref,
                        long long seq_len, const void* codes,
                        const void* lens, const void* mis, int B, int L,
                        int check_initial, int p3_max_intv, int p3_stop,
                        void* out_i, void* out_p, void* out_b,
                        void* stream) {
  if (B <= 0) return 0;
  const size_t bytes = ert_codes_bytes(L);
  if (!rec || !ref || root < 0 || seq_len <= 0 || L <= 0
      || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = allow_smem(ert_extend_kernel<P>, bytes);
  if (e != cudaSuccess) return (int)e;
  ert_extend_kernel<P><<<B, ert_threads(L), bytes, (cudaStream_t)stream>>>(
      (const longlong2*)rec, root, (const uint8_t*)ref, seq_len,
      (const int32_t*)codes, (const int32_t*)lens, (const int32_t*)mis, B, L,
      check_initial, p3_max_intv, p3_stop, (int32_t*)out_i, (P*)out_p,
      (uint8_t*)out_b);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch ert_extend_kernel on `stream` over B rows (one block each) of L
// columns; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it cannot take. rec is [N + 1][4][2]
// int64 (16-byte aligned), root its root row, ref at least seq_len bytes.
// out_p is [6][B][L] int32 here and int64 in ert_extend_launch64. The
// caller allocates every buffer (the kernel writes every output slot) and
// checks shapes and types; nothing here synchronises.
extern "C" int ert_extend_launch(const void* rec, long long root,
                                 const void* ref, long long seq_len,
                                 const void* codes, const void* lens,
                                 const void* mis, int B, int L,
                                 int check_initial, int p3_max_intv,
                                 int p3_stop, void* out_i, void* out_p,
                                 void* out_b, void* stream) {
  return ert_extend_launch_t<int>(rec, root, ref, seq_len, codes, lens, mis,
                                  B, L, check_initial, p3_max_intv, p3_stop,
                                  out_i, out_p, out_b, stream);
}

extern "C" int ert_extend_launch64(const void* rec, long long root,
                                   const void* ref, long long seq_len,
                                   const void* codes, const void* lens,
                                   const void* mis, int B, int L,
                                   int check_initial, int p3_max_intv,
                                   int p3_stop, void* out_i, void* out_p,
                                   void* out_b, void* stream) {
  return ert_extend_launch_t<long long>(rec, root, ref, seq_len, codes, lens,
                                        mis, B, L, check_initial,
                                        p3_max_intv, p3_stop, out_i, out_p,
                                        out_b, stream);
}
