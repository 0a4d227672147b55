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
// MB L2, so each deep step is an HBM trip. A leaf step's address is known
// in advance (leaf_pos + j), so leaf loads are not a chain. The bytes a
// launch moves (16 a node step, 1 a leaf step) take microseconds at 3.35
// TB/s; the longest lane's node steps times a dependent trip set the
// floor. So the design keeps every other load off the chain: the read's
// codes are staged into shared memory once a block, and the root's four
// pairs too.
//
// Design: one block a read (row), its codes staged into dynamic shared
// memory as bytes (stage_codes of csrc/fmi_step.cuh, as csrc/sweep.cu),
// one thread a start column, min(256, L rounded up to 32) threads a block
// striding over the columns. A warp runs as long as its longest lane
// (lanes before a mismatch stop near it, lanes after it run on; the
// per-lane steps show the divergence). Outputs [4][B][L] int32 (E, f3_E,
// node steps, leaf steps), [6][B][L] P (k, l, s, f3_k, f3_l, f3_ss; the l
// planes are 0, as the trie holds no reverse-complement interval) and
// [3][B][L] bytes (f3_s, died_s, valid), every slot written.
//
// ---- the int64 form
// A template on its position type P (int, long long), as every FM-walk
// kernel of the port: ert_extend_launch64 writes k, s and the records at
// int64, for an index on the int64 layout of ops/occ.py. Node ids and leaf
// positions are int64 in both forms.

#include "fmi_step.cuh"

namespace {

constexpr int ERT_BLOCK = 256;       // the most threads a block takes
constexpr int CNT_BITS = 24;
constexpr long long CNT_MASK = (1LL << CNT_BITS) - 1;

template <typename P>
__global__ void __launch_bounds__(ERT_BLOCK)
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
  int8_t* q = reinterpret_cast<int8_t*>(smem);         // the read's codes
  __shared__ longlong2 top[4];                         // the root's pairs
  const int b = blockIdx.x;
  const int len = lens[b];
  const P mi = (P)mis[b];
  const bool merge = p3_max_intv > 0 && p3_stop > 0;
  stage_codes(codes + (size_t)b * L, L, q, threadIdx.x, blockDim.x);
  if (threadIdx.x < 4) top[threadIdx.x] = __ldg(rec + root * 4 + threadIdx.x);
  __syncthreads();
  auto code = [&](int i) { return i < L ? (int)q[i] : 4; };
  auto clip = [](int c) { return c < 0 ? 0 : (c > 3 ? 3 : c); };
  const size_t plane = (size_t)B * L;
  for (int p = threadIdx.x; p < L; p += blockDim.x) {
    const int c0 = code(p);
    const bool base_ok = p < len && c0 < 4;
    const longlong2 r0 = top[clip(c0)];
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
    P f3k = 0, f3ss = 0;
    int f3E = 0, node_steps = 0, leaf_steps = 0;
    for (int t = 1; act; ++t) {        // one step a column
      const int j = p + t;
      const int a = code(j);
      if (j >= len || a >= 4) break;   // an N or the read's end
      const int ac = clip(a);
      P ns, nk = k;
      long long nlp = lp, ncur = cur;
      if (cur >= 0) {                  // a node: its child's pair
        const longlong2 r = __ldg(rec + cur * 4 + ac);
        const long long n_lop = r.y >> CNT_BITS;
        ns = (P)(r.y & CNT_MASK);
        if (r.x <= -2) {               // a single occurrence from here on
          nk = (P)(-r.x - 2);
          nlp = n_lop - p;
        } else {
          nk = (P)n_lop;
        }
        ncur = r.x >= 0 ? r.x : -1;
        ++node_steps;
      } else {                         // a leaf: one reference byte
        const long long rpos = lp + j;
        ns = rpos >= 0 && rpos < seq_len && (int)__ldg(ref + rpos) == ac;
        ++leaf_steps;
      }
      if (merge && !f3s && ns < (P)p3_max_intv && t + 1 >= p3_stop) {
        f3s = true;
        f3E = j;
        f3k = nk;
        f3ss = ns;
      }
      if (ns < mi) {                   // a size failure
        died = merge;
        break;
      }
      E = j + 1;
      k = nk;
      s = ns;
      lp = nlp;
      cur = ncur;
    }
    const size_t o = (size_t)b * L + p;
    out_i[o] = E;
    out_i[plane + o] = f3E;
    out_i[2 * plane + o] = node_steps;
    out_i[3 * plane + o] = leaf_steps;
    const P vals[6] = {k, 0, s, f3k, 0, f3ss};
#pragma unroll
    for (int i = 0; i < 6; ++i) out_p[i * plane + o] = vals[i];
    out_b[o] = f3s;
    out_b[plane + o] = died;
    out_b[2 * plane + o] = base_ok;
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
  const size_t bytes = codes_bytes(L);
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
