// The one-hot seeding stage's glue for Hopper (sm_90a): what
// collect_smems_oh and collect_smems_rl do between and after their FM
// walks, in two launches with no host synchronisation and no tensor
// operation around them but the outputs' allocations. The stage on a CUDA
// batch is then five launches: pass 1 (csrc/smem.cu one_pos_kernel, or
// the readlane engine's csrc/readlane.cu), reseed_tasks_kernel, pass 2,
// pass 3, merge_smems_kernel.
//
// ---- reseed_tasks_kernel (the reseed task list)
// Replaces bwa_mem_scale_tpu/ops/smem_oh.py:772-789 (the candidates, the
// compaction of ops/smem.py:85 compact_indices, reseed_of and the task
// fields) through ops/smem.py::reseed_tasks and compact_indices, whose
// cumsum, scatter, gathers and reductions were ~40 torch operations a
// batch on the card. A candidate is a slot j < min(cnt, M) of pass 1's
// row whose SMEM has at least split_len bases and at most split_width
// occurrences; tasks are the first T candidates in flat read-major
// order, each (read, midpoint (m + n + 1) >> 1, min interval s + 1); a
// read with a candidate past T is flagged (reseed_of); the list's tail
// holds invalid tasks equal to the plain version's (read 0, slot 0's
// midpoint, min interval 1). It also writes each read's first task and
// task count, so the merge finds a read's tasks without a search.
// Bound: a few bytes a read (its count, the valid slots' m, n and s, the
// outputs), so a batch is a few microseconds of latency, not bytes: the
// flat rank is a scan over reads. Design: one block of 1,024 threads
// loops over the reads in chunks of 1,024, a thread a read: it counts
// its candidates, the block scans the counts (a warp-shuffle scan in
// each warp, then one warp scans the 32 warp totals in shared memory;
// csrc/block_scan.cuh, shared with csrc/extend.cu)
// and carries the chunk's total to the next chunk, and each thread
// writes its own tasks at its rank. No block waits on another's result,
// so nothing rests on the order in which blocks are dispatched (the
// decoupled look-back of csrc/sal.cu does). B = 512 is one chunk; B =
// 65,536 is 64 chunks of one scan each. A thread re-reads only its own
// candidates' slots (L1 hits) to write them.
//
// ---- merge_smems_kernel (pass 2's emission, the three-pass concat, the
// per-read sort and the overflow counts)
// Replaces bwa_mem_scale_tpu/ops/smem_oh.py:794-823 (pass 2's
// _emit_compact into the reads' rows, p2_of, concat_smems, the valid
// mask, the key, lax.sort and the saturated count; the readlane engine's
// bwa_mem_scale_tpu/ops/smem_rl.py twin of it) through
// ops/smem.py::merge_smems_plain, ~120 torch operations a batch. A warp
// a read. It stages the read's valid entries in concat order as (key,
// source) pairs of 8 bytes: pass 1's first min(cnt1, M) slots; pass 2's
// entries, its tasks in task order and each task's first min(cnt, M)
// columns in column order, placed at the task's offset (the earlier
// tasks' counts, a warp scan over the read's tasks in chunks of 32) and
// dropped from position M on while the count still grows, exactly as
// _emit_compact places them; pass 3's first min(cnt3, M) slots. The
// stable sort on key = (m << 16) | n (int32, wrapping as torch's) with
// the invalid slots keyed 1 << 30 is then a rank: a valid entry's place
// is the valid entries with a smaller key, or an equal key earlier in
// concat order, each lane ranking its entries against the staged keys;
// the invalid slots follow in concat order (their values copied: pass
// 1's and pass 3's rows, zeros for pass 2, as the plain version's
// buffers hold). Only a read past 16,383 bases has keys at or above 1 <<
// 30, which interleave with the invalid slots: a warp-uniform test
// sends such a read through the exact rule for them. Every output slot
// is written once, cnt once: with pass_of (the one-hot engine) the width
// W where pass 1, a pass-2 task or pass 3 reached M or the read
// overflowed the task list, else cnt1 + pass 2's count + cnt3; without
// (readlane) only reseed_of saturates. Bound: the rows' bytes, read and
// written once (a read's W slots of five fields); the rank is V^2
// comparisons for V valid entries (a few at M = 24) from shared memory.
// The staging takes W x 8 bytes a warp in shared memory, 8 warps a block
// (576 B a warp at M = 24, 2.4 KB at M = 101), fewer warps a block past
// 48 KB, and past 227 KB a warp (W > 29,056: reads past ~9,600 bases at
// full depth) a device scratch [B][W] that the wrapper allocates; the
// wrapper plans it (ops/smem_cuda.py::merge_plan) and refuses only M >
// 46,340 (a source index that would not fit 32 bits).
//
// Both kernels are templates on the position type P (int, or long long
// for the int64 layout): only k, l and s are P; the emitted m, n and
// every count are int. ops/smem_cuda.py::reseed_tasks_twin and
// merge_smems_twin run their loops on the CPU.

#include <cstdint>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

using scan::warp_inclusive;

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int TASK_THREADS = 1024;       // reseed_tasks_kernel's one block
constexpr int MERGE_WARPS = 8;           // merge_smems_kernel's warps a block
constexpr size_t SMEM_DEFAULT = 49152;
constexpr size_t SMEM_MAX = 232448;
constexpr int KEY_INVALID = 1 << 30;     // an invalid slot's sort key
constexpr int M_MAX = 46340;             // M * M < 2^31 (a pass-2 source)

template <typename P>
struct SmemIn {                          // one SmemBuf, rows of M slots
  const int32_t* m;
  const int32_t* n;
  const P* k;
  const P* l;
  const P* s;
  const int32_t* cnt;
};

template <typename P>
struct SmemOut {
  int32_t* m;
  int32_t* n;
  P* k;
  P* l;
  P* s;
  int32_t* cnt;
};

template <typename P>
__device__ __forceinline__ bool is_cand(const SmemIn<P>& p, long long i,
                                        int split_len, long long split_width) {
  return p.n[i] + 1 - p.m[i] >= split_len && (long long)p.s[i] <= split_width;
}

template <typename P>
__global__ void __launch_bounds__(TASK_THREADS) reseed_tasks_kernel(
    SmemIn<P> p1, int B, int M, int T, int split_len, long long split_width,
    int32_t* __restrict__ t_read, int32_t* __restrict__ t_x,
    int32_t* __restrict__ t_mi, uint8_t* __restrict__ t_valid,
    uint8_t* __restrict__ reseed_of, int32_t* __restrict__ first,
    int32_t* __restrict__ count) {
  __shared__ int warp_inc[TASK_THREADS / WARP];
  const int tid = threadIdx.x;
  int carry = 0;                 // the candidates of the earlier chunks
  for (int base = 0; base < B; base += TASK_THREADS) {
    const int b = base + tid;
    const long long row = (long long)b * M;
    int k = 0, c = 0;
    if (b < B) {
      k = min(max(p1.cnt[b], 0), M);
      for (int j = 0; j < k; ++j)
        c += is_cand(p1, row + j, split_len, split_width);
    }
    int chunk;
    const int inc = scan::block_inclusive(c, warp_inc, &chunk);
    if (b < B) {
      const int r0 = carry + inc - c;
      const int kept = max(0, min(c, T - r0));
      first[b] = min(r0, T);
      count[b] = kept;
      reseed_of[b] = c > kept;
      for (int j = 0, r = r0; j < k && r < r0 + kept; ++j) {
        const long long i = row + j;
        if (!is_cand(p1, i, split_len, split_width)) continue;
        t_read[r] = b;
        t_x[r] = (p1.n[i] + 1 + p1.m[i]) >> 1;
        t_mi[r] = (int32_t)(p1.s[i] + 1);
        t_valid[r] = 1;
        ++r;
      }
    }
    carry += chunk;
  }
  // the list's tail: the plain version's invalid tasks (order 0)
  const int32_t x0 = (p1.n[0] + 1 + p1.m[0]) >> 1;
  for (int r = min(carry, T) + tid; r < T; r += TASK_THREADS) {
    t_read[r] = 0;
    t_x[r] = x0;
    t_mi[r] = 1;
    t_valid[r] = 0;
  }
}

__device__ __forceinline__ int sort_key(int32_t m, int32_t n) {
  return (int)(((uint32_t)m << 16) | (uint32_t)n);
}

template <typename P>
__device__ __forceinline__ void copy_slot(const SmemIn<P>& src, long long i,
                                          const SmemOut<P>& out, long long o) {
  out.m[o] = src.m[i];
  out.n[o] = src.n[i];
  out.k[o] = src.k[i];
  out.l[o] = src.l[i];
  out.s[o] = src.s[i];
}

template <typename P>
__global__ void __launch_bounds__(MERGE_WARPS * WARP) merge_smems_kernel(
    SmemIn<P> p1, SmemIn<P> p2, SmemIn<P> p3, int has3,
    const int32_t* __restrict__ first, const int32_t* __restrict__ count,
    const uint8_t* __restrict__ reseed_of, int B, int M, int pass_of,
    int2* __restrict__ scratch, SmemOut<P> out) {
  extern __shared__ int2 staged_all[];
  const int lane = threadIdx.x & (WARP - 1), w = threadIdx.x / WARP;
  const int b = blockIdx.x * (blockDim.x / WARP) + w;
  if (b >= B) return;
  const int W = (has3 ? 3 : 2) * M;
  int2* st = scratch ? scratch + (long long)b * W : staged_all + w * W;
  const long long row = (long long)b * M;
  const int c1raw = p1.cnt[b], c3raw = has3 ? p3.cnt[b] : 0;
  const int c1 = min(max(c1raw, 0), M), c3 = min(max(c3raw, 0), M);
  const int f = first[b], nt = count[b];
  for (int j = lane; j < c1; j += WARP)
    st[j] = make_int2(sort_key(p1.m[row + j], p1.n[row + j]), j);
  // pass 2: the read's tasks f .. f + nt - 1, 32 a chunk
  int p2cnt = 0;
  bool of2 = false;
  for (int t0 = 0; t0 < nt; t0 += WARP) {
    int ct = 0;
    if (t0 + lane < nt) {
      const int raw = p2.cnt[f + t0 + lane];
      ct = min(max(raw, 0), M);
      of2 |= raw >= M;
    }
    const int inc = warp_inclusive(ct, lane);
    const int off = p2cnt + inc - ct;      // the task's first position
    p2cnt += __shfl_sync(FULL, inc, WARP - 1);
    for (int i = 0; i < min(WARP, nt - t0); ++i) {
      const int o = __shfl_sync(FULL, off, i), cti = __shfl_sync(FULL, ct, i);
      if (o >= M) break;                   // this task's and later ones drop
      const long long trow = (long long)(f + t0 + i) * M;
      for (int c = lane; c < cti && o + c < M; c += WARP)
        st[c1 + o + c] = make_int2(sort_key(p2.m[trow + c], p2.n[trow + c]),
                                   (t0 + i) * M + c);
    }
  }
  of2 = __any_sync(FULL, of2);
  const int c2 = min(p2cnt, M), V = c1 + c2 + c3;
  for (int j = lane; j < c3; j += WARP)
    st[c1 + c2 + j] = make_int2(sort_key(p3.m[row + j], p3.n[row + j]), j);
  __syncwarp();
  bool big = false;              // a key at or past the invalid slots'
  for (int i = lane; i < V; i += WARP) big |= st[i].x >= KEY_INVALID;
  big = __any_sync(FULL, big);
  const int cp[3] = {c1, c2, c3};
  const long long orow = (long long)b * W;
  // the valid entries at their ranks
  for (int i = lane; i < V; i += WARP) {
    const int2 e = st[i];
    int r = 0;
    for (int q = 0; q < V; ++q) {
      const int kq = st[q].x;
      r += kq < e.x || (kq == e.x && q < i);
    }
    const int part = i < c1 ? 0 : (i < c1 + c2 ? 1 : 2);
    if (big && e.x >= KEY_INVALID) {     // the invalid slots before it
      int before = 0;
      for (int p = 0; p < part; ++p) before += M - cp[p];
      r += e.x > KEY_INVALID ? W - V : before;
    }
    if (part == 1)
      copy_slot(p2, (long long)(f + e.y / M) * M + e.y % M, out, orow + r);
    else
      copy_slot(part ? p3 : p1, row + e.y, out, orow + r);
  }
  // the invalid slots, in concat order after the valid entries
  int lt = V;                    // big: the valid keys below 1 << 30
  if (big) {
    lt = 0;
    for (int q = 0; q < V; ++q) lt += st[q].x < KEY_INVALID;
  }
  for (int x = lane; x < W - V; x += WARP) {
    int p = 0, o = x;            // x-th invalid slot: part p, slot o
    while (o >= M - cp[p]) o -= M - cp[p++];
    o += cp[p];
    int r = lt + x;
    if (big) {                   // valid keys equal to 1 << 30 before it
      const int idx = p * M + o;
      for (int q = 0; q < V; ++q) {
        const int pq = q < c1 ? 0 : (q < c1 + c2 ? 1 : 2);
        const int oq = q - (pq > 0 ? c1 : 0) - (pq > 1 ? c2 : 0);
        r += st[q].x == KEY_INVALID && pq * M + oq < idx;
      }
    }
    const long long d = orow + r;
    if (p == 1) {
      out.m[d] = 0;
      out.n[d] = 0;
      out.k[d] = 0;
      out.l[d] = 0;
      out.s[d] = 0;
    } else {
      copy_slot(p ? p3 : p1, row + o, out, d);
    }
  }
  if (lane == 0) {
    const bool of = reseed_of[b] || (pass_of && (c1raw >= M || of2
                                                 || (has3 && c3raw >= M)));
    out.cnt[b] = of ? W : c1raw + p2cnt + c3raw;
  }
}

template <typename P>
SmemIn<P> smem_in(const void* m, const void* n, const void* k, const void* l,
                  const void* s, const void* cnt) {
  return SmemIn<P>{(const int32_t*)m, (const int32_t*)n, (const P*)k,
                   (const P*)l, (const P*)s, (const int32_t*)cnt};
}

template <typename P>
int reseed_tasks_launch_t(const void* m, const void* n, const void* s,
                          const void* cnt, int B, int M, int T, int split_len,
                          long long split_width, void* t_read, void* t_x,
                          void* t_mi, void* t_valid, void* reseed_of,
                          void* first, void* count, void* stream) {
  if (B <= 0 || M <= 0 || T < 0 || (long long)B * M >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  reseed_tasks_kernel<P><<<1, TASK_THREADS, 0, (cudaStream_t)stream>>>(
      smem_in<P>(m, n, nullptr, nullptr, s, cnt), B, M, T, split_len,
      split_width, (int32_t*)t_read, (int32_t*)t_x, (int32_t*)t_mi,
      (uint8_t*)t_valid, (uint8_t*)reseed_of, (int32_t*)first,
      (int32_t*)count);
  return (int)cudaGetLastError();
}

template <typename P>
int merge_smems_launch_t(const void* const* p1, const void* const* p2,
                         const void* const* p3, const void* first,
                         const void* count, const void* reseed_of, int B,
                         int M, int pass_of, int warps, void* scratch,
                         void* const* out, void* stream) {
  const int W = (p3 ? 3 : 2) * M;
  const size_t bytes = scratch ? 0 : (size_t)warps * W * sizeof(int2);
  if (B <= 0 || M <= 0 || M > M_MAX || warps < 1 || warps > MERGE_WARPS
      || bytes > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  if (bytes > SMEM_DEFAULT) {
    const cudaError_t e = cudaFuncSetAttribute(
        merge_smems_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const SmemIn<P> none{};
  merge_smems_kernel<P><<<(B + warps - 1) / warps, warps * WARP, bytes,
                          (cudaStream_t)stream>>>(
      smem_in<P>(p1[0], p1[1], p1[2], p1[3], p1[4], p1[5]),
      smem_in<P>(p2[0], p2[1], p2[2], p2[3], p2[4], p2[5]),
      p3 ? smem_in<P>(p3[0], p3[1], p3[2], p3[3], p3[4], p3[5]) : none,
      p3 != nullptr, (const int32_t*)first, (const int32_t*)count,
      (const uint8_t*)reseed_of, B, M, pass_of, (int2*)scratch,
      SmemOut<P>{(int32_t*)out[0], (int32_t*)out[1], (P*)out[2], (P*)out[3],
                 (P*)out[4], (int32_t*)out[5]});
  return (int)cudaGetLastError();
}

}  // namespace

// Launch reseed_tasks_kernel on `stream`: pass 1's m, n, s and cnt
// ([B][M], [B]; s of the position type, 4 or 8 bytes) -> the task list
// t_read, t_x, t_mi (int32), t_valid (bytes) [T], reseed_of (bytes), each
// read's first task and task count (int32) [B]; every slot written.
// Returns cudaGetLastError() (0 on success), cudaErrorInvalidValue for a
// shape it cannot take. The caller allocates every buffer and checks
// shapes and types; nothing here synchronises.
extern "C" int reseed_tasks_launch(const void* m, const void* n,
                                   const void* s, const void* cnt, int B,
                                   int M, int T, int split_len,
                                   long long split_width, void* t_read,
                                   void* t_x, void* t_mi, void* t_valid,
                                   void* reseed_of, void* first, void* count,
                                   void* stream) {
  return reseed_tasks_launch_t<int>(m, n, s, cnt, B, M, T, split_len,
                                    split_width, t_read, t_x, t_mi, t_valid,
                                    reseed_of, first, count, stream);
}

extern "C" int reseed_tasks_launch64(const void* m, const void* n,
                                     const void* s, const void* cnt, int B,
                                     int M, int T, int split_len,
                                     long long split_width, void* t_read,
                                     void* t_x, void* t_mi, void* t_valid,
                                     void* reseed_of, void* first,
                                     void* count, void* stream) {
  return reseed_tasks_launch_t<long long>(
      m, n, s, cnt, B, M, T, split_len, split_width, t_read, t_x, t_mi,
      t_valid, reseed_of, first, count, stream);
}

// Launch merge_smems_kernel on `stream`: each SmemBuf as its six pointers
// m, n, k, l, s, cnt (pass 1 and pass 3 [B][M], pass 2's tasks [T][M];
// p3 null without pass 3), the task list's first / count [B] and
// reseed_of [B] -> out's six pointers ([B][W], W = 2 M or 3 M; cnt [B]).
// `warps` a block with the staging in shared memory, or the device
// scratch [B][W] of 8-byte pairs (ops/smem_cuda.py::merge_plan). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a shape it cannot take.
extern "C" int merge_smems_launch(
    const void* m1, const void* n1, const void* k1, const void* l1,
    const void* s1, const void* cnt1, const void* m2, const void* n2,
    const void* k2, const void* l2, const void* s2, const void* cnt2,
    const void* m3, const void* n3, const void* k3, const void* l3,
    const void* s3, const void* cnt3, const void* first, const void* count,
    const void* reseed_of, int B, int M, int pass_of, int warps,
    void* scratch, void* om, void* on, void* ok, void* ol, void* os,
    void* ocnt, void* stream) {
  const void* p1[6] = {m1, n1, k1, l1, s1, cnt1};
  const void* p2[6] = {m2, n2, k2, l2, s2, cnt2};
  const void* p3[6] = {m3, n3, k3, l3, s3, cnt3};
  void* out[6] = {om, on, ok, ol, os, ocnt};
  return merge_smems_launch_t<int>(p1, p2, m3 ? p3 : nullptr, first, count,
                                   reseed_of, B, M, pass_of, warps, scratch,
                                   out, stream);
}

extern "C" int merge_smems_launch64(
    const void* m1, const void* n1, const void* k1, const void* l1,
    const void* s1, const void* cnt1, const void* m2, const void* n2,
    const void* k2, const void* l2, const void* s2, const void* cnt2,
    const void* m3, const void* n3, const void* k3, const void* l3,
    const void* s3, const void* cnt3, const void* first, const void* count,
    const void* reseed_of, int B, int M, int pass_of, int warps,
    void* scratch, void* om, void* on, void* ok, void* ol, void* os,
    void* ocnt, void* stream) {
  const void* p1[6] = {m1, n1, k1, l1, s1, cnt1};
  const void* p2[6] = {m2, n2, k2, l2, s2, cnt2};
  const void* p3[6] = {m3, n3, k3, l3, s3, cnt3};
  void* out[6] = {om, on, ok, ol, os, ocnt};
  return merge_smems_launch_t<long long>(p1, p2, m3 ? p3 : nullptr, first,
                                         count, reseed_of, B, M, pass_of,
                                         warps, scratch, out, stream);
}
