// The cost of one dependent round of a warp on Hopper (sm_90a): the
// yardstick of the chaining kernels' latency floor (csrc/chain.cu counts
// each read's rounds; bwa_mem_scale_tpu_torch/tools/round_cost.py times
// this kernel and multiplies).
//
// One warp, alone in its block, runs n_rounds rounds over a table of
// n_words int32 (a power of 2) staged in shared memory. A round is what
// the chaining kernels' rounds have in common, each step waiting on the
// one before: lane l loads tab[x_l], takes by shuffle the value loaded by
// the lane that its own value names (v & 31), and votes on the low bit
// of what it took; the next x_l is (taken + popcount(vote) + l) mod
// n_words. So a round is a shared-memory load, a shuffle and a ballot in
// series, and nothing of one round can start before the last ended. The
// lane's last x goes to out[l], so no round can be dropped.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARP)
round_probe_kernel(const int32_t* __restrict__ tab_in, int n_words,
                   int n_rounds, int32_t* __restrict__ out) {
  extern __shared__ int32_t tab[];
  const int l = threadIdx.x;
  for (int i = l; i < n_words; i += WARP) tab[i] = tab_in[i];
  __syncwarp();
  const unsigned mask = (unsigned)n_words - 1;
  unsigned x = l;
  for (int t = 0; t < n_rounds; ++t) {
    const int v = tab[x];
    const int u = __shfl_sync(FULL, v, v & (WARP - 1));
    const unsigned vote = __ballot_sync(FULL, u & 1);
    x = ((unsigned)u + __popc(vote) + l) & mask;
  }
  out[l] = (int32_t)x;
}

}  // namespace

// Launch round_probe_kernel on `stream`: one block of one warp, n_words
// (a power of 2, at most 8,192) words of shared memory; out holds 32
// int32. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// another n_words or a negative n_rounds.
extern "C" int round_probe_launch(const void* tab, int n_words, int n_rounds,
                                  void* out, void* stream) {
  if (n_words <= 0 || n_words > 8192 || (n_words & (n_words - 1))
      || n_rounds < 0)
    return (int)cudaErrorInvalidValue;
  round_probe_kernel<<<1, WARP, 4 * (size_t)n_words, (cudaStream_t)stream>>>(
      (const int32_t*)tab, n_words, n_rounds, (int32_t*)out);
  return (int)cudaGetLastError();
}
