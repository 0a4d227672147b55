// The SA lookup's LF walk for one BWT row (get_sa_entry_compressed,
// src/FMI_search.cpp:2107-2379), shared by csrc/smem.cu's bare walk
// (sa_walk_kernel, behind ops/sal.py::sa_lookup) and csrc/sal.cu's fused
// SA lookup stage (sal_walk_kernel, behind ops/sal.py::expand_and_lookup).
//
// From row sp: a sampled row (sp & mask == 0) gives
// sa_samples[sp >> compx] + offset; otherwise one checkpoint row gives the
// base b = BWT[sp] (the mask whose bit 31 - y is set, MSB first, or 4 at
// the sentinel row, which gives offset) and occ(sp, b), and the walk moves
// to count[b] + occ with offset + 1. The sample index is clamped to
// [0, n_samples - 1], as the lockstep's gather clamps it. At compx 0 (the
// full SA resident) the mask is 0, so the first step is the sample: a
// single gather. `steps` grows by one a row or sample loaded.

#pragma once

#include "fmi_step.cuh"

namespace {

template <typename P>
__device__ __forceinline__ P sa_walk(const Fmi<P>& f,
                                     const P* __restrict__ samples,
                                     P n_samples, int compx, P sp,
                                     int& steps) {
  const P mask = ((P)1 << compx) - 1;
  int offset = 0;
  for (;;) {
    ++steps;
    if ((sp & mask) == 0) {                        // a sampled row
      P i = sp >> compx;
      i = i < 0 ? 0 : (i >= n_samples ? n_samples - 1 : i);
      return __ldg(samples + i) + offset;
    }
    const P r = row_of(f, sp);                     // occ_b_and_base
    const int4* row = f.cp + 2 * (size_t)r;
    const int4 cnt = __ldg(row);
    const int4 msk = __ldg(row + 1);
    const int y = (int)(sp & 31);
    const unsigned bit = 1u << (31 - y);
    const int b = ((unsigned)msk.x & bit) ? 0
                  : ((unsigned)msk.y & bit) ? 1
                  : ((unsigned)msk.z & bit) ? 2
                  : ((unsigned)msk.w & bit) ? 3 : 4;
    if (b == 4) return offset;                     // the sentinel row
    sp = cval(f, b) + row_count(f, sel4(cnt, b), b, n_steps(f, b), r)
         + __popc((unsigned)sel4(msk, b) & top_bits(y));
    ++offset;
  }
}

}  // namespace
