"""The device stage table of ``mem -v 4``.

Counterpart of ``bwa_mem_scale_tpu/pipeline/stageprof.py``. The
reference prints a per-phase cycle matrix after a run (display_stats,
src/profiling.cpp:87-307). Here, as in the JAX package, one
representative batch runs incremental prefixes of the device program:
seeding alone, then + the SA lookup, then + chaining and the chain
filter, then the full ``seed_chain_extend``; successive differences are
the stages' costs. Each prefix runs twice and the second run is timed,
from a device synchronisation before it to one after it, so the table
holds no build or first-call cost. The port keeps its accumulated
``StageProfile`` (synchronised stage seconds over every main batch)
beside this table.
"""

from __future__ import annotations

import sys
import time

from ..device import synchronize


def device_stage_profile(aligner, codes, lens, file=None) -> dict:
    """Print the incremental stage table for one batch (codes [B, L],
    lens [B] on the host) to `file` (sys.stderr at the call); returns
    {prefix name: seconds}."""
    file = file or sys.stderr
    from . import align
    from ..ops.sal import expand_and_lookup
    opt, cfg = aligner.opt, aligner.cfg
    fmi, dbns, dev = aligner.fmi, aligner.dbns, aligner.device
    c, ln = aligner._to_device(codes, lens)
    B, L = (int(v) for v in codes.shape)
    kw = dict(opt=opt, cfg=cfg)

    def p_seed():
        # the one-hot engine at full depth, as the JAX package's table
        return align.collect_seeds(fmi, c, ln, L, fma=aligner.dfma,
                                   ert=aligner.dert, full_depth=True, **kw)

    def p_sal():
        return expand_and_lookup(fmi, p_seed(), opt.max_occ, cfg.max_coords)

    def p_chain():
        bufs = p_seed()
        rbeg, seed_idx, cv, _, _ = expand_and_lookup(fmi, bufs, opt.max_occ,
                                                     cfg.max_coords)
        return align.chain_and_filter(dbns, bufs, rbeg, seed_idx, cv, ln,
                                      **kw)

    def p_full():
        return aligner._extend(fmi, dbns, c, ln, L=L, fma=aligner.dfma,
                               ert=aligner.dert)

    times = {}
    for name, fn in (("seed", p_seed), ("+sa_lookup", p_sal),
                     ("+chain/filter", p_chain), ("+extend(full)", p_full)):
        fn()                                  # the first call, untimed
        synchronize(dev)
        t0 = time.perf_counter()
        fn()
        synchronize(dev)
        times[name] = time.perf_counter() - t0
    print(f"\nDevice stage profile (B={B}, L={L}, warm; incremental "
          f"prefixes):", file=file)
    prev = 0.0
    for name, t in times.items():
        print(f"  {name:<14} {t:7.3f}s  (stage {max(t - prev, 0.0):7.3f}s"
              f", {B / t:8.0f} reads/s cumulative)", file=file)
        prev = t
    return times
