"""Two processes, each aligning its half of a global batch on a local
mesh, against one process: the port's counterpart of the JAX package's
``tools/multiproc_dp_test.py``.

    python -m bwa_mem_scale_tpu_torch.tools.multiproc_dp           # run
    python -m bwa_mem_scale_tpu_torch.tools.multiproc_dp --worker RANK PORT

The orchestrator starts two workers that join a ``torch.distributed``
gloo group over localhost. Each builds the same demo index and reads
(seeded), runs its half of the 16-read batch through ``sharded_align_fn``
on a local mesh of 2 CPU shards, and makes the read ids global; rank 0
gathers both halves' regions (``all_gather_object``) and compares them
with a one-process ``seed_chain_extend`` over the whole batch. The JAX
harness needs CPU devices that federate across processes, which jax
0.9.0's do not; gloo runs on the CPU, so this one runs anywhere. Exits 0
and prints "MULTIPROCESS DP TEST PASSED" when the regions match.
"""

from __future__ import annotations

import socket
import subprocess
import sys

N_PROC = 2
LOCAL_SHARDS = 2
GENOME_BP = 12000
B = 16          # global batch
L = 64


def regions_by_read(packed, offset: int = 0) -> dict:
    """packed int32 [PX, 14] -> {global read: sorted [(qb, qe, score, rb,
    re)]}, read ids shifted by `offset`."""
    out = {}
    for row in packed.tolist():
        if not row[0]:
            continue
        rb = (row[11] << 31) | row[10]
        re = (row[13] << 31) | row[12]
        out.setdefault(row[1] + offset, []).append(
            (row[2], row[3], row[4], rb, re))
    return {k: sorted(v) for k, v in out.items()}


def worker(rank: int, port: int) -> int:
    import torch
    import torch.distributed as dist
    from ..config import MemOptions
    from ..index.build import build_index
    from ..models.aligner import demo_genome, simulate_reads
    from ..ops.chain import DeviceBns
    from ..ops.occ import DeviceFMIndex
    from ..parallel.mesh import Mesh, sharded_align_fn
    from ..pipeline.align import PipelineConfig, seed_chain_extend

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=N_PROC, rank=rank)
    try:
        opt = MemOptions()
        cfg = PipelineConfig(max_coords=64, max_chains=8,
                             max_seeds_per_chain=8, max_regs=8)
        # deterministic index and reads: every process builds the same
        idx = build_index(demo_genome(GENOME_BP, 0))
        codes, lens = simulate_reads(idx.bns, B, L, err_rate=0.02)
        fmi = DeviceFMIndex.from_host(idx, "cpu")
        dbns = DeviceBns.from_host(idx.bns, "cpu")
        half = B // N_PROC
        lo = rank * half
        fn = sharded_align_fn(Mesh(["cpu"] * LOCAL_SHARDS), opt, cfg, L)
        out = fn(fmi, dbns, codes[lo: lo + half], lens[lo: lo + half])
        mine = regions_by_read(out["packed"].numpy(), offset=lo)
        print(f"proc {rank}: reads {sorted(mine)}", flush=True)
        parts = [None] * N_PROC
        dist.all_gather_object(parts, mine)
        ok = [True]
        if rank == 0:
            got = {}
            for part in parts:
                got.update(part)
            ref = seed_chain_extend(fmi, dbns, torch.as_tensor(codes),
                                    torch.as_tensor(lens), L=L, opt=opt,
                                    cfg=cfg)
            want = regions_by_read(ref["packed"].numpy())
            ok = [got == want]
            n_regs = sum(len(v) for v in want.values())
            print(f"proc 0: {'MATCH' if ok[0] else 'MISMATCH'} "
                  f"({len(want)} reads, {n_regs} regions)", flush=True)
            for r in sorted(set(got) | set(want)):
                if got.get(r) != want.get(r):
                    print(f"  read {r}:\n    got  {got.get(r)}\n    want "
                          f"{want.get(r)}", flush=True)
        dist.broadcast_object_list(ok, src=0)
        return 0 if ok[0] else 1
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        return worker(int(argv[1]), int(argv[2]))
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bwa_mem_scale_tpu_torch.tools.multiproc_dp",
         "--worker", str(i), str(port)]) for i in range(N_PROC)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    if any(rcs):
        print("MULTIPROCESS DP TEST FAILED", rcs)
        return 1
    print("MULTIPROCESS DP TEST PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
