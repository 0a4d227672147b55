"""Several devices: read-axis data parallelism over a mesh of devices.

Counterpart of ``bwa_mem_scale_tpu/parallel/mesh.py``. The reference
scales by thread pools and a process-shared index (kt_for
src/kthread.cpp:79, bwa_shm src/bwa_shm.cpp); here, as in the JAX
package, the read batch is split over the devices of a ``Mesh`` and each
device holds a replica of the index (SURVEY.md section 5.8). A shard's
seeding loops stay on its device: no collective runs on the data path.

JAX's ``shard_map`` becomes ``Mesh.run``: shard s runs on ``mesh[s]``
from a host thread of its own (a pool of ``mesh.size`` workers), under
``torch.cuda.device`` and a CUDA stream of its own on a GPU, because the
per-batch glue synchronises the host (BSW's length check, host reads of
sizes) and one thread issuing shard after shard would run the cards one
after another. Results are joined in shard order, so the output never
depends on which shard finishes first. On the CPU the same threads run
the plain path one shard at a time: the shards' many small PyTorch ops,
each dropping and retaking the interpreter lock, ran 16 times slower side
by side than in turn (8 shards of a 16-read batch, 36 s against 2.3 s). ``out_specs=P(axis)`` becomes a concatenation along
axis 0 on the mesh's first device.

A mesh may name a device more than once: ``cpu`` k times stands for the
JAX tests' virtual CPU devices, and ``cuda:0`` twice lets a one-card
machine run the sharded path. A repeated device shares one replica.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import MemOptions
from ..ops.extend import ExtendOut

_LOCAL = threading.local()


def current_shard() -> Optional[int]:
    """The shard a mesh worker thread is running, None outside one."""
    return getattr(_LOCAL, "shard", None)


class Mesh:
    """An ordered tuple of devices, one a shard of the read axis."""

    def __init__(self, devices: Sequence):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self._pool: Optional[ThreadPoolExecutor] = None
        self._streams = {}
        self._cpu_turn = threading.Lock()

    @property
    def size(self) -> int:
        return len(self.devices)

    def __getitem__(self, s: int) -> torch.device:
        return self.devices[s]

    def __iter__(self):
        return iter(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"

    def distinct(self) -> list:
        """The mesh's devices once each, in mesh order."""
        return list(dict.fromkeys(self.devices))

    def _stream(self, s: int):
        st = self._streams.get(s)
        if st is None:
            st = self._streams[s] = torch.cuda.Stream(device=self.devices[s])
        return st

    def _shard(self, s: int, fn, args):
        _LOCAL.shard = s
        dev = self.devices[s]
        try:
            if dev.type != "cuda":
                with self._cpu_turn:
                    return fn(s, dev, *args), None
            st = self._stream(s)
            with torch.cuda.device(dev), torch.cuda.stream(st):
                out = fn(s, dev, *args)
                done = torch.cuda.Event()
                done.record(st)
            return out, done
        finally:
            _LOCAL.shard = None

    def run(self, fn, *per_shard) -> list:
        """[fn(s, mesh[s], *args_s) for each shard s], each shard from a
        worker thread of its own; per_shard holds one sequence of
        mesh.size arguments for each argument of fn. On a GPU the
        caller's current streams wait for each shard's work, and the
        tensors the shards return are marked in use on them."""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(self.size,
                                             thread_name_prefix="mesh")
        futs = [self._pool.submit(self._shard, s, fn, args)
                for s, args in enumerate(zip(*per_shard))]
        outs = []
        for s, f in enumerate(futs):
            out, done = f.result()
            if done is not None:
                cur = torch.cuda.current_stream(self.devices[s])
                cur.wait_event(done)
                for t in _tensors(out):
                    if t.is_cuda:
                        t.record_stream(torch.cuda.current_stream(t.device))
            outs.append(out)
        return outs


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """cuda:0 .. cuda:n-1 (all cards when n_devices is None), or the
    explicit `devices`, which may repeat one."""
    if devices is None:
        n_avail = torch.cuda.device_count()
        n = n_avail if n_devices is None else n_devices
        if n < 1 or n > n_avail:
            raise ValueError(f"make_mesh: {n} devices asked, {n_avail} "
                             f"CUDA devices available")
        devices = [f"cuda:{i}" for i in range(n)]
    return Mesh(devices)


def on_device(x, dev: torch.device):
    """A replica for `dev`: x[dev] from a {device: replica} map, else x
    itself (one replica serving every shard)."""
    return x[dev] if isinstance(x, dict) else x


def split_rows(x, n: int) -> list:
    """n equal contiguous shards of x along axis 0."""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} not divisible by mesh size {n}")
    k = B // n
    return [x[s * k: (s + 1) * k] for s in range(n)]


def globalize(out: dict, shard: int, n_local: int) -> dict:
    """A shard's seed_chain_extend output with pair-space read indices made
    global (the plain field and column 1 of the packed matrix), and
    scalars grown a shard axis, as the JAX package's local_step does."""
    flag = getattr(out, "len_flag", None)
    out = dict(out)
    off = shard * n_local
    out["read"] = torch.where(out["valid"].bool(), out["read"] + off,
                              -1).to(out["read"].dtype)
    pk = out["packed"].clone()
    pk[:, 1] = torch.where(pk[:, 0] == 1, pk[:, 1] + off, -1)
    out["packed"] = pk
    res = ExtendOut({k: (v[None] if v.dim() == 0 else v)
                     for k, v in out.items()})
    res.len_flag = flag
    return res


def concat(outs: list, device: torch.device) -> dict:
    """Per-shard dicts of tensors joined along axis 0 on `device` (the
    shards' BSW length flags joined too)."""
    res = ExtendOut({k: torch.cat([o[k].to(device) for o in outs])
                     for k in outs[0]})
    flags = [o.len_flag for o in outs
             if getattr(o, "len_flag", None) is not None]
    if flags:
        res.len_flag = torch.cat([f.to(device) for f in flags])
    return res


def sharded_align_fn(mesh: Mesh, opt: MemOptions, cfg, L: int,
                     with_fma: bool = False, with_ert: bool = False):
    """A read-sharded seed-chain-extend step.

    Returns f(fmi, dbns, codes [B, L], lens [B][, fma][, ert]) with B
    divisible by the mesh size. Each index argument is one replica or a
    {device: replica} map over the mesh's devices; the shard s of the
    reads runs ``seed_chain_extend`` on mesh[s] against that device's
    replicas. The output is the JAX step's: every key of
    ``seed_chain_extend``'s dict, read ids global, scalars [mesh.size],
    joined on mesh[0]."""
    from ..pipeline.align import seed_chain_extend

    def fn(fmi, dbns, codes, lens, *extra):
        i = 0
        fma = ert = None
        if with_fma:
            fma, i = extra[i], i + 1
        if with_ert:
            ert = extra[i]
        codes = torch.as_tensor(np.asarray(codes, np.int32))
        lens = torch.as_tensor(np.asarray(lens, np.int32))
        n_local = codes.shape[0] // mesh.size

        def step(s, dev, c, ln):
            out = seed_chain_extend(
                on_device(fmi, dev), on_device(dbns, dev), c.to(dev),
                ln.to(dev), L=L, opt=opt, cfg=cfg,
                fma=on_device(fma, dev) if fma is not None else None,
                ert=on_device(ert, dev) if ert is not None else None)
            return globalize(out, s, n_local)

        return concat(mesh.run(step, split_rows(codes, mesh.size),
                               split_rows(lens, mesh.size)), mesh[0])

    return fn


def sharded_emf_fn(mesh: Mesh):
    """A read-sharded EMF probe: f(emf, ref, codes [B, L], lens [B]) with
    the table and the reference one replica or a {device: replica} map,
    the reads split over the mesh; ``emf_cuda.emf_lookup_cuda`` on each
    shard (the kernel on a GPU, the plain probe on the CPU). Every output
    is per read, so the shards join along axis 0."""
    from ..ops.emf_cuda import emf_lookup_cuda

    def fn(emf, ref, codes, lens):
        codes = torch.as_tensor(np.asarray(codes, np.int32))
        lens = torch.as_tensor(np.asarray(lens, np.int32))

        def step(s, dev, c, ln):
            return emf_lookup_cuda(on_device(emf, dev), on_device(ref, dev),
                                   c.to(dev), ln.to(dev))

        return concat(mesh.run(step, split_rows(codes, mesh.size),
                               split_rows(lens, mesh.size)), mesh[0])

    return fn


def pad_to_multiple(codes: np.ndarray, lens: np.ndarray, mult: int):
    """Pad the read batch so it divides evenly over the mesh. Padding
    reads have length 0 and produce no valid regions."""
    B = codes.shape[0]
    rem = (-B) % mult
    if rem == 0:
        return codes, lens, B
    codes = np.concatenate(
        [codes, np.full((rem, codes.shape[1]), 4, dtype=codes.dtype)])
    lens = np.concatenate([lens, np.zeros(rem, dtype=lens.dtype)])
    return codes, lens, B
