"""The ERT's trie descent through the hand-written CUDA kernel of
csrc/ert.cu.

``ert_extend_all_positions_cuda`` has the signature of its plain version,
``ops/ert.py::ert_extend_all_positions``, and replaces the
``jax.lax.while_loop`` of the JAX package's ``ops/ert.py`` (one thread a
(read, start column) lane, one block a read). On CUDA tensors it launches
the kernel once or raises; on CPU tensors it runs the plain version.
There is no fallback from the kernel to its plain version. The kernel has
an int32 and an int64 form, picked by ``pos_dtype`` (``fmi.pos_dtype``),
as every FM-walk kernel of the port. The wrapper keeps a ``launches``
count (both forms), a ``launches64`` count (the int64 form) and the last
call's per-lane ``last_steps`` ([2, B, L] int32: node steps, then leaf
steps). With ``stats`` it adds the longest lane's steps (``stats_key``
with "ticks" read as "steps": ``ert_steps_p1`` / ``ert_steps_p2``) and
the total (``ert_total_p1`` / ``ert_total_p2``) as device tensors.

``ert_extend_twin`` is the kernel's loop in plain Python on numpy arrays,
one lane after another, a test of the kernel's control flow on the CPU at
small sizes; it counts what the kernel counts. The source is compiled
with nvcc into ``build/torch_kernels/libert_cuda.so`` at first use
(``ops/nvcc_build.py``).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import nvcc_build
from .smem_cuda import _SUFFIX
from .sweep_cuda import _add_stats

_vp, _ci, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ERT = [_vp, _ll, _vp, _ll] + [_vp] * 3 + [_ci] * 5 + [_vp] * 3
LIB = nvcc_build.Library("ert.cu", "ert_cuda", {
    f"ert_extend_launch{sfx}": _ERT for sfx in _SUFFIX.values()})
build = LIB.build            # compile csrc/ert.cu; returns the library path

# the kernel's outputs: its [4][B][L] int32, [6][B][L] position and
# [3][B][L] byte planes, in order
_I_PLANES = ("E", "f3_E", "node_steps", "leaf_steps")
_P_PLANES = ("k", "l", "s", "f3_k", "f3_l", "f3_ss")
_B_PLANES = ("f3_s", "died_s", "valid")


def ert_extend_all_positions_cuda(ert, ref, codes, lens, min_intv,
                                  check_initial: bool, p3_max_intv: int = 0,
                                  p3_stop: int = 0,
                                  pos_dtype: torch.dtype = torch.int64,
                                  seq_len: int = None, stats: dict = None,
                                  stats_key: str = "ert_ticks") -> dict:
    """Drop-in for ``ert.ert_extend_all_positions`` (equal arrays): one
    launch of ert_extend_kernel on CUDA tensors, the plain version on CPU
    ones. `ert` a DeviceErt, ref uint8, codes [B, L] and lens [B] int32,
    min_intv [B] (held as int32), all on one device."""
    from .ert import ert_extend_all_positions, ert_keys
    if codes.device.type == "cpu":
        return ert_extend_all_positions(
            ert, ref, codes, lens, min_intv, check_initial, p3_max_intv,
            p3_stop, pos_dtype, seq_len, stats, stats_key)
    what = "ert_extend_all_positions_cuda"
    dev = codes.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (ert.rec, ref, lens, min_intv)):
        raise ValueError(f"{what}: tensors on {dev} and elsewhere")
    B, L = codes.shape
    l_ref = ref.shape[0] if seq_len is None else int(seq_len)
    if (pos_dtype not in _SUFFIX or codes.dtype != torch.int32
            or lens.dtype != torch.int32 or ref.dtype != torch.uint8
            or ref.dim() != 1 or not 0 < l_ref <= ref.shape[0]
            or ert.rec.dtype != torch.int64 or ert.rec.dim() != 3
            or tuple(ert.rec.shape[1:]) != (4, 2)
            or not ert.rec.is_contiguous()
            or not 0 <= ert.root < ert.rec.shape[0]
            or lens.shape != (B,) or min_intv.shape != (B,)):
        raise ValueError(f"{what}: shapes or dtypes differ from the plain "
                         f"version's")
    merge_p3 = p3_max_intv > 0 and p3_stop > 0
    out_i = torch.empty((4, B, L), dtype=torch.int32, device=dev)
    out_p = torch.empty((6, B, L), dtype=pos_dtype, device=dev)
    out_b = torch.empty((3, B, L), dtype=torch.uint8, device=dev)
    if B and L:
        c, ln, r = codes.contiguous(), lens.contiguous(), ref.contiguous()
        mi = min_intv.to(torch.int32).contiguous()
        LIB.launch(dev, f"ert_extend_launch{_SUFFIX[pos_dtype]}",
                   ert.rec.data_ptr(), ert.root, r.data_ptr(), l_ref,
                   c.data_ptr(), ln.data_ptr(), mi.data_ptr(), B, L,
                   int(check_initial), p3_max_intv, p3_stop,
                   out_i.data_ptr(), out_p.data_ptr(), out_b.data_ptr())
        _EXTEND_FN.launches += 1
        _EXTEND_FN.launches64 += pos_dtype == torch.int64
        _add_stats(stats, stats_key, out_i[2] + out_i[3])
    planes = {**dict(zip(_I_PLANES, out_i)), **dict(zip(_P_PLANES, out_p)),
              **{f: v.view(torch.bool) for f, v in zip(_B_PLANES, out_b)}}
    _EXTEND_FN.last_steps = out_i[2:4]
    return {f: planes[f] for f in ert_keys(merge_p3)}


# kernel launches since the last reset (main-path proof in chip_smoke.py):
# all, and the int64 form's; the per-lane node and leaf steps of the last
# call
ert_extend_all_positions_cuda.launches = 0
ert_extend_all_positions_cuda.launches64 = 0
ert_extend_all_positions_cuda.last_steps = None  # [2, B, L] int32
# the wrapper itself, for its counts: a caller may swap the module's name
_EXTEND_FN = ert_extend_all_positions_cuda


def ert_extend_twin(rec, root: int, ref, seq_len: int, codes, lens,
                    min_intv, check_initial: bool, p3_max_intv: int = 0,
                    p3_stop: int = 0, wide: bool = False) -> dict:
    """csrc/ert.cu's ert_extend_kernel in plain Python on numpy arrays,
    one lane after another: rec [N + 1, 4, 2] int64 (DeviceErt.rec), the
    root row, ref uint8 (seq_len bounds the leaf walk); `wide` for the
    int64 form's planes. Returns every output plane of the kernel by name,
    the node and leaf steps included."""
    rec = np.asarray(rec)
    ref = np.asarray(ref)
    codes = np.asarray(codes)
    B, L = codes.shape
    pd = np.int64 if wide else np.int32
    merge = p3_max_intv > 0 and p3_stop > 0
    out = {f: np.zeros((B, L), np.int32) for f in _I_PLANES}
    out.update({f: np.zeros((B, L), pd) for f in _P_PLANES})
    out.update({f: np.zeros((B, L), bool) for f in _B_PLANES})
    clip = lambda c: min(max(c, 0), 3)
    mask = (1 << 24) - 1
    for b in range(B):
        n_len, mi = int(lens[b]), int(min_intv[b])

        def code(i):
            return min(int(codes[b, i]), 4) if i < L else 4

        for p in range(L):
            c0 = code(p)
            base_ok = p < n_len and c0 < 4
            enc, packed = (int(v) for v in rec[root, clip(c0)])
            s, lop = packed & mask, packed >> 24
            leaf0 = enc <= -2
            k = -enc - 2 if leaf0 else lop
            lp = lop - p if leaf0 else 0
            act = base_ok and (not check_initial or s >= mi) and s > 0
            E = p + 1 if base_ok and s >= (mi if check_initial else 1) \
                else p
            cur = enc if act else -1
            if not act:
                k = s = 0
            died = f3s = False
            f3k = f3ss = f3E = node_steps = leaf_steps = 0
            t = 1
            while act:                           # one step a column
                j = p + t
                a = code(j)
                if j >= n_len or a >= 4:
                    break
                ac = clip(a)
                nk, nlp, ncur = k, lp, cur
                if cur >= 0:                     # a node: its child's pair
                    n_enc, n_packed = (int(v) for v in rec[cur, ac])
                    ns = n_packed & mask
                    if n_enc <= -2:
                        nk, nlp = -n_enc - 2, (n_packed >> 24) - p
                    else:
                        nk = n_packed >> 24
                    ncur = n_enc if n_enc >= 0 else -1
                    node_steps += 1
                else:                            # a leaf: one reference byte
                    rpos = lp + j
                    ns = int(0 <= rpos < seq_len and int(ref[rpos]) == ac)
                    leaf_steps += 1
                if (merge and not f3s and ns < p3_max_intv
                        and t + 1 >= p3_stop):
                    f3s, f3E, f3k, f3ss = True, j, nk, ns
                if ns < mi:
                    died = merge
                    break
                E, k, s, lp, cur = j + 1, nk, ns, nlp, ncur
                t += 1
            for f, v in (("E", E), ("f3_E", f3E), ("node_steps", node_steps),
                         ("leaf_steps", leaf_steps), ("k", k), ("s", s),
                         ("f3_k", f3k), ("f3_ss", f3ss), ("f3_s", f3s),
                         ("died_s", died), ("valid", base_ok)):
                out[f][b, p] = v
    return out
