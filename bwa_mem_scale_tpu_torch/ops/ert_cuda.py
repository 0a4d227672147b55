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
one lane after another (the node steps, then the leaf walk a run of
matches at a time, 16 reference bytes a word), a test of the kernel's
control flow on the CPU at small sizes; it counts what the kernel counts
and each lane's leaf words. The source is compiled
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


WORD = 16                    # reference bytes a leaf load (csrc/ert.cu)


def run_end(ref, q, j: int, rpos: int, limit: int):
    """csrc/ert.cu's run_end: (the first column c in [j, limit) whose code
    in q (clipped, padded with N codes after it) is an N or differs from
    ref[rpos + c - j], else limit; the 16-byte words of ref it read).
    Words are aligned at multiples of 16 of ref's index, the first one's
    bytes before rpos masked off; the caller keeps limit <= seq_len - lp,
    so every word starts before seq_len."""
    off = rpos & 15
    a, col, words = rpos - off, j - off, 0
    while True:
        words += 1
        win = np.zeros(WORD, np.int64)
        win[:len(ref[a:a + WORD])] = ref[a:a + WORD]
        cw = np.full(WORD, 4, np.int64)      # the N codes before column 0
        lo = max(col, 0)
        cw[lo - col:] = q[lo:col + WORD]
        stop = (win != cw) | (cw == 4)
        stop[:off] = False
        if stop.any():
            return min(col + int(np.argmax(stop)), limit), words
        col, a, off = col + WORD, a + WORD, 0
        if col >= limit:
            return limit, words


def ert_extend_twin(rec, root: int, ref, seq_len: int, codes, lens,
                    min_intv, check_initial: bool, p3_max_intv: int = 0,
                    p3_stop: int = 0, wide: bool = False) -> dict:
    """csrc/ert.cu's ert_extend_kernel in plain Python on numpy arrays,
    one lane after another: rec [N + 1, 4, 2] int64 (DeviceErt.rec), the
    root row, ref uint8 (seq_len bounds the leaf walk); `wide` for the
    int64 form's planes. The node steps one pair a step, the leaf walk a
    run of matches at a time through ``run_end`` (16 reference bytes a
    word), the leaf steps added a run at a time. Returns every output
    plane of the kernel by name, the node and leaf steps included, and
    each lane's leaf words (``leaf_words``)."""
    rec = np.asarray(rec)
    ref = np.asarray(ref)
    codes = np.asarray(codes)
    B, L = codes.shape
    pd = np.int64 if wide else np.int32
    merge = p3_max_intv > 0 and p3_stop > 0
    out = {f: np.zeros((B, L), np.int32) for f in _I_PLANES}
    out.update({f: np.zeros((B, L), pd) for f in _P_PLANES})
    out.update({f: np.zeros((B, L), bool) for f in _B_PLANES})
    out["leaf_words"] = np.zeros((B, L), np.int64)
    mask = (1 << 24) - 1
    pad = -(-L // 16) * 16 + 2 * WORD
    for b in range(B):
        n_len, mi = int(lens[b]), int(min_intv[b])
        q = np.full(pad, 4, np.int64)            # the staged codes
        q[:L] = np.where(codes[b] >= 4, 4, np.maximum(codes[b], 0))
        for p in range(L):
            c0 = int(q[p])
            base_ok = p < n_len and c0 < 4
            enc, packed = (int(v) for v in rec[root, min(c0, 3)])
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
            st = dict(died=False, f3s=False, f3k=0, f3ss=0, f3E=0)

            def record(j, ns, kk):
                if (merge and not st["f3s"] and ns < p3_max_intv
                        and j - p + 1 >= p3_stop):
                    st.update(f3s=True, f3E=j, f3k=kk, f3ss=ns)

            node_steps = leaf_steps = words = 0
            j = p + 1
            while act and cur >= 0:              # node steps, one a column
                a = int(q[j])
                if j >= n_len or a >= 4:
                    act = False
                    break
                n_enc, n_packed = (int(v) for v in rec[cur, a])
                ns = n_packed & mask
                nk = -n_enc - 2 if n_enc <= -2 else n_packed >> 24
                node_steps += 1
                record(j, ns, nk)
                if ns < mi:
                    st["died"] = merge
                    act = False
                    break
                if n_enc <= -2:
                    lp = (n_packed >> 24) - p
                E, k, s, cur = j + 1, nk, ns, (n_enc if n_enc >= 0 else -1)
                j += 1
            if act and mi > 1:                   # one leaf step ends it
                a = int(q[j])
                if j < n_len and a < 4:
                    rpos = lp + j
                    ns = int(0 <= rpos < seq_len and int(ref[rpos]) == a)
                    leaf_steps += 1
                    record(j, ns, k)
                    st["died"] = merge
            elif act:                            # runs of matches
                while True:
                    rpos = lp + j
                    lim = min(n_len, seq_len - lp)
                    if rpos < 0 or lim <= j:
                        e = j
                    else:
                        e, nw = run_end(ref, q, j, rpos, lim)
                        words += nw
                    if e > j:                    # leaf steps of size 1
                        leaf_steps += e - j
                        c3 = max(j, p + p3_stop - 1)
                        if p3_max_intv > 1 and c3 < e:
                            record(c3, 1, k)
                        E, s = e, 1
                    if e >= n_len or q[e] >= 4:
                        break
                    leaf_steps += 1              # a step of size 0
                    record(e, 0, k)
                    if 0 < mi:
                        st["died"] = merge
                        break
                    E, s, j = e + 1, 0, e + 1
            for f, v in (("E", E), ("f3_E", st["f3E"]),
                         ("node_steps", node_steps),
                         ("leaf_steps", leaf_steps), ("k", k), ("s", s),
                         ("f3_k", st["f3k"]), ("f3_ss", st["f3ss"]),
                         ("f3_s", st["f3s"]), ("died_s", st["died"]),
                         ("valid", base_ok), ("leaf_words", words)):
                out[f][b, p] = v
    return out
