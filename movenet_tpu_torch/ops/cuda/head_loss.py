"""Head + cross-entropy kernels: wrappers and launch counts.

``head_fwd`` and ``head_bwd`` are the wrappers of the kernels in
``csrc/head_loss.cu`` (which replace ``head_loss.py:281 _fwd_kernel``
and ``:336 _bwd_kernel``), ``head_fwd_packed`` and ``head_bwd_packed``
those of their packed forms (``:169 _fwd_kernel_packed`` and ``:218
_bwd_kernel_packed``).  For tensors on the CPU they return the plain
versions (``ops/head_loss.head_fwd_plain`` ...); for CUDA tensors they
launch the kernels or raise.  Each call is the kernel launch (the
unpacked backward: two, the row pass and the weight-gradient GEMM over
its bf16 scratch) and one launch of the fixed-order reduction of the
per-block partial sums, and counts one launch in ``launch_counts``.

With a float32 skip ``head_fwd`` and ``head_bwd`` launch the unpacked
kernels' float32 forms (split-TF32 products; the backward's scratch and
dskip float32), counted apart as ``head_fwd_f32`` and ``head_bwd_f32``.
They take 4 <= S <= 128 and 4 <= C <= 256, as the bf16 kernels: up to C
= 128 with W2 staged in shared memory, above it the wide kernels, whose W2
streams through a ring of row slabs and which above S = 64 read the rows
of skip from global memory (``f32_smem``), counted as
``head_fwd_f32_wide`` and ``head_bwd_f32_wide``; the packed kernels take
bf16 only.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from movenet_tpu_torch.ops import head_loss as hl
from movenet_tpu_torch.ops.cuda.stack_kernel import (SMEM_LIMIT, _check,
                                                     _ptr, _raise,
                                                     f32_unbuilt)

KERNEL_SOURCE = "movenet_tpu_torch/csrc/head_loss.cu"
launch_counts: Dict[str, int] = {"head_fwd": 0, "head_bwd": 0,
                                 "head_fwd_packed": 0, "head_bwd_packed": 0,
                                 "head_fwd_f32": 0, "head_bwd_f32": 0,
                                 "head_fwd_f32_wide": 0,
                                 "head_bwd_f32_wide": 0}
# the widest head the float32 kernels hold (z in registers; above
# F32_RING_C W2 streams through a ring of F32_RING_ROWS-row slabs)
F32_MAX_C = 256
F32_RING_C = 128
# the widest skip the bf16 kernels take (above 64 the wide forms: no W1^T
# in the backward, and above C = 128 the forward's y_seq reads skip from
# global memory) and the float32 kernels take (above 64 with C > 128 the
# rows of skip from global memory too)
MAX_S = 128
F32_MAX_S = 128
F32_RING_ROWS = 32
# blocks per launch: two per SM of an H100
BLOCKS = 264

_P = ctypes.c_void_p
_I = ctypes.c_int
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def library():
    global _lib
    if _lib is None:
        from movenet_tpu_torch.ops.cuda import build

        _lib = bind(build.load("head_loss"))
    return _lib


def bind(lib):
    lib.movenet_head_supports.argtypes = [_I, _I]
    lib.movenet_head_supports.restype = _I
    lib.movenet_head_inter.argtypes = [_I, _I, ctypes.c_long]
    lib.movenet_head_inter.restype = ctypes.c_long
    lib.movenet_head_packed_smem.argtypes = [_I]
    lib.movenet_head_packed_smem.restype = ctypes.c_long
    lib.movenet_head_fwd.argtypes = [_P, _P, _I, _I] + [_P] * 7 + [_I] * 8 \
        + [_P]
    lib.movenet_head_fwd.restype = _I
    lib.movenet_head_bwd.argtypes = [_P, _P, _I, _I] + [_P] * 10 \
        + [_I] * 8 + [_P]
    lib.movenet_head_bwd.restype = _I
    lib.movenet_head_f32_supports.argtypes = [_I, _I]
    lib.movenet_head_f32_supports.restype = _I
    lib.movenet_head_f32_smem.argtypes = [_I, _I, _I]
    lib.movenet_head_f32_smem.restype = ctypes.c_long
    lib.movenet_head_f32_inter.argtypes = [_I, _I, ctypes.c_long]
    lib.movenet_head_f32_inter.restype = ctypes.c_long
    lib.movenet_head_fwd_f32.argtypes = [_P, _P, _I, _I] + [_P] * 7 \
        + [_I] * 7 + [_P]
    lib.movenet_head_fwd_f32.restype = _I
    lib.movenet_head_bwd_f32.argtypes = [_P, _P, _I, _I] + [_P] * 10 \
        + [_I] * 7 + [_P]
    lib.movenet_head_bwd_f32.restype = _I
    return lib


def f32_smem(s: int, c: int) -> Dict[str, int]:
    """Bytes of dynamic shared memory a block of the float32 forward and
    backward takes, as csrc/head_loss.cu's ``F32Head`` and ``F32Wide`` lay
    them out: W1 (SP, ldc) and W2 (CP, ldc) in float32 (SP, CP: S, C
    rounded up to 8; ldc, lds: CP, SP rounded up to 32, plus 8), or above
    C = 128 W1 and a ring of two (32, ldc) stages of W2's rows; then the
    forward's biases, block sums and per warp 16 rows of leaky(skip) and a
    row of CP, or the backward's b1, the warps' column sums and their
    leaky(skip) rows.  The wide kernels above S = 64 stage no rows of
    leaky(skip)."""
    sp, cp = -(-s // 8) * 8, -(-c // 8) * 8
    ldc, lds = -(-cp // 32) * 32 + 8, -(-sp // 32) * 32 + 8
    wide = c > F32_RING_C
    w2 = 2 * F32_RING_ROWS if wide else cp
    weights = (sp + w2) * ldc
    rows = 0 if wide and sp > 64 else 16 * lds
    return {"fwd": 4 * (weights + 2 * cp + 2 * 256 + 8 * (rows + cp)),
            "bwd": 4 * (weights + cp + 8 * 2 * cp + 8 * rows)}


def _f32_widths(s: int, c: int) -> None:
    """Raise where the float32 head is not built at (S, C)."""
    if s > F32_MAX_S:
        raise NotImplementedError(
            f"the float32 head kernels take 4 <= S <= {F32_MAX_S}; got "
            f"S={s} in torch.float32 (ROADMAP.md B.4: the head kernels "
            f"take S <= {MAX_S})")
    smem = f32_smem(s, c)
    if c > F32_MAX_C or max(smem.values()) > SMEM_LIMIT:
        raise NotImplementedError(
            f"the float32 head kernels take 4 <= S <= {F32_MAX_S} and 4 <= C "
            f"<= {F32_MAX_C}; got S={s}, C={c} in torch.float32 (shared "
            f"memory {smem} bytes; ROADMAP.md B.4: the head kernels take C "
            f"<= {F32_MAX_C})")


def _common(lib, skip, pack, w1, b1, w2, b2, tgt_off):
    batch, t, s = skip.shape
    c = w2.shape[1]
    dev = skip.device
    if skip.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"the head kernels take the bfloat16 or float32 compute dtype, "
            f"got {skip.dtype}")
    _check("skip", skip, skip.dtype, device=dev)
    _check("targets_pack", pack, torch.int32, device=dev)
    if pack.shape[0] != t or pack.shape[1] < tgt_off + batch:
        raise ValueError(f"targets_pack has shape {tuple(pack.shape)}, "
                         f"needs ({t}, >= {tgt_off + batch})")
    _check("w1", w1, torch.float32, (s, c), dev)
    _check("b1", b1, torch.float32, (c,), dev)
    _check("w2", w2, torch.float32, (c, c), dev)
    _check("b2", b2, torch.float32, (c,), dev)
    if batch * t >= 2 ** 31:
        raise ValueError(f"the head kernels take B*T < 2^31 rows, got "
                         f"{batch * t}")
    if not lib.movenet_head_supports(s, c):
        raise NotImplementedError(
            f"the head kernels take 4 <= S <= {MAX_S} and 4 <= C <= 256, "
            f"multiples of 4; got S={s}, C={c} (ROADMAP.md B.4)")
    if skip.dtype == torch.float32:
        _f32_widths(s, c)
    return batch, t, s, c, dev


def _packed_check(skip, pack, c):
    batch, t, s = skip.shape
    if skip.dtype != torch.bfloat16:
        raise ValueError(f32_unbuilt("the packed head kernels", "packed",
                                     skip.dtype))
    if not (s == 64 and c == 64 and t % 2 == 0 and pack.shape[1] == batch):
        raise ValueError(
            f"the packed head kernels take S = C = 64, an even T and "
            f"targets exactly B wide; got S={s}, C={c}, T={t}, targets "
            f"{tuple(pack.shape)}")


def run_fwd(lib, skip, pack, w1, b1, w2, b2, rf, parity, tgt_off=0,
            save_p=True, stream=None, blocks=BLOCKS, packed=False):
    """The forward (``packed``: its packed form, which saves no p)."""
    batch, t, s, c, dev = _common(lib, skip, pack, w1, b1, w2, b2, tgt_off)
    if packed:
        _packed_check(skip, pack, c)
    p = torch.empty(batch, t, c, dtype=torch.float32, device=dev) \
        if save_p and not packed else None
    part = torch.empty(blocks, 2, dtype=torch.float32, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    if skip.dtype == torch.float32:
        err = lib.movenet_head_fwd_f32(
            _ptr(skip), _ptr(pack), pack.shape[1], tgt_off, _ptr(w1),
            _ptr(b1), _ptr(w2), _ptr(b2), _ptr(p), _ptr(part), _ptr(out),
            batch, t, s, c, rf, int(parity), blocks, stream)
        _raise(err, "head_fwd_f32")
        return out[0], out[1], p
    err = lib.movenet_head_fwd(
        _ptr(skip), _ptr(pack), pack.shape[1], tgt_off, _ptr(w1), _ptr(b1),
        _ptr(w2), _ptr(b2), _ptr(p), _ptr(part), _ptr(out),
        batch, t, s, c, rf, int(parity), int(packed), blocks, stream)
    _raise(err, "head_fwd_packed" if packed else "head_fwd")
    return out[0], out[1], p


def run_bwd(lib, skip, pack, p, w1, b1, w2, b2, rf, parity, dloss,
            tgt_off=0, stream=None, blocks=BLOCKS):
    """The backward; ``p`` None runs its packed form, which rebuilds the
    softmax from skip."""
    batch, t, s, c, dev = _common(lib, skip, pack, w1, b1, w2, b2, tgt_off)
    inter = None
    if p is None:
        _packed_check(skip, pack, c)
    else:
        _check("p", p, torch.float32, (batch, t, c), dev)
    f32 = skip.dtype == torch.float32
    if p is not None:
        inter = torch.empty(
            (lib.movenet_head_f32_inter if f32 else lib.movenet_head_inter)(
                s, c, batch * t), dtype=skip.dtype, device=dev)
    dloss = torch.as_tensor(dloss, dtype=torch.float32,
                            device=dev).reshape(1).contiguous()
    dskip = torch.empty_like(skip)
    n = s * c + c * c + 2 * c
    part = torch.empty(blocks, n, dtype=torch.float32, device=dev)
    grads = torch.empty(n, dtype=torch.float32, device=dev)
    if f32:
        err = lib.movenet_head_bwd_f32(
            _ptr(skip), _ptr(pack), pack.shape[1], tgt_off, _ptr(p),
            _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2), _ptr(dloss), _ptr(dskip),
            _ptr(inter), _ptr(part), _ptr(grads), batch, t, s, c, rf,
            int(parity), blocks, stream)
        _raise(err, "head_bwd_f32")
        return _split_grads(grads, s, c, dskip)
    err = lib.movenet_head_bwd(
        _ptr(skip), _ptr(pack), pack.shape[1], tgt_off, _ptr(p), _ptr(w1),
        _ptr(b1), _ptr(w2), _ptr(b2), _ptr(dloss), _ptr(dskip), _ptr(inter),
        _ptr(part), _ptr(grads), batch, t, s, c, rf, int(parity),
        int(p is None), blocks, stream)
    _raise(err, "head_bwd_packed" if p is None else "head_bwd")
    return _split_grads(grads, s, c, dskip)


def _split_grads(grads, s, c, dskip):
    """(dskip, dw1, db1, dw2, db2) from the flat dw1 | db1 | dw2 | db2."""
    dw1 = grads[:s * c].reshape(s, c)
    db1 = grads[s * c:s * c + c]
    dw2 = grads[s * c + c:s * c + c + c * c].reshape(c, c)
    db2 = grads[s * c + c + c * c:]
    return dskip, dw1, db1, dw2, db2


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _counted(name, skip, c):
    """The launch count of the unpacked form ``name`` takes at this dtype
    and C."""
    if skip.dtype != torch.float32:
        return name
    return name + ("_f32_wide" if c > F32_RING_C else "_f32")


def head_fwd(skip, pack, w1, b1, w2, b2, rf: int, parity: bool,
             tgt_off: int = 0, save_p: bool = True):
    """(loss_sum, match_count, p or None): plain on the CPU, the forward
    kernel on CUDA tensors."""
    if not skip.is_cuda:
        return hl.head_fwd_plain(skip, pack, w1, b1, w2, b2, rf, parity,
                                 tgt_off, save_p)
    out = run_fwd(library(), skip, pack, w1, b1, w2, b2, rf, parity,
                  tgt_off, save_p, _stream(skip))
    launch_counts[_counted("head_fwd", skip, w2.shape[1])] += 1
    return out


def head_bwd(skip, pack, p, w1, b1, w2, b2, rf: int, parity: bool, dloss,
             tgt_off: int = 0):
    """(dskip, dw1, db1, dw2, db2): plain on the CPU, the backward kernel
    on CUDA tensors."""
    if not skip.is_cuda:
        return hl.head_bwd_plain(skip, pack, p, w1, b1, w2, b2, rf, parity,
                                 dloss, tgt_off)
    out = run_bwd(library(), skip, pack, p, w1, b1, w2, b2, rf, parity,
                  dloss, tgt_off, _stream(skip))
    launch_counts[_counted("head_bwd", skip, w2.shape[1])] += 1
    return out


def head_fwd_packed(skip, pack, w1, b1, w2, b2, rf: int, parity: bool):
    """(loss_sum, match_count) of the packed route: plain on the CPU, the
    packed forward kernel on CUDA tensors."""
    if not skip.is_cuda:
        return hl.head_fwd_packed_plain(skip, pack, w1, b1, w2, b2, rf,
                                        parity)
    loss, match, _ = run_fwd(library(), skip, pack, w1, b1, w2, b2, rf,
                             parity, 0, False, _stream(skip), packed=True)
    launch_counts["head_fwd_packed"] += 1
    return loss, match


def head_bwd_packed(skip, pack, w1, b1, w2, b2, rf: int, parity: bool,
                    dloss):
    """(dskip, dw1, db1, dw2, db2) of the packed route: plain on the CPU,
    the packed backward kernel on CUDA tensors."""
    if not skip.is_cuda:
        return hl.head_bwd_packed_plain(skip, pack, w1, b1, w2, b2, rf,
                                        parity, dloss)
    out = run_bwd(library(), skip, pack, None, w1, b1, w2, b2, rf, parity,
                  dloss, 0, _stream(skip))
    launch_counts["head_bwd_packed"] += 1
    return out


__all__ = ["head_fwd", "head_bwd", "head_fwd_packed", "head_bwd_packed",
           "launch_counts", "reset_launch_counts", "KERNEL_SOURCE"]
