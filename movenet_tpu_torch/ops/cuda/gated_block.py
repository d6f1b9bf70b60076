"""Gated-block kernels: wrappers and launch counts.

``gated_block_fwd`` and ``gated_block_bwd`` are the wrappers of the
kernels in ``csrc/gated_block.cu`` (which replace ``gated_block.py:91
_fwd_kernel`` and ``:168 _bwd_kernel``).  For tensors on the CPU they
return the plain versions (``ops/gated_block.gated_block_fwd_plain`` /
``gated_block_bwd_plain``); for CUDA tensors they launch the kernels or
raise.  A forward call is one grid launch; a backward call six (the
layer sweep, the W_fg and W_out weight-gradient grids, the anti-causal
carry pass, and the fixed-order reductions of the per-block partials).
Each call counts one launch in ``launch_counts``.  ``run_fwd`` and
``run_bwd`` launch through any library with the kernels' C interface.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import torch

from movenet_tpu_torch.ops import gated_block as gb
from movenet_tpu_torch.ops.cuda.stack_kernel import (WIDTHS, _check, _ptr,
                                                     _raise, f32_unbuilt,
                                                     widths_message)

KERNEL_SOURCE = "movenet_tpu_torch/csrc/gated_block.cu"
# the built (R, S) pairs (MOVENET_GATED_WIDTHS in csrc/gated_block.cu)
GATED_WIDTHS = WIDTHS
launch_counts: Dict[str, int] = {"gated_block_fwd": 0, "gated_block_bwd": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_lib = None


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def library():
    global _lib
    if _lib is None:
        from movenet_tpu_torch.ops.cuda import build

        _lib = bind(build.load("gated_block"))
    return _lib


def bind(lib):
    lib.movenet_gated_supports.argtypes = [_I, _I]
    lib.movenet_gated_supports.restype = _I
    lib.movenet_gated_bwd_part.argtypes = [_I, _I, _I, _I]
    lib.movenet_gated_bwd_part.restype = _L
    lib.movenet_gated_bwd_scratch.argtypes = [_I] * 5
    lib.movenet_gated_bwd_scratch.restype = _L
    lib.movenet_gated_fwd.argtypes = [_P] * 8 + [_I] * 5 + [_P]
    lib.movenet_gated_fwd.restype = _I
    lib.movenet_gated_bwd.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.movenet_gated_bwd.restype = _I
    return lib


def _common(lib, h, ctx, b_fg, w_fg, w_out):
    """Checks of both directions: (B, T, R, S, W_in)."""
    batch, t, r = h.shape
    s = w_out.shape[1] - r
    dev = h.device
    if h.dtype != torch.bfloat16:
        raise ValueError(f32_unbuilt("the gated-block kernels", "gated",
                                     h.dtype))
    _check("h", h, torch.bfloat16, device=dev)
    win = (3 if ctx is not None else 2) * r
    if ctx is not None:
        _check("ctx", ctx, torch.bfloat16, (batch, t, r), dev)
    _check("b_fg", b_fg, torch.float32, (batch, 2 * r), dev)
    _check("w_fg", w_fg, torch.float32, (win, 2 * r), dev)
    _check("w_out", w_out, torch.float32, (r, r + s), dev)
    if not lib.movenet_gated_supports(r, s):
        raise NotImplementedError(widths_message(
            "the gated-block kernels", GATED_WIDTHS, r, s, "B.2 widths (4)"))
    return batch, t, r, s, win


def run_fwd(lib, h, ctx, b_fg, w_fg, w_out, b_out, d, stream=None):
    """Launch the forward; returns (res, skip) as the plain version."""
    batch, t, r, s, _ = _common(lib, h, ctx, b_fg, w_fg, w_out)
    _check("b_out", b_out, torch.float32, (1, r + s), h.device)
    res = torch.empty_like(h)
    skip = torch.empty(batch, t, s, dtype=h.dtype, device=h.device)
    err = lib.movenet_gated_fwd(
        _ptr(h), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out), _ptr(b_out),
        _ptr(res), _ptr(skip), batch, t, r, s, d, stream)
    _raise(err, "gated_block_fwd")
    return res, skip


def run_bwd(lib, h, ctx, b_fg, w_fg, w_out, dres, dskip, d, stream=None):
    """Launch the backward (outputs and scratch allocated here); returns
    as the plain version."""
    batch, t, r, s, win = _common(lib, h, ctx, b_fg, w_fg, w_out)
    dev, f32 = h.device, torch.float32
    _check("dres", dres, torch.bfloat16, (batch, t, r), dev)
    _check("dskip", dskip, torch.bfloat16, (batch, t, s), dev)
    # own, past, dfg, gated and the per-block partials (float32)
    scratch = torch.empty(lib.movenet_gated_bwd_scratch(batch, t, r, s, win),
                          dtype=f32, device=dev)
    dh = torch.empty_like(h)
    dctx = torch.empty_like(h) if ctx is not None else None
    grads = torch.empty(lib.movenet_gated_bwd_part(r, s, win, batch),
                        dtype=f32, device=dev)
    err = lib.movenet_gated_bwd(
        _ptr(h), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out), _ptr(dres),
        _ptr(dskip), _ptr(scratch), _ptr(dh), _ptr(dctx), _ptr(grads), batch,
        t, r, s, d, stream)
    _raise(err, "gated_block_bwd")
    sizes = [win * 2 * r, r * (r + s), r + s, batch * 2 * r]
    dw_fg, dw_out, db_out, db_fg = torch.split(grads, sizes)
    return (dh, dctx, db_fg.view(batch, 2 * r), dw_fg.view(win, 2 * r),
            dw_out.view(r, r + s), db_out.view(1, r + s))


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def gated_block_fwd(h, ctx, b_fg, w_fg, w_out, b_out, d: int):
    """(res, skip): the plain version for CPU tensors, the forward kernel
    for CUDA tensors."""
    if not h.is_cuda:
        return gb.gated_block_fwd_plain(h, ctx, b_fg, w_fg, w_out, b_out, d)
    out = run_fwd(library(), h, ctx, b_fg, w_fg, w_out, b_out, d,
                  _stream(h))
    launch_counts["gated_block_fwd"] += 1
    return out


def gated_block_bwd(h, ctx, b_fg, w_fg, w_out, dres, dskip, d: int):
    """The VJP: the plain version for CPU tensors, the backward kernels
    for CUDA tensors."""
    if not h.is_cuda:
        return gb.gated_block_bwd_plain(h, ctx, b_fg, w_fg, w_out, dres,
                                        dskip, d)
    out = run_bwd(library(), h, ctx, b_fg, w_fg, w_out, dres, dskip, d,
                  _stream(h))
    launch_counts["gated_block_bwd"] += 1
    return out


__all__ = ["gated_block_fwd", "gated_block_bwd", "launch_counts",
           "reset_launch_counts", "KERNEL_SOURCE"]
