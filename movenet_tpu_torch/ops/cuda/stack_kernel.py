"""Whole-stack trunk kernels: wrappers and launch counts.

``stack_fwd`` and ``stack_bwd`` are the wrappers of the save strategy's
forward and backward kernels in ``csrc/stack_kernel.cu`` (which replace
``stack_kernel.py:280 _fwd_kernel`` and ``:1486 _bwd_kernel_padded``);
``stack_fwd_x`` and ``stack_bwd_x`` the same kernels' non-embed form
(h in, dx out; counted with them); ``stack_head_fwd`` and
``stack_head_bwd`` those of the merged trunk + head + CE (which replace
``:464 _fwd_kernel_head`` and ``:624 _bwd_kernel_head``);
``stack_fwd_tails`` and ``stack_bwd_tails`` those of the recompute
strategy's (``:929 _fwd_kernel_tails`` and ``:1031 _bwd_kernel_tails``),
layer-major with layer checkpoints (``ops/stack_kernel.tails_every``);
``stack_fwd_replay`` and ``stack_bwd_replay`` those of the replay
strategy (``:280`` and ``:1486`` with save_h=False): the save kernels with
the layer inputs in a two-slot ring and float32 checkpoints in place of
hsave, and in the backward each group's layer inputs rebuilt from its
checkpoint (``stack_rebuild_kernel``) before the save backward's grids.
For tensors on the CPU they return the plain versions
(``ops/stack_kernel.stack_fwd_plain`` ...); for CUDA tensors they launch
the kernels or raise.  One call of ``stack_fwd`` is L+1 grid launches (the
embedding, then one per layer); one call of ``stack_bwd`` is 5L+2 (plus 3
with the video projection): per layer the layer launch and two
weight-gradient launches with their reductions (the wide forms, R = 128,
first write every layer's bf16 weights: one more launch in each forward and
in the recompute backward; every bf16 backward there first writes its
layer launches' TF32 weight images, one more launch).  ``stack_fwd_tails``
is L grid launches (one per layer); ``stack_bwd_tails`` is per group of k
layers k - 1 rebuild launches of the same layer kernel, then per layer the
save backward's grids in their recompute form (the layer launch, two
weight-gradient launches and their reductions; at R = 128 after a taps
launch of the layer kernel), then dx.
``stack_fwd_replay`` is L grid launches and, in bf16, ceil(L/k) - 1
checkpoint copies; ``stack_bwd_replay`` is ``stack_bwd_x``'s grids plus per
group k - 1 rebuild launches; its group buffers hold the rebuild's float32
h, which in bf16 feeds W_fg's gradient as the TPU kernel feeds it (the
rows t with t mod tile < d of h(t-d) rounded to bf16, tile =
``ops/stack_kernel.pick_stack_tile``).
``stack_head_fwd`` is ``stack_fwd``'s grids with x in place of the
embedding and the head in the last layer's, plus one reduction;
``stack_head_bwd`` is the head's backward grid and its reduction, then
``stack_bwd_x``'s grids.  Each call counts one launch in
``launch_counts``.

With the float32 compute dtype (table2 or x, ctx and dskip float32)
``stack_fwd``, ``stack_bwd``, ``stack_fwd_x`` and ``stack_bwd_x`` launch
the save kernels' float32 forms, counted apart as ``stack_fwd_f32`` and
``stack_bwd_f32``: the embedding (or x copied into hsave), then one
launch of ``stack_layer_f32_kernel`` per layer; the backward's grids as
the bf16 form's, with the float32 taps, W_fg's gradient from float32
activations and W_out's from the float32 gated (``f32_smem`` gives their
shared memory), then the table gradient or dx.  With float32 x, ctx and
dskip ``stack_fwd_tails`` and ``stack_bwd_tails`` launch the recompute
kernels' float32 forms, counted as ``stack_fwd_tails_f32`` and
``stack_bwd_tails_f32``: one launch of ``stack_layer_f32_kernel`` per
layer without the taps (the rebuilds without the skip sum too), and the
backward's layer launch in its float32 recompute form (fg formed again in
float32 from the operand rows staged over the tile's gradient rows) with
the float32 save form's weight gradients; at R = 128 the layer kernel is
kernel A and the layer backward kernel B (split-TF32 wgmma, "the wide
float32 recompute kernels"), a taps launch of kernel A before each layer
launch giving kernel B the float32 taps; checkpoints, group buffers, dx
and dctx in float32.  ``stack_fwd_replay`` and ``stack_bwd_replay`` in
float32 (counted as ``stack_fwd_replay_f32`` and
``stack_bwd_replay_f32``) run the float32 recompute forward's launches
with the taps stored, and the float32 save backward's grids after the
rebuilds (``stack_rebuild_f32_kernel``).  The merged, gated and packed
kernels take bf16 only, and raise for float32 with their ROADMAP.md
B.2/B.4 item.

Every family is built for the (R, S) pairs ``WIDTHS``; the bf16 save forms
(embed and non-embed), the bf16 recompute, the bf16 replay and the float32
recompute forms also for ``WIDE_WIDTHS`` (R = 128), whose kernels stream
their weights through shared memory (csrc/stack_kernel.cu, "the wide save
forms", "the wide recompute forms" and "the wide float32 recompute
kernels"; the save, replay and recompute forwards' wrappers and the
recompute backward's allocate their weight scratch: bf16,
``movenet_stack_wt_elems``, or the float32 forms' TF32 images,
``movenet_stack_wt_f32_elems``; the bf16 backwards' wrappers the TF32
images of their layer launches on ``wgmma``,
``movenet_stack_wt_bwd_elems``).  A family raises at a pair it is not
built for with its ROADMAP.md item
(``FAMILY_WIDTHS``, ``WIDTH_ITEMS``); the float32 recompute and replay forms
are families of their own there.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from movenet_tpu_torch.ops import stack_kernel as sk

KERNEL_SOURCE = "movenet_tpu_torch/csrc/stack_kernel.cu"
# kernel calls by wrapper, counted where the kernels launch
launch_counts: Dict[str, int] = {"stack_fwd": 0, "stack_bwd": 0,
                                 "stack_fwd_tails": 0, "stack_bwd_tails": 0,
                                 "stack_head_fwd": 0, "stack_head_bwd": 0,
                                 "stack_fwd_f32": 0, "stack_bwd_f32": 0,
                                 "stack_fwd_tails_f32": 0,
                                 "stack_bwd_tails_f32": 0,
                                 "stack_fwd_replay": 0, "stack_bwd_replay": 0,
                                 "stack_fwd_replay_f32": 0,
                                 "stack_bwd_replay_f32": 0}
# blocks of the time-reduction launches: two per SM of an H100
REDUCE_BLOCKS = 264
# shared memory one block may use on sm_90
SMEM_LIMIT = 232448
# the (R, S) pairs every kernel family is built for (MOVENET_STACK_WIDTHS in
# csrc/stack_kernel.cu), and the wide ones the bf16 save, recompute and
# replay forms and the float32 recompute forms also take
# (MOVENET_WIDE_WIDTHS: the R = 128 model of scripts/probe_r128_mfu.py, the
# flagship's depth at R = S = 128, and experiment 02 at
# --residual_channels 128)
WIDTHS = ((16, 16), (32, 32), (64, 64), (64, 8), (32, 8), (16, 8))
WIDE_WIDTHS = ((128, 128), (128, 8))
# the built pairs by kernel family, in the order of the library's family
# numbers (movenet_stack_supports), and the ROADMAP.md item of what each
# family does not take yet
FAMILY_WIDTHS = {"save": WIDTHS + WIDE_WIDTHS, "save_f32": WIDTHS,
                 "recompute": WIDTHS + WIDE_WIDTHS,
                 "replay": WIDTHS + WIDE_WIDTHS, "merged": WIDTHS,
                 "recompute_f32": WIDTHS + WIDE_WIDTHS, "replay_f32": WIDTHS}
WIDTH_ITEMS = {"save": "B.2 widths (5)", "save_f32": "B.2 widths (2)",
               "recompute": "B.2 widths (5)", "replay": "B.2 widths (5)",
               "merged": "B.2 widths (3)", "recompute_f32": "B.2 widths (2)",
               "replay_f32": "B.2 widths (2)"}
# what float32 on the card does not run yet, by kernel family (the forms
# still to build under ROADMAP.md B.2/B.4, in its order)
F32_UNBUILT = {
    "merged": "(3) the merged forms",
    "gated": "(4) the gated forms",
    "packed": "(5) the packed head",
}


def f32_unbuilt(what: str, family: str, dtype) -> str:
    """The message of a float32 form that is not built yet."""
    return (f"{what} take the bfloat16 compute dtype, got {dtype}; float32 "
            "on the card runs the save, recompute and replay forms and the "
            f"unpacked head only (ROADMAP.md B.2/B.4 {F32_UNBUILT[family]})")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
_lib = None


def widths_message(what: str, pairs, r: int, s: int, item: str) -> str:
    """The message of a width a kernel family is not built for."""
    listed = ", ".join(f"({a}, {b})" for a, b in pairs)
    return (f"{what} are built for (R, S) in {listed}; got ({r}, {s}) "
            f"(ROADMAP.md {item})")


def _widths(lib, family: str, r: int, s: int, what: str) -> None:
    """Raise where the kernels of ``family`` are not built at (R, S)."""
    if not lib.movenet_stack_supports(list(FAMILY_WIDTHS).index(family), r,
                                      s):
        raise NotImplementedError(widths_message(
            what, FAMILY_WIDTHS[family], r, s, WIDTH_ITEMS[family]))


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def library():
    """The built kernel library (nvcc at first use), argtypes set."""
    global _lib
    if _lib is None:
        from movenet_tpu_torch.ops.cuda import build

        _lib = bind(build.load("stack_kernel"))
    return _lib


def bind(lib):
    lib.movenet_stack_supports.argtypes = [_I, _I, _I]
    lib.movenet_stack_supports.restype = _I
    lib.movenet_stack_wt_elems.argtypes = [_I, _I, _I, _I]
    lib.movenet_stack_wt_elems.restype = _L
    lib.movenet_stack_wt_f32_elems.argtypes = [_I] * 5
    lib.movenet_stack_wt_f32_elems.restype = _L
    lib.movenet_stack_wt_bwd_elems.argtypes = [_I] * 4
    lib.movenet_stack_wt_bwd_elems.restype = _L
    lib.movenet_stack_bwd_scratch.argtypes = [_I] * 9
    lib.movenet_stack_bwd_scratch.restype = _L
    lib.movenet_stack_bwd_smem.argtypes = [_I, _I, _I, _I]
    lib.movenet_stack_bwd_smem.restype = _L
    lib.movenet_stack_layer_smem.argtypes = [_I, _I, _I]
    lib.movenet_stack_layer_smem.restype = _L
    lib.movenet_stack_fwd.argtypes = [_P, _I, _P, _I, _P, _P, _P, _P, _P,
                                      _P, _P, _P, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _P]
    lib.movenet_stack_fwd.restype = _I
    # the bf16 backwards take the wide widths' weight images (img) after
    # their other pointers
    lib.movenet_stack_bwd.argtypes = [_P] * 8 + [_I, _I] + [_P] * 4 \
        + [_I] + [_P] * 10 + [_I] * 6 + [_P]
    lib.movenet_stack_bwd.restype = _I
    lib.movenet_stack_fwd_f32.argtypes = [_P, _I, _P, _I] + [_P] * 10 \
        + [_I] * 5 + [_P]
    lib.movenet_stack_fwd_f32.restype = _I
    lib.movenet_stack_bwd_f32.argtypes = [_P] * 7 + [_I, _I] + [_P] * 4 \
        + [_I] + [_P] * 9 + [_I] * 6 + [_P]
    lib.movenet_stack_bwd_f32.restype = _I
    lib.movenet_tails_bwd_scratch.argtypes = [_I] * 7
    lib.movenet_tails_bwd_scratch.restype = _L
    # the recompute forms take the wide forms' weight scratch after their
    # other pointers
    for fn in (lib.movenet_stack_fwd_tails, lib.movenet_stack_fwd_tails_f32):
        fn.argtypes = [_P] * 7 + [_I] + [_P] * 5 + [_I] * 5 + [_P]
        fn.restype = _I
    for fn in (lib.movenet_stack_bwd_tails, lib.movenet_stack_bwd_tails_f32):
        fn.argtypes = [_P] * 9 + [_I, _P, _P, _I] + [_P] * 7 + [_I] * 5 \
            + [_P]
        fn.restype = _I
    lib.movenet_stack_bwd_tails.argtypes = [_P] * 9 + [_I, _P, _P, _I] \
        + [_P] * 8 + [_I] * 5 + [_P]
    lib.movenet_stack_blocks.argtypes = []
    lib.movenet_stack_blocks.restype = _I
    lib.movenet_stack_head_supports.argtypes = [_I, _I, _I]
    lib.movenet_stack_head_supports.restype = _I
    lib.movenet_stack_fwd_x.argtypes = [_P] * 13 + [_I] * 5 + [_P]
    lib.movenet_stack_fwd_x.restype = _I
    lib.movenet_stack_fwd_x_f32.argtypes = [_P] * 11 + [_I] * 5 + [_P]
    lib.movenet_stack_fwd_x_f32.restype = _I
    lib.movenet_stack_fwd_replay.argtypes = [_P] * 7 + [_I] + [_P] * 7 \
        + [_I] * 5 + [_P]
    lib.movenet_stack_fwd_replay.restype = _I
    lib.movenet_stack_fwd_replay_f32.argtypes = [_P] * 7 + [_I] + [_P] * 5 \
        + [_I] * 5 + [_P]
    lib.movenet_stack_fwd_replay_f32.restype = _I
    for fn in (lib.movenet_stack_replay_inputs,
               lib.movenet_stack_replay_inputs_f32):
        fn.argtypes = [_P] * 5 + [_I] + [_P] + [_I] * 5 + [_P]
        fn.restype = _I
    for fn in (lib.movenet_stack_bwd_replay, lib.movenet_stack_bwd_replay_f32):
        fn.argtypes = [_P] * 9 + [_I, _P, _I] + [_P] * 3 + [_I] + [_P] * 8 \
            + [_I] * 5 + [_P]
        fn.restype = _I
    lib.movenet_stack_bwd_replay.argtypes = [_P] * 9 + [_I, _P, _I] \
        + [_P] * 3 + [_I] + [_P] * 9 + [_I] * 5 + [_P]
    lib.movenet_stack_head_fwd.argtypes = [_P] * 19 + [_I] * 8 + [_P]
    lib.movenet_stack_head_fwd.restype = _I
    lib.movenet_stack_head_bwd.argtypes = [_P] * 10 + [_I] * 7 + [_P]
    lib.movenet_stack_head_bwd.restype = _I
    return lib


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(name, t, dtype, shape=None, device=None):
    if t.dtype != dtype:
        raise ValueError(f"{name} is {t.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} is not contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, not {device}")


def _raise(err: int, what: str):
    if err:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def _dils(dilations: Sequence[int]):
    return (ctypes.c_int * len(dilations))(*dilations)


def _wg_split(km: int, kn: int, ca: int, cb: int):
    """``wg_split`` of csrc/stack_kernel.cu: the (wm, wn) warp tiling of a
    weight-gradient launch."""
    best, best_w, best_cost = (1, 1), 0, 1 << 30
    wm = 1
    while wm <= 8:
        wn = 1
        while wm * wn <= 8:
            if km % wm == 0 and kn % wn == 0:
                w, cost = wm * wn, km // wm * ca + kn // wn * cb
                if w > best_w or (w == best_w and cost < best_cost):
                    best, best_w, best_cost = (wm, wn), w, cost
            wn *= 2
        wm *= 2
    return best


def _wg_smem(n: int, ka: int, split_a: bool, wide: bool = False,
             rows: int = 64) -> int:
    """``WgShape<MODE, R, S, KA>::smem()``: the weight-gradient launch's
    bytes for an output of KA x n columns in slabs of 128 columns (64 at the
    wide widths), ``rows`` rows staged a chunk."""
    nb = min(n, 64 if wide else 128)
    lda, ldb = (ka + 15) // 16 * 16 + 8, (nb + 15) // 16 * 16 + 8
    wm, wn = _wg_split(ka // 16, nb // 8, 12 if split_a else 4, 6)
    red = (8 // (wm * wn) - 1) * ka * nb
    return 4 * max(rows * (lda + ldb), red)


def f32_smem(r: int, s: int, win: int) -> Dict[str, int]:
    """Bytes of dynamic shared memory a block of each float32 save and
    recompute launch takes, as csrc/stack_kernel.cu lays them out: the
    forward's layer kernel (``F32Shape``: the 64-row operand tile, W_fg^T,
    W_out^T and the gated rows, float32; the recompute forward and its
    rebuilds launch it too), the save backward's layer kernel
    (``BwdShape``: W_out and W_fg, then per pipeline the [dh | dskip] and
    dfg rows, whose dfg rows hold the float32 taps first), the recompute
    backward's (the same weights; per pipeline the tile holds the float32
    [h | h(t-d) | ctx] rows first, then [dh | dskip] and dfg) and the
    weight-gradient launches (W_fg from float32 activations, W_out from
    the float32 gated, W_up from float32 xc).  ``win`` is W_in: 2R, or 3R
    with ctx.  Above R = 64 the wide layouts: kernel A's (``WgF32Fwd``:
    the 128-row tile's gated rows as big and small TF32 images, then a ring
    of three stages of 16 k, each the A images of 128 operand rows and the
    B images of R weight rows, then the stages' barriers), kernel B's
    (``WgF32Bwd``: seven stages of 16 k, each the A images of 128 rows and
    the B images of R weight rows; every layer backward there runs it) and
    W_fg's gradient on 32-row chunks."""
    if r > 64:
        kc = 16
        a_img = 2 * 128 * kc * 4
        layer_bwd = 7 * (a_img + 2 * r * kc * 4) + 2 * 7 * 8
        return {
            "layer_fwd": 2 * 128 * r * 4 + 3 * (a_img + 2 * r * kc * 4)
            + 2 * 3 * 8,
            "layer_bwd": layer_bwd,
            "layer_bwd_rc": layer_bwd,
            "wgrad_fg": _wg_smem(2 * r, win, True, True, 32),
            "wgrad_out": _wg_smem(r + s, r, True, True),
            "wgrad_up": _wg_smem(10 * r, r, True, True),
        }
    halves = 2 if r >= 64 else 1
    rows = 64 // halves
    ldd, ldf = r + s + 4, 2 * r + 4
    weights = r * ldd + win * ldf
    return {
        "layer_fwd": 4 * (64 * (3 * r + 4) + 2 * r * (3 * r + 4)
                          + (r + s) * (r + 4) + 64 * (r + 4)),
        "layer_bwd": 4 * (weights + halves * rows * (ldd + ldf)),
        "layer_bwd_rc": 4 * (weights + halves * rows
                             * max(ldd + ldf, 3 * r + 4)),
        "wgrad_fg": _wg_smem(2 * r, win, True),
        "wgrad_out": _wg_smem(r + s, r, True),
        "wgrad_up": _wg_smem(10 * r, r, True),
    }


def wide_bwd_smem(r: int) -> Dict[str, int]:
    """Bytes of dynamic shared memory a block of each wide bf16 backward
    launch on wgmma takes (R > 64), as csrc/stack_kernel.cu lays them out:
    the layer launch of every form (kernel B's block, ``f32_smem``'s
    ``layer_bwd``) and W_fg's gradient (``WgWgrad``: stages of 16 rows,
    each A^T's image of 128 columns, its big part alone in MODE 0 (bf16 A)
    and both in MODE 7 (the replay's float32 A), and dfg^T's big and small
    images of 128 columns, six stages in MODE 0 and four in MODE 7; then
    the producer's six raw stages of 16 rows of A's slab, 2 bytes an
    element in MODE 0 and 4 in MODE 7, and of dfg's 128 columns; the
    barriers and the bias partials of four row groups).  S and W_in set
    none of them: A's slabs are 128 columns whatever W_in."""
    kc, cols, raw = 16, 128, 6
    img = cols * kc * 4
    wg = {mode: st * (parts * img + 2 * img)
          + raw * kc * cols * (ea + 4) + 2 * st * 8 + 4 * cols * 4
          for mode, st, parts, ea in ((0, 6, 1, 2), (7, 4, 2, 4))}
    return {"layer_bwd": f32_smem(r, r, 2 * r)["layer_bwd"],
            "wgrad_fg": wg[0], "wgrad_fg_replay": wg[7]}


def _f32_fits(r: int, s: int, win: int) -> None:
    over = {k: v for k, v in f32_smem(r, s, win).items() if v > SMEM_LIMIT}
    if over:
        raise NotImplementedError(
            f"the float32 trunk kernels at (R, S) = ({r}, {s}) need {over} "
            f"bytes of shared memory, above {SMEM_LIMIT} (ROADMAP.md B.2)")


def _fwd_check(pack, table2, ctx, b_fg, w_fg, w_out, b_out, dilations,
               batch):
    t = pack.shape[0]
    n_layers, r = len(dilations), table2.shape[1]
    s = w_out.shape[2] - r
    dev = table2.device
    if table2.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(
            f"the trunk kernels take the bfloat16 or float32 compute dtype, "
            f"got {table2.dtype}")
    dt = table2.dtype
    _check("codes_pack", pack, torch.int32, device=dev)
    if pack.shape[1] < 2 * batch:
        raise ValueError(f"codes_pack has {pack.shape[1]} columns, needs "
                         f">= {2 * batch}")
    _check("table2", table2, dt, device=dev)
    win = (3 if ctx is not None else 2) * r
    if ctx is not None:
        _same_dtype(("table2", table2), ("ctx", ctx))
        _check("ctx", ctx, dt, (batch, t, r), dev)
    _check("b_fg", b_fg, torch.float32, (n_layers * batch, 2 * r), dev)
    _check("w_fg", w_fg, torch.float32, (n_layers, win, 2 * r), dev)
    _check("w_out", w_out, torch.float32, (n_layers, r, r + s), dev)
    _check("b_out", b_out, torch.float32, (n_layers, r + s), dev)
    return t, n_layers, r, s


def _same_dtype(*named):
    """Raise, naming the tensors, where the activations' dtypes differ."""
    dts = {n: t.dtype for n, t in named if t is not None}
    if len(set(dts.values())) > 1:
        raise ValueError(
            "the trunk kernels take one compute dtype for the activations, "
            "got " + ", ".join(f"{n} {d}" for n, d in dts.items()))


def run_fwd(lib, pack, table2, ctx, b_fg, w_fg, w_out, b_out, dilations,
            batch, stream=None):
    """Launch the forward on given tensors (outputs allocated here);
    float32 table2 and ctx take the float32 form."""
    t, n_layers, r, s = _fwd_check(pack, table2, ctx, b_fg, w_fg, w_out,
                                   b_out, dilations, batch)
    if table2.dtype == torch.float32:
        _widths(lib, "save_f32", r, s, "the float32 save kernels")
        return _run_fwd_f32(lib, pack, table2, ctx, b_fg, w_fg, w_out,
                            b_out, dilations, batch, t, n_layers, r, s,
                            stream)
    _widths(lib, "save", r, s, "the save kernels")
    h, skacc, hsave, tfsg, skip, wt = _fwd_buffers(
        lib, table2.device, batch, t, n_layers, r, s, ctx is not None)
    err = lib.movenet_stack_fwd(
        _ptr(pack), pack.shape[1], _ptr(table2), table2.shape[0] // 2,
        _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out), _ptr(b_out),
        _dils(dilations), _ptr(h), _ptr(skacc), _ptr(hsave), _ptr(tfsg),
        _ptr(skip), _ptr(wt), batch, t, n_layers, r, s, stream)
    _raise(err, "stack_fwd")
    return skip, hsave, tfsg


def _run_fwd_f32(lib, pack, table2, ctx, b_fg, w_fg, w_out, b_out,
                 dilations, batch, t, n_layers, r, s, stream):
    """The float32 save forward: (skip_sum, hsave, tfsg) in float32."""
    _f32_fits(r, s, (3 if ctx is not None else 2) * r)
    dev, f32, m = table2.device, torch.float32, batch * t
    skacc = torch.empty(m, s, dtype=f32, device=dev)
    hsave = torch.empty(n_layers, batch, t, r, dtype=f32, device=dev)
    tfsg = torch.empty(n_layers, batch, t, 2 * r, dtype=f32, device=dev)
    skip = torch.empty(batch, t, s, dtype=f32, device=dev)
    err = lib.movenet_stack_fwd_f32(
        _ptr(pack), pack.shape[1], _ptr(table2), table2.shape[0] // 2,
        _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out), _ptr(b_out),
        _dils(dilations), _ptr(skacc), _ptr(hsave), _ptr(tfsg), _ptr(skip),
        batch, t, n_layers, r, s, stream)
    _raise(err, "stack_fwd_f32")
    return skip, hsave, tfsg


def _launch_bwd(lib, hsave, tfsg, ctx, w_fg, w_out, dskip, dilations, proj,
                stream, pack=None, vocab=0, replay=None):
    """The save backward: with ``pack`` the table gradient (2V, R) float32
    leads the returns, without it dx (B, T, R) in the compute dtype (the
    non-embed form).  dskip is bf16, or float32 from the merged head.
    float32 hsave (or x) takes the float32 form: every activation, dskip
    and dctx in float32.  ``replay`` = (x, ckpt, b_out, every) in place
    of hsave (None): the replay backward, which rebuilds the layer inputs
    from x, the float32 checkpoints and the taps.  Returns as the plain
    versions."""
    n_layers, batch, t, two_r = tfsg.shape
    r = two_r // 2
    s = w_out.shape[2] - r
    dev = tfsg.device
    win = (3 if ctx is not None else 2) * r
    lead = ("x", replay[0]) if replay is not None else ("hsave", hsave)
    f32_form = lead[1].dtype == torch.float32
    if f32_form:
        # the float32 form: every activation and dskip in float32
        _same_dtype(lead, ("tfsg", tfsg), ("ctx", ctx), ("dskip", dskip))
    act = torch.float32 if f32_form else torch.bfloat16
    if replay is None:
        _check("hsave", hsave, act, (n_layers, batch, t, r), dev)
    else:
        x, ckpt, b_out, every = replay
        if every < 1:
            raise ValueError(f"every = {every}: a group holds >= 1 layer")
        _check("x", x, act, (batch, t, r), dev)
        _check("ckpt", ckpt, torch.float32,
               (len(sk.ckpt_layers(n_layers, every)), batch, t, r), dev)
        _check("b_out", b_out, torch.float32, (n_layers, r + s), dev)
        if dskip.dtype != act:
            raise ValueError(f"dskip is {dskip.dtype}, the replay kernels "
                             f"take {act}")
        if batch * t >= 2 ** 31:
            raise ValueError(f"B*T = {batch * t}: the replay kernels index "
                             "rows in 32 bits")
    _check("tfsg", tfsg, act, device=dev)
    if ctx is not None:
        _check("ctx", ctx, act, (batch, t, r), dev)
    _check("w_fg", w_fg, torch.float32, (n_layers, win, 2 * r), dev)
    _check("w_out", w_out, torch.float32, (n_layers, r, r + s), dev)
    if dskip.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"dskip is {dskip.dtype}, the kernel takes "
                         "bfloat16 or float32")
    _check("dskip", dskip, dskip.dtype, (batch, t, s), dev)
    if pack is not None:
        _check("codes_pack", pack, torch.int32, device=dev)
    if replay is not None:
        _widths(lib, "replay_f32" if f32_form else "replay", r, s,
                "the float32 replay kernels" if f32_form
                else "the replay kernels")
    elif f32_form:
        _widths(lib, "save_f32", r, s, "the float32 save kernels")
    else:
        _widths(lib, "save", r, s, "the save kernels")
    if f32_form:
        _f32_fits(r, s, win)
    xc = wup = None
    if proj is not None:
        xc, wup_t = proj
        if f32_form:
            _same_dtype(lead, ("xc", xc))
        _check("xc", xc, act, (batch, t // 10, r), dev)
        # the kernel reads the projection in its (R, 10R) layout
        wup = wup_t.permute(2, 0, 1).reshape(r, 10 * r).contiguous()
        _check("wup", wup, torch.float32, device=dev)
    chunks = max(1, REDUCE_BLOCKS // batch)
    embed_blocks = REDUCE_BLOCKS if pack is not None else 0
    n_scratch = lib.movenet_stack_bwd_scratch(batch, t, r, s, win, chunks,
                                              vocab, embed_blocks,
                                              int(f32_form))
    f32 = torch.float32
    scratch = torch.empty(n_scratch, dtype=f32, device=dev)
    dtab = dx = None
    if pack is not None:
        dtab = torch.empty(2 * vocab, r, dtype=f32, device=dev)
    else:
        dx = torch.empty(batch, t, r, dtype=act, device=dev)
    dctx = None
    if proj is not None:
        dctx = torch.empty(batch, t // 10, r, dtype=act, device=dev)
    elif ctx is not None:
        dctx = torch.empty(batch, t, r, dtype=act, device=dev)
    db_fg = torch.empty(n_layers * batch, 2 * r, dtype=f32, device=dev)
    dw_fg = torch.empty(n_layers, win, 2 * r, dtype=f32, device=dev)
    dw_out = torch.empty(n_layers, r, r + s, dtype=f32, device=dev)
    db_out = torch.empty(n_layers, r + s, dtype=f32, device=dev)
    dwup = dbup = None
    if proj is not None:
        dwup = torch.empty(r, 10 * r, dtype=f32, device=dev)
        dbup = torch.empty(10 * r, dtype=f32, device=dev)
    if replay is not None:
        # every - 1 slots of the rebuild's float32 h; in bf16 the TPU
        # kernel's tile decides which rows of h(t-d) W_fg's gradient takes
        # rounded
        group = torch.empty(max(every - 1, 1), batch, t, r, dtype=f32,
                            device=dev)
        tile = sk.pick_stack_tile(t, dilations, ctx is not None)
        head = (_ptr(x), _ptr(ckpt), _ptr(tfsg), _ptr(ctx), _ptr(w_fg),
                _ptr(w_out), _ptr(b_out), _ptr(dskip), _dils(dilations),
                every, _ptr(group), tile, _ptr(xc), _ptr(wup),
                _ptr(scratch), chunks, _ptr(dx), _ptr(dctx), _ptr(db_fg),
                _ptr(dw_fg), _ptr(dw_out), _ptr(db_out), _ptr(dwup),
                _ptr(dbup))
        tail = (batch, t, n_layers, r, s, stream)
        if f32_form:
            _raise(lib.movenet_stack_bwd_replay_f32(*head, *tail),
                   "stack_bwd_replay_f32")
        else:
            img = _bwd_images(lib, dev, r, s, win, n_layers)
            _raise(lib.movenet_stack_bwd_replay(*head, _ptr(img), *tail),
                   "stack_bwd_replay")
    elif f32_form:
        err = lib.movenet_stack_bwd_f32(
            _ptr(hsave), _ptr(tfsg), _ptr(ctx), _ptr(w_fg), _ptr(w_out),
            _ptr(dskip), _ptr(pack), 0 if pack is None else pack.shape[1],
            vocab, _dils(dilations), _ptr(xc), _ptr(wup), _ptr(scratch),
            chunks, _ptr(dtab), _ptr(dx), _ptr(dctx), _ptr(db_fg),
            _ptr(dw_fg), _ptr(dw_out), _ptr(db_out), _ptr(dwup), _ptr(dbup),
            batch, t, n_layers, r, s, embed_blocks, stream)
        _raise(err, "stack_bwd_f32")
    else:
        bf = dskip.dtype == torch.bfloat16
        img = _bwd_images(lib, dev, r, s, win, n_layers)
        err = lib.movenet_stack_bwd(
            _ptr(hsave), _ptr(tfsg), _ptr(ctx), _ptr(w_fg), _ptr(w_out),
            _ptr(dskip) if bf else None, None if bf else _ptr(dskip),
            _ptr(pack), 0 if pack is None else pack.shape[1], vocab,
            _dils(dilations), _ptr(xc), _ptr(wup), _ptr(scratch), chunks,
            _ptr(dtab), _ptr(dx), _ptr(dctx), _ptr(db_fg), _ptr(dw_fg),
            _ptr(dw_out), _ptr(db_out), _ptr(dwup), _ptr(dbup), _ptr(img),
            batch, t, n_layers, r, s, embed_blocks, stream)
        _raise(err, "stack_bwd")
    dwup_aug = None
    if proj is not None:
        dwup_aug = torch.cat(
            [dwup.reshape(r, 10, r).permute(1, 0, 2),
             dbup.reshape(10, 1, r)], dim=1)
    return (dtab if pack is not None else dx, dctx, db_fg, dw_fg, dw_out,
            db_out, dwup_aug)


def run_bwd(lib, hsave, tfsg, ctx, w_fg, w_out, dskip, pack, vocab,
            dilations, proj=None, stream=None):
    """Launch the backward on given tensors (outputs allocated here);
    same returns as ``stack_bwd_plain``."""
    return _launch_bwd(lib, hsave, tfsg, ctx, w_fg, w_out, dskip, dilations,
                       proj, stream, pack, vocab)


def _tails_check(lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations,
                 family="recompute"):
    """Checks of the recompute (or replay) kernels: (B, T, L, R, S,
    W_in)."""
    dims = _x_check(lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations,
                    f"the {family} kernels", family)
    if dims[0] * dims[1] >= 2 ** 31:
        raise ValueError(f"B*T = {dims[0] * dims[1]}: the {family} "
                         "kernels index rows in 32 bits")
    return dims


def run_fwd_tails(lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations,
                  stream=None, every=0):
    """Launch the recompute forward (outputs allocated here); returns
    (skip_sum, ckpt) as ``stack_fwd_tails_plain``.  float32 x and ctx take
    the float32 form."""
    batch, t, n_layers, r, s, _ = _tails_check(lib, x, ctx, b_fg, w_fg,
                                               w_out, b_out, dilations)
    every = every or sk.tails_every(n_layers)
    dev, act = x.device, x.dtype
    skip = torch.empty(batch, t, s, dtype=act, device=dev)
    ckpt = torch.empty(len(sk.ckpt_layers(n_layers, every)), batch, t, r,
                       dtype=act, device=dev)
    work = torch.empty(2, batch, t, r, dtype=act, device=dev)
    skacc = torch.empty(batch * t, s, dtype=torch.float32, device=dev)
    wt = _weight_scratch(lib, dev, r, s, ctx is not None, n_layers, act)
    args = (_ptr(x), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out),
            _ptr(b_out), _dils(dilations), every, _ptr(skip), _ptr(ckpt),
            _ptr(work), _ptr(skacc), _ptr(wt), batch, t, n_layers, r, s,
            stream)
    if act == torch.float32:
        _raise(lib.movenet_stack_fwd_tails_f32(*args), "stack_fwd_tails_f32")
    else:
        _raise(lib.movenet_stack_fwd_tails(*args), "stack_fwd_tails")
    return skip, ckpt


def run_bwd_tails(lib, x, ckpt, ctx, b_fg, w_fg, w_out, b_out, dskip,
                  dilations, stream=None, every=0):
    """Launch the recompute backward (outputs and scratch allocated
    here); returns as ``stack_bwd_tails_plain``.  float32 x, ckpt, ctx and
    dskip take the float32 form."""
    batch, t, n_layers, r, s, win = _tails_check(lib, x, ctx, b_fg, w_fg,
                                                 w_out, b_out, dilations)
    every = every or sk.tails_every(n_layers)
    dev, f32, act = x.device, torch.float32, x.dtype
    _check("ckpt", ckpt, act,
           (len(sk.ckpt_layers(n_layers, every)), batch, t, r), dev)
    _check("dskip", dskip, act, (batch, t, s), dev)
    chunks = max(1, REDUCE_BLOCKS // batch)
    scratch = torch.empty(
        lib.movenet_tails_bwd_scratch(batch, t, r, s, win, chunks,
                                      int(act == f32)),
        dtype=f32, device=dev)
    group = torch.empty(max(every - 1, 1), batch, t, r, dtype=act,
                        device=dev)
    dx = torch.empty(batch, t, r, dtype=act, device=dev)
    dctx = torch.empty_like(dx) if ctx is not None else None
    db_fg = torch.empty(n_layers * batch, 2 * r, dtype=f32, device=dev)
    dw_fg = torch.empty(n_layers, win, 2 * r, dtype=f32, device=dev)
    dw_out = torch.empty(n_layers, r, r + s, dtype=f32, device=dev)
    db_out = torch.empty(n_layers, r + s, dtype=f32, device=dev)
    wt = _weight_scratch(lib, dev, r, s, ctx is not None, n_layers, act,
                         bwd=True)
    head = (_ptr(x), _ptr(ckpt), _ptr(ctx), _ptr(b_fg), _ptr(w_fg),
            _ptr(w_out), _ptr(b_out), _ptr(dskip), _dils(dilations), every,
            _ptr(group), _ptr(scratch), chunks, _ptr(dx), _ptr(dctx),
            _ptr(db_fg), _ptr(dw_fg), _ptr(dw_out), _ptr(db_out), _ptr(wt))
    tail = (batch, t, n_layers, r, s, stream)
    if act == f32:
        _raise(lib.movenet_stack_bwd_tails_f32(*head, *tail),
               "stack_bwd_tails_f32")
    else:
        img = _bwd_images(lib, dev, r, s, win, n_layers)
        _raise(lib.movenet_stack_bwd_tails(*head, _ptr(img), *tail),
               "stack_bwd_tails")
    return dx, dctx, db_fg, dw_fg, dw_out, db_out


def _x_check(lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations, what,
             family):
    """Checks of the kernels that start from x (the non-embed save form,
    ``family`` "non-embed"; the merged, recompute and replay kernels; a
    ``family`` in ``F32_UNBUILT`` takes bf16 only, the others bf16 or
    float32): (B, T, L, R, S, W_in)."""
    batch, t, r = x.shape
    n_layers = len(dilations)
    s = w_out.shape[2] - r
    dev = x.device
    if family in F32_UNBUILT:
        if x.dtype != torch.bfloat16:
            raise ValueError(f32_unbuilt(what, family, x.dtype))
    elif x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what} take the bfloat16 or float32 compute "
                         f"dtype, got {x.dtype}")
    act = x.dtype
    _check("x", x, act, device=dev)
    win = (3 if ctx is not None else 2) * r
    if ctx is not None:
        _check("ctx", ctx, act, (batch, t, r), dev)
    _check("b_fg", b_fg, torch.float32, (n_layers * batch, 2 * r), dev)
    _check("w_fg", w_fg, torch.float32, (n_layers, win, 2 * r), dev)
    _check("w_out", w_out, torch.float32, (n_layers, r, r + s), dev)
    _check("b_out", b_out, torch.float32, (n_layers, r + s), dev)
    if family == "non-embed":
        family = "save_f32" if act == torch.float32 else "save"
    elif act == torch.float32 and family in ("recompute", "replay"):
        family += "_f32"
        what = what.replace("the ", "the float32 ", 1)
    _widths(lib, family, r, s, what)
    if act == torch.float32:
        _f32_fits(r, s, win)
    return batch, t, n_layers, r, s, win


def run_fwd_x(lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations,
              stream=None):
    """Launch the non-embed save forward (B.2(a)); returns (skip_sum,
    hsave, tfsg) as ``stack_fwd_x_plain``.  float32 x and ctx take the
    float32 form."""
    batch, t, n_layers, r, s, _ = _x_check(lib, x, ctx, b_fg, w_fg, w_out,
                                           b_out, dilations,
                                           "the non-embed save kernels",
                                           "non-embed")
    if x.dtype == torch.float32:
        f32, dev, m = torch.float32, x.device, batch * t
        skacc = torch.empty(m, s, dtype=f32, device=dev)
        hsave = torch.empty(n_layers, batch, t, r, dtype=f32, device=dev)
        tfsg = torch.empty(n_layers, batch, t, 2 * r, dtype=f32, device=dev)
        skip = torch.empty(batch, t, s, dtype=f32, device=dev)
        err = lib.movenet_stack_fwd_x_f32(
            _ptr(x), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out),
            _ptr(b_out), _dils(dilations), _ptr(skacc), _ptr(hsave),
            _ptr(tfsg), _ptr(skip), batch, t, n_layers, r, s, stream)
        _raise(err, "stack_fwd_f32")
        return skip, hsave, tfsg
    h, skacc, hsave, tfsg, skip, wt = _fwd_buffers(
        lib, x.device, batch, t, n_layers, r, s, ctx is not None)
    err = lib.movenet_stack_fwd_x(
        _ptr(x), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out), _ptr(b_out),
        _dils(dilations), _ptr(h), _ptr(skacc), _ptr(hsave), _ptr(tfsg),
        _ptr(skip), _ptr(wt), batch, t, n_layers, r, s, stream)
    _raise(err, "stack_fwd_x")
    return skip, hsave, tfsg


def _weight_scratch(lib, dev, r, s, ctx: bool, n_layers,
                    dtype=torch.bfloat16, bwd: bool = False):
    """The wide forms' weight scratch, or None at the narrow widths, which
    take none: the bf16 forms' weights (``movenet_stack_wt_elems``), or for
    the float32 recompute forms the TF32 big and small images of kernel A's
    weights and, with ``bwd``, kernel B's (``movenet_stack_wt_f32_elems``;
    ``ops/stack_kernel.wide_f32_weight_images`` is its plain version)."""
    win = (3 if ctx else 2) * r
    if dtype == torch.float32:
        n_wt = lib.movenet_stack_wt_f32_elems(r, s, win, n_layers, int(bwd))
    else:
        n_wt = lib.movenet_stack_wt_elems(r, s, win, n_layers)
    return torch.empty(n_wt, dtype=dtype, device=dev) if n_wt else None


def _bwd_images(lib, dev, r, s, win, n_layers):
    """The bf16 backwards' float32 weight images at the wide widths (kernel
    B's TF32 big and small images of every layer's W_out and W_fg,
    ``movenet_stack_wt_bwd_elems``, the backward part of
    ``ops/stack_kernel.wide_f32_weight_images``), or None at the narrow
    widths."""
    n = lib.movenet_stack_wt_bwd_elems(r, s, win, n_layers)
    return torch.empty(n, dtype=torch.float32, device=dev) if n else None


def _fwd_buffers(lib, dev, batch, t, n_layers, r, s, ctx: bool):
    """(h, skip accumulator) float32 scratch, (hsave, tfsg, skip), and the
    wide forms' bf16 weight scratch (None at the narrow widths)."""
    m, bf = batch * t, torch.bfloat16
    return (torch.empty(m, r, dtype=torch.float32, device=dev),
            torch.empty(m, s, dtype=torch.float32, device=dev),
            torch.empty(n_layers, batch, t, r, dtype=bf, device=dev),
            torch.empty(n_layers, batch, t, 2 * r, dtype=bf, device=dev),
            torch.empty(batch, t, s, dtype=bf, device=dev),
            _weight_scratch(lib, dev, r, s, ctx, n_layers))


def run_bwd_x(lib, hsave, tfsg, ctx, w_fg, w_out, dskip, dilations,
              proj=None, stream=None):
    """Launch the non-embed save backward (B.2(a)); dskip in bf16 or, for
    the merged head, float32; in the float32 form every activation in
    float32.  Returns as ``stack_bwd_x_plain``."""
    return _launch_bwd(lib, hsave, tfsg, ctx, w_fg, w_out, dskip, dilations,
                       proj, stream)


def run_fwd_replay(lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations,
                   stream=None, every=0):
    """Launch the replay forward (outputs allocated here); returns
    (skip_sum, ckpt, tfsg) as ``stack_fwd_replay_plain``.  float32 x and
    ctx take the float32 form."""
    batch, t, n_layers, r, s, _ = _tails_check(lib, x, ctx, b_fg, w_fg,
                                               w_out, b_out, dilations,
                                               "replay")
    every = every or sk.tails_every(n_layers)
    dev, act, f32, m = x.device, x.dtype, torch.float32, batch * t
    f32_form = act == f32
    skip = torch.empty(batch, t, s, dtype=act, device=dev)
    ckpt = torch.empty(len(sk.ckpt_layers(n_layers, every)), batch, t, r,
                       dtype=f32, device=dev)
    tfsg = torch.empty(n_layers, batch, t, 2 * r, dtype=act, device=dev)
    ring = torch.empty(2, batch, t, r, dtype=act, device=dev)
    skacc = torch.empty(m, s, dtype=f32, device=dev)
    head = (_ptr(x), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out),
            _ptr(b_out), _dils(dilations), every)
    tail = (_ptr(skacc), _ptr(ring), _ptr(tfsg), _ptr(skip), _ptr(ckpt),
            batch, t, n_layers, r, s, stream)
    if f32_form:
        # in float32 the ring holds the residual stream
        _raise(lib.movenet_stack_fwd_replay_f32(*head, *tail),
               "stack_fwd_replay_f32")
    else:
        # the float32 residual stream beside the bf16 ring, and the wide
        # forms' weight scratch
        h = torch.empty(m, r, dtype=f32, device=dev)
        wt = _weight_scratch(lib, dev, r, s, ctx is not None, n_layers)
        _raise(lib.movenet_stack_fwd_replay(*head, _ptr(h), *tail[:5],
                                            _ptr(wt), *tail[5:]),
               "stack_fwd_replay")
    return skip, ckpt, tfsg


def run_replay_inputs(lib, x, ckpt, tfsg, w_out, b_out, stream=None,
                      every=0):
    """Every layer input (L, B, T, R) in float32 as the replay backward
    rebuilds it from x, the checkpoints and the taps (its rebuild launches,
    not counted): the save forward's residual stream, held to hsave bit for
    bit (in bf16 rounded)."""
    n_layers, batch, t, two_r = tfsg.shape
    r = two_r // 2
    s = w_out.shape[2] - r
    every = every or sk.tails_every(n_layers)
    dev, act = x.device, x.dtype
    _check("x", x, act, (batch, t, r), dev)
    _check("tfsg", tfsg, act, device=dev)
    _check("ckpt", ckpt, torch.float32,
           (len(sk.ckpt_layers(n_layers, every)), batch, t, r), dev)
    _check("w_out", w_out, torch.float32, (n_layers, r, r + s), dev)
    _check("b_out", b_out, torch.float32, (n_layers, r + s), dev)
    hf = torch.empty(n_layers, batch, t, r, dtype=torch.float32, device=dev)
    fn = lib.movenet_stack_replay_inputs_f32 if act == torch.float32 else \
        lib.movenet_stack_replay_inputs
    err = fn(_ptr(x), _ptr(ckpt), _ptr(tfsg), _ptr(w_out), _ptr(b_out),
             every, _ptr(hf), batch, t, n_layers, r, s, stream)
    _raise(err, "replay_inputs")
    return hf


def run_bwd_replay(lib, x, ckpt, tfsg, ctx, w_fg, w_out, b_out, dskip,
                   dilations, proj=None, stream=None, every=0):
    """Launch the replay backward (outputs and scratch allocated here);
    dskip in x's dtype.  Returns as ``stack_bwd_replay_plain``."""
    every = every or sk.tails_every(len(dilations))
    return _launch_bwd(lib, None, tfsg, ctx, w_fg, w_out, dskip, dilations,
                       proj, stream, replay=(x, ckpt, b_out, every))


def _head_check(lib, batch, t, r, s, targets_tb, w1, b1, w2, b2, dev):
    c = w2.shape[1]
    _check("targets_tb", targets_tb, torch.int32, (t, batch), dev)
    _check("w1", w1, torch.float32, (s, c), dev)
    _check("b1", b1, torch.float32, (c,), dev)
    _check("w2", w2, torch.float32, (c, c), dev)
    _check("b2", b2, torch.float32, (c,), dev)
    _widths(lib, "merged", r, s, "the merged kernels")
    if not lib.movenet_stack_head_supports(r, s, c):
        raise NotImplementedError(
            f"the merged head kernels take C <= 64, a multiple of 4, at "
            f"the trunk's built widths; got R={r}, S={s}, C={c} "
            "(ROADMAP.md B.4)")
    return c


def run_head_fwd(lib, x, ctx, b_fg, w_fg, w_out, b_out, targets_tb, w1, b1,
                 w2, b2, dilations, rf, parity, stream=None):
    """Launch the merged forward (B.6); returns (loss_sum, match_count,
    skip, hsave, tfsg) as ``stack_head_fwd_plain``."""
    batch, t, n_layers, r, s, _ = _x_check(
        lib, x, ctx, b_fg, w_fg, w_out, b_out, dilations,
        "the merged kernels", "merged")
    dev = x.device
    c = _head_check(lib, batch, t, r, s, targets_tb, w1, b1, w2, b2, dev)
    h, skacc, hsave, tfsg, skip, _ = _fwd_buffers(lib, dev, batch, t,
                                                  n_layers, r, s, False)
    part = torch.empty(lib.movenet_stack_blocks(), 2, dtype=torch.float32,
                       device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    err = lib.movenet_stack_head_fwd(
        _ptr(x), _ptr(ctx), _ptr(b_fg), _ptr(w_fg), _ptr(w_out), _ptr(b_out),
        _dils(dilations), _ptr(targets_tb), _ptr(w1), _ptr(b1), _ptr(w2),
        _ptr(b2), _ptr(h), _ptr(skacc), _ptr(hsave), _ptr(tfsg), _ptr(skip),
        _ptr(part), _ptr(out), batch, t, n_layers, r, s, c, rf, int(parity),
        stream)
    _raise(err, "stack_head_fwd")
    return out[0], out[1], skip, hsave, tfsg


def run_head_bwd(lib, hsave, tfsg, ctx, w_fg, w_out, skip, targets_tb, w1,
                 b1, w2, b2, dloss, dilations, rf, parity, stream=None):
    """Launch the merged backward (B.6): the head backward into a float32
    dskip, then the layer sweep from it.  Returns as
    ``stack_head_bwd_plain``."""
    n_layers, batch, t, two_r = tfsg.shape
    r = two_r // 2
    s = w_out.shape[2] - r
    dev = tfsg.device
    if skip.dtype != torch.bfloat16:
        raise ValueError(f32_unbuilt("the merged kernels", "merged",
                                     skip.dtype))
    _check("skip", skip, torch.bfloat16, (batch, t, s), dev)
    c = _head_check(lib, batch, t, r, s, targets_tb, w1, b1, w2, b2, dev)
    f32 = torch.float32
    dloss = torch.as_tensor(dloss, dtype=f32, device=dev).reshape(1) \
        .contiguous()
    blocks = lib.movenet_stack_blocks()
    n = s * c + c + c * c + c
    part = torch.empty(blocks, n, dtype=f32, device=dev)
    grads = torch.empty(n, dtype=f32, device=dev)
    dskip = torch.empty(batch, t, s, dtype=f32, device=dev)
    err = lib.movenet_stack_head_bwd(
        _ptr(skip), _ptr(targets_tb), _ptr(w1), _ptr(b1), _ptr(w2), _ptr(b2),
        _ptr(dloss), _ptr(dskip), _ptr(part), _ptr(grads), batch,
        t, s, c, rf, int(parity), blocks, stream)
    _raise(err, "stack_head_bwd")
    dx, dctx, db_fg, dw_fg, dw_out, db_out, _ = run_bwd_x(
        lib, hsave, tfsg, ctx, w_fg, w_out, dskip, dilations, None, stream)
    dw1, db1, dw2, db2 = torch.split(grads, [s * c, c, c * c, c])
    return (dx, dctx, db_fg, dw_fg, dw_out, db_out, dw1.view(s, c), db1,
            dw2.view(c, c), db2)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def stack_fwd(pack, table2, ctx, b_fg, w_fg, w_out, b_out,
              dilations: Sequence[int], batch: int):
    """(skip_sum, hsave, tfsg): the plain version for CPU tensors, the
    forward kernels for CUDA tensors."""
    if not table2.is_cuda:
        return sk.stack_fwd_plain(pack, table2, ctx, b_fg, w_fg, w_out,
                                  b_out, dilations, batch)
    out = run_fwd(library(), pack, table2, ctx, b_fg, w_fg, w_out, b_out,
                  dilations, batch, _stream(table2))
    launch_counts["stack_fwd_f32" if table2.dtype == torch.float32
                  else "stack_fwd"] += 1
    return out


def stack_bwd(hsave, tfsg, ctx, w_fg, w_out, dskip, pack, vocab: int,
              dilations: Sequence[int], proj=None):
    """The backward: the plain version for CPU tensors, the backward
    kernels for CUDA tensors (returns as ``stack_bwd_plain``)."""
    if not tfsg.is_cuda:
        return sk.stack_bwd_plain(hsave, tfsg, ctx, w_fg, w_out, dskip,
                                  pack, vocab, dilations, proj)
    out = run_bwd(library(), hsave, tfsg, ctx, w_fg, w_out, dskip, pack,
                  vocab, dilations, proj, _stream(tfsg))
    launch_counts["stack_bwd_f32" if tfsg.dtype == torch.float32
                  else "stack_bwd"] += 1
    return out


def stack_fwd_tails(x, ctx, b_fg, w_fg, w_out, b_out,
                    dilations: Sequence[int]):
    """(skip_sum, ckpt): the plain version for CPU tensors, the recompute
    forward kernels for CUDA tensors."""
    if not x.is_cuda:
        return sk.stack_fwd_tails_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                                        dilations)
    out = run_fwd_tails(library(), x, ctx, b_fg, w_fg, w_out, b_out,
                        dilations, _stream(x))
    launch_counts["stack_fwd_tails_f32" if x.dtype == torch.float32
                  else "stack_fwd_tails"] += 1
    return out


def stack_bwd_tails(x, ckpt, ctx, b_fg, w_fg, w_out, b_out, dskip,
                    dilations: Sequence[int]):
    """The recompute backward: the plain version for CPU tensors, the
    kernels for CUDA tensors (returns as ``stack_bwd_tails_plain``)."""
    if not x.is_cuda:
        return sk.stack_bwd_tails_plain(x, ckpt, ctx, b_fg, w_fg, w_out,
                                        b_out, dskip, dilations)
    out = run_bwd_tails(library(), x, ckpt, ctx, b_fg, w_fg, w_out, b_out,
                        dskip, dilations, _stream(x))
    launch_counts["stack_bwd_tails_f32" if x.dtype == torch.float32
                  else "stack_bwd_tails"] += 1
    return out


def stack_fwd_x(x, ctx, b_fg, w_fg, w_out, b_out, dilations: Sequence[int]):
    """(skip_sum, hsave, tfsg) of the non-embed save form: the plain
    version for CPU tensors, the forward kernels for CUDA tensors
    (counted with ``stack_fwd``, in float32 with ``stack_fwd_f32``)."""
    if not x.is_cuda:
        return sk.stack_fwd_x_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                                    dilations)
    out = run_fwd_x(library(), x, ctx, b_fg, w_fg, w_out, b_out, dilations,
                    _stream(x))
    launch_counts["stack_fwd_f32" if x.dtype == torch.float32
                  else "stack_fwd"] += 1
    return out


def stack_bwd_x(hsave, tfsg, ctx, w_fg, w_out, dskip,
                dilations: Sequence[int], proj=None):
    """The non-embed save backward: the plain version for CPU tensors,
    the backward kernels for CUDA tensors (counted with ``stack_bwd``, in
    float32 with ``stack_bwd_f32``)."""
    if not tfsg.is_cuda:
        return sk.stack_bwd_x_plain(hsave, tfsg, ctx, w_fg, w_out, dskip,
                                    dilations, proj)
    out = run_bwd_x(library(), hsave, tfsg, ctx, w_fg, w_out, dskip,
                    dilations, proj, _stream(tfsg))
    launch_counts["stack_bwd_f32" if tfsg.dtype == torch.float32
                  else "stack_bwd"] += 1
    return out


def stack_fwd_replay(x, ctx, b_fg, w_fg, w_out, b_out,
                     dilations: Sequence[int]):
    """(skip_sum, ckpt, tfsg) of the replay strategy: the plain version
    for CPU tensors, the forward kernels for CUDA tensors."""
    if not x.is_cuda:
        return sk.stack_fwd_replay_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                                         dilations)
    out = run_fwd_replay(library(), x, ctx, b_fg, w_fg, w_out, b_out,
                         dilations, _stream(x))
    launch_counts["stack_fwd_replay_f32" if x.dtype == torch.float32
                  else "stack_fwd_replay"] += 1
    return out


def stack_bwd_replay(x, ckpt, tfsg, ctx, w_fg, w_out, b_out, dskip,
                     dilations: Sequence[int], proj=None):
    """The replay backward: the plain version for CPU tensors, the
    kernels for CUDA tensors (returns as ``stack_bwd_replay_plain``)."""
    if not x.is_cuda:
        return sk.stack_bwd_replay_plain(x, ckpt, tfsg, ctx, w_fg, w_out,
                                         b_out, dskip, dilations, proj)
    out = run_bwd_replay(library(), x, ckpt, tfsg, ctx, w_fg, w_out, b_out,
                         dskip, dilations, proj, _stream(x))
    launch_counts["stack_bwd_replay_f32" if x.dtype == torch.float32
                  else "stack_bwd_replay"] += 1
    return out


def stack_head_fwd(x, ctx, b_fg, w_fg, w_out, b_out, targets_tb, w1, b1, w2,
                   b2, dilations: Sequence[int], rf: int, parity: bool):
    """(loss_sum, match, skip, hsave, tfsg) of the merged trunk + head:
    the plain version for CPU tensors, the kernels for CUDA tensors."""
    if not x.is_cuda:
        return sk.stack_head_fwd_plain(x, ctx, b_fg, w_fg, w_out, b_out,
                                       targets_tb, w1, b1, w2, b2, dilations,
                                       rf, parity)
    out = run_head_fwd(library(), x, ctx, b_fg, w_fg, w_out, b_out,
                       targets_tb, w1, b1, w2, b2, dilations, rf, parity,
                       _stream(x))
    launch_counts["stack_head_fwd"] += 1
    return out


def stack_head_bwd(hsave, tfsg, ctx, w_fg, w_out, skip, targets_tb, w1, b1,
                   w2, b2, dloss, dilations: Sequence[int], rf: int,
                   parity: bool):
    """The merged backward: the plain version for CPU tensors, the kernels
    for CUDA tensors (returns as ``stack_head_bwd_plain``)."""
    if not tfsg.is_cuda:
        return sk.stack_head_bwd_plain(hsave, tfsg, ctx, w_fg, w_out, skip,
                                       targets_tb, w1, b1, w2, b2, dloss,
                                       dilations, rf, parity)
    out = run_head_bwd(library(), hsave, tfsg, ctx, w_fg, w_out, skip,
                       targets_tb, w1, b1, w2, b2, dloss, dilations, rf,
                       parity, _stream(tfsg))
    launch_counts["stack_head_bwd"] += 1
    return out


__all__ = ["stack_fwd", "stack_bwd", "stack_fwd_tails", "stack_bwd_tails",
           "stack_fwd_x", "stack_bwd_x", "stack_fwd_replay",
           "stack_bwd_replay", "stack_head_fwd", "stack_head_bwd",
           "launch_counts", "reset_launch_counts", "KERNEL_SOURCE"]
