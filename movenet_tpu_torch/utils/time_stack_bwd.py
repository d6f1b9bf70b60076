"""Device time of the save-strategy trunk backward (``stack_bwd``), by
call and by grid, at the training shapes, optionally against another
copy of the kernel source on the same card; with ``--forward``, of the
save forward (``stack_fwd``) and the merged forward (``stack_head_fwd``)
instead; with ``--recompute``, of the recompute strategy's forward and
backward (``stack_fwd_tails``, ``stack_bwd_tails``); with ``--replay``, of
the replay strategy's (``stack_fwd_replay``, ``stack_bwd_replay``); with
``--gated``, of the gated-block kernels (``gated_block_fwd``,
``gated_block_bwd``).

    python -m movenet_tpu_torch.utils.time_stack_bwd [--parent DIR]
        [--shapes breakdancing,exp03,exp04] [--repeats 5]
    python -m movenet_tpu_torch.utils.time_stack_bwd --forward
        [--parent DIR] [--shapes breakdancing,exp03,exp04] [--repeats 5]
    python -m movenet_tpu_torch.utils.time_stack_bwd --recompute
        [--parent DIR] [--shapes exp02,flagship] [--repeats 5]
        [--dtype float32] [--sass]
    python -m movenet_tpu_torch.utils.time_stack_bwd --replay
        [--parent DIR] [--shapes flagship_r128,exp02_r128] [--repeats 5]
    python -m movenet_tpu_torch.utils.time_stack_bwd --gated
        [--parent DIR] [--shapes 64x64_d1,64x64_d512,32x8,16x8]

Shapes (T = 160,000, bf16, video as the stride-10 projection triple,
seeded random codes, table, triple, weights and dskip):
breakdancing (B=2, dilations (1,2,4) x 3, R=S=64, V=64), exp03 (B=3,
(1,2,1,2), R=32, S=8, V=128), exp04 (B=2, 1..8192, R=16, S=8, V=128);
named only: probe (B=2, (1,2,4) x 3, R=S=128, V=64; the wide save forms)
and exp02_r128 (the same at S=8).
hsave and tfsg come from the kernel forward.  Each call is timed by CUDA
events (mean of ``--repeats`` after a warm call), and once under
``torch.profiler`` by grid.  With ``--parent DIR`` (a checkout of another
commit, e.g. ``git archive`` unpacked under ``build/``), that copy's
``csrc/stack_kernel.cu`` is compiled with the same nvcc flags and bound
by its own ``ops/cuda/stack_kernel.py``; the two are timed in turns
(parent, this, this, parent) and their gradients compared (max
difference over each gradient's scale, and whether all are bit-equal);
the merged backward (``stack_head_bwd``, breakdancing widths, C = 64,
parity CE, from the kernel's merged forward) likewise.  With
``--variants``, two
diagnostic builds of this checkout's source are timed beside it by grid:
``no_mma`` (the tensor-core products left out: the loads, stores and
epilogues alone) and ``one_pass`` (big*big only, no split passes); their
gradients are wrong by design and are not compared.

``--forward`` times ``stack_fwd`` at the same shapes from the same
seeded codes, table, triple and weights, and ``stack_head_fwd`` (the
merged trunk + head + CE, parity CE) at the breakdancing widths with C =
64 and seeded x, ctx, targets and head weights: by call (CUDA events) and
by grid, the two copies in turns (parent, this, this, parent), their
outputs compared (max difference over scale and the bit-equal share of
each output; the loss as a relative difference, the match count as a
difference).

``--recompute`` shapes (T = 160,000, bf16 or with ``--dtype float32``
float32, seeded random x, ctx, weights and dskip): exp02 (experiment 02
through the CLI: B=2, dilations (1,2,4) x 3, R=64, S=8, flat ctx) and
flagship (B=2, dilations 1..512 x 3, R=S=64, no ctx); named only,
flagship_r128 (B=2, dilations 1..512 x 3, R=S=128, flat ctx: the
flagship's depth at R = S = 128) and exp02_r128 (B=2, (1,2,4) x 3, R=128,
S=8, flat ctx).  Each side's forward and backward by call (CUDA events)
and by grid: the weight copies, the layer kernel's launches ("rebuild /
taps" in the backward: the rebuilt inputs and, in float32 at R = 128, the
taps launches), the layer backward ("layer"), W_fg's and W_out's
gradients, dx, the reductions.  Each side's backward takes its own
forward's saved tensors (the parent's layout may differ); the outputs are
compared as above and said bit-equal or not.  A parent that raises at a
shape is reported and not timed.  ``--replay`` does the same for the
bf16 replay strategy at the R = 128 shapes (default flagship_r128 and
exp02_r128): the forward's outputs (skip, ckpt, tfsg) and the backward's
compared, the backward by grid (its weight images, rebuilds, layer
launches, W_fg's and W_out's gradients).  ``--sass`` prints, per kernel of
the built trunk library, its HGMMA (wgmma) and HMMA (mma.sync)
instructions in ``cuobjdump -sass`` (the wgmma kernels' only: kernel A,
stack_bwd_wg_kernel and stack_wgrad_wg_kernel).

``--gated`` shapes (T = 160,000, bf16, flat ctx, seeded random h, ctx,
weights, dres and dskip): one block at R = S = 64, B = 2, d = 1 and d =
512 (the breakdancing widths), (32, 8) at B = 3 and (16, 8) at B = 2,
d = 1.  Each kernel by call (CUDA events) and by grid; with ``--parent``
the parent's ``csrc/gated_block.cu`` and wrapper in turns (parent, this,
this, parent), the outputs compared as above; whether two calls of this
source give the same bits.  ``--variants`` times builds of this source
with GATED_VARIANTS' edits after them (``warps16``: 16 warps a block at
R >= 32; ``mt4``: a warp takes all 64 rows of a tile at R = 64;
``no_mma``: the tensor-core products left out, outputs wrong by design
and not compared).  Prints the card's name and power limit.
Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

SHAPES = {"breakdancing": (2, 64, 64, (1, 2, 4) * 3, 64),
          "exp03": (3, 32, 8, (1, 2, 1, 2), 128),
          "exp04": (2, 16, 8, tuple(2 ** i for i in range(14)), 128)}
# the wide save forms' shapes, named with --shapes only: the R = 128
# model of scripts/probe_r128_mfu.py and experiment 02's CLI widths at
# --residual_channels 128
WIDE_SHAPES = {"probe": (2, 128, 128, (1, 2, 4) * 3, 64),
               "exp02_r128": (2, 128, 8, (1, 2, 4) * 3, 64)}
RECOMPUTE_SHAPES = {"exp02": (2, 64, 8, (1, 2, 4) * 3, True),
                    "flagship": (2, 64, 64, tuple(2 ** i for i in range(10))
                                 * 3, False)}
# the float32 recompute kernels' R = 128 shapes, named with --shapes only
WIDE_RECOMPUTE_SHAPES = {
    "flagship_r128": (2, 128, 128, tuple(2 ** i for i in range(10)) * 3,
                      True),
    "exp02_r128": (2, 128, 8, (1, 2, 4) * 3, True)}
GATED_SHAPES = {"64x64_d1": (2, 64, 64, 1), "64x64_d512": (2, 64, 64, 512),
                "32x8": (3, 32, 8, 1), "16x8": (2, 16, 8, 1)}
T = 160_000
# the grids of the save backward (and the merged backward's head
# launch, and the recompute strategy's layer-forward and W_out launches),
# by a pattern (re.search) of the kernel name each launch carries
GRIDS = (("weights", "stack_wt"),
         ("layer", "stack_bwd_layer_kernel|stack_bwd_wg_kernel"),
         ("wgrad W_fg", "stack_wgrad_kernel<0|stack_wgrad_wg_kernel<0"),
         ("wgrad W_out", "stack_wgrad_kernel<1"),
         ("wgrad W_up", "stack_wgrad_kernel<2"),
         ("wgrad W_out (gated)", "stack_wgrad_kernel<3"),
         ("layer forward", "stack_layer_kernel"),
         ("reductions", "reduce_kernel"),
         ("head", "stack_head_bwd_kernel"))
# the recompute and replay strategies' grids, forward and backward (either
# source's kernel names): the forward's layer launches count under "rebuild
# / taps" too
RECOMPUTE_GRIDS = (
    ("weights", "stack_wt"),
    ("rebuild / taps", "stack_layer_wg_f32_kernel|stack_layer_f32_kernel|"
                       "stack_layer_kernel|stack_rebuild"),
    ("layer", "stack_bwd_wg_f32_kernel|stack_bwd_wg_kernel|"
              "stack_bwd_layer_kernel"),
    ("wgrad W_fg", "stack_wgrad_kernel<[047]|stack_wgrad_wg_kernel"),
    ("wgrad W_out", "stack_wgrad_kernel<[136]"),
    ("dx", "stack_dx_kernel"),
    ("reductions", "reduce_kernel"))
# the gated-block kernels' grids (the parent's backward sweep under its
# own name)
GATED_GRIDS = (("forward", "gated_fwd_kernel"),
               ("layer", "gated_bwd_kernel"),
               ("wgrad W_fg", "gated_wgrad_kernel<0"),
               ("wgrad W_out", "gated_wgrad_kernel<1"),
               ("carry", "gated_carry_kernel"),
               ("reductions", "reduce_kernel"))
# the save and merged forwards' grids (the parent's layer kernel under its
# own name)
FWD_GRIDS = (("last layer + head", r"stack_layer_kernel<\d+,\d+,2>"),
             ("layers", "stack_layer_kernel|stack_fwd_layer_kernel"),
             ("embed or x", "stack_embed_kernel|stack_x_kernel"),
             ("reductions", "reduce_kernel"))


# diagnostic edits of csrc/stack_kernel.cu: (text, replacement) pairs,
# each applying once; of the backward, and of the save forward
VARIANTS = {
    "no_mma": (('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "',
                '  if (0) asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32'
                '.f32 "'),),
    "one_pass": (("  if (SPLIT_A) mma_tf32(d, a.small, b.big);\n"
                  "  mma_tf32(d, a.big, b.small);\n", ""),),
}
# diagnostic edits of the wide float32 recompute kernels (kernels A and B,
# csrc/stack_kernel.cu), timed with --recompute --variants: their outputs
# are wrong by design and are not compared
RECOMPUTE_VARIANTS = {
    # the producers' operand-row loads left out (zeros split and stored)
    "no_row_loads": (
        ("            v[u] = ok ? __ldg(reinterpret_cast<const float4*>(src))"
         "\n                      : make_float4(0.f, 0.f, 0.f, 0.f);",
         "            v[u] = make_float4(0.f, 0.f, 0.f, 0.f);"),
        ("            v[u] = m < m_total ? *reinterpret_cast<const float4*>(\n"
         "                                     a.dfg + m * 2 * R + KC * c +\n"
         "                                     4 * ((i >> 3) & 3))\n"
         "                               : make_float4(0.f, 0.f, 0.f, 0.f);",
         "            v[u] = make_float4(0.f, 0.f, 0.f, 0.f);")),
    # the weight images' bulk copies left out (the stages' B images stale)
    "no_weight_copies": (
        ("        mbar_arrive_tx(full + pos.stage, rows * KC * 8);\n"
         "        bulk_g2s(ring + pos.stage * Sh::kStage + 2 * Sh::kA, src,\n"
         "                 rows * KC * 8, full + pos.stage);",
         "        mbar_arrive(full + pos.stage);"),
        ("        mbar_arrive_tx(full + pos.stage, b_bytes);\n"
         "        bulk_g2s(st + 2 * Sh::kA, b_src, b_bytes, full + pos.stage);",
         "        mbar_arrive(full + pos.stage);")),
    # the layer launches' epilogues left out (kernel B's block, every form):
    # no taps read and no gated or dfg stored after dgated, no dhp, p_out
    # or dctx after dfg_w (the products, loads and hand-offs alone)
    "no_epilogues": (
        ("            const long m = mrow[e];\n"
         "            if (m >= m_total) continue;\n"
         "            float tf[2], sg[2];",
         "            const long m = mrow[e];\n"
         "            if (m >= 0) continue;\n"
         "            float tf[2], sg[2];"),
        ("            if (m >= m_total) continue;\n"
         "            const float x0 = run[4 * jb + 2 * e], "
         "x1 = run[4 * jb + 2 * e + 1];",
         "            if (m >= 0) continue;\n"
         "            const float x0 = run[4 * jb + 2 * e], "
         "x1 = run[4 * jb + 2 * e + 1];")),
    # no wgmma issued (the loads, splits, stores, barriers and epilogues)
    "no_wgmma": (
        ("    wgmma_tf32<N>(t, desc_add(as, o), desc_add(bb, o), zero && s == 0 "
         "? 0 : 1);\n    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bs, o), 1);"
         "\n    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bb, o), 1);", ""),),
    # one pass (big * big) in place of the split's three
    "one_pass": (
        ("    wgmma_tf32<N>(t, desc_add(as, o), desc_add(bb, o), zero && s == 0 "
         "? 0 : 1);\n    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bs, o), 1);"
         "\n    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bb, o), 1);",
         "    wgmma_tf32<N>(t, desc_add(ab, o), desc_add(bb, o), "
         "zero && s == 0 ? 0 : 1);"),),
}
GATED_VARIANTS = {
    # blocks of 16 warps at R >= 32 (a 16-row m tile a warp)
    "warps16": (("static constexpr int kWarps = 8, kThreads",
                 "static constexpr int kWarps = R >= 32 ? 16 : 8, kThreads"),),
    # 64 rows a warp at R = 64 (W fragments split once for four m tiles)
    "mt4": (("static constexpr int kMt = kWarps == 16 || R < 32 ? 1 : 2;",
             "static constexpr int kMt = kWarps == 16 || R < 32 ? 1 : "
             "R >= 64 ? 4 : 2;"),),
    "no_mma": VARIANTS["no_mma"],
}
# the wide save forward's ring step, from its tile loop's first line
WIDE_STEP = ("mr = m0 + r0, next = tile_i + gridDim.x;\n    int j = 0;\n"
             "    // step j of the tile: slab j resident for every warp; in "
             "flight the\n    // next slab (after the last, the next tile's "
             "first) and, once the fg\n    // passes are done with hp, the "
             "next tile's operand rows\n    auto step = [&]() -> const "
             "bf16_t* {\n      cp_async_wait<0>();\n")
FWD_VARIANTS = {
    # the save form's exactness work left out: no fg summed again in the
    # plain version's order (no ties flagged; flagged but the queue not
    # run); the residual's fmaf chain not run
    "no_resum": (("bool ff = near_bf16_tie(t, tt), fs = near_bf16_tie(s, ts);",
                  "bool ff = false, fs = false;"),
                 ("      if (a.raw_gate) {\n        const float tp",
                  "      if (0) {\n        const float tp")),
    "no_queue": (("for (int rb = 0; rb < n_q; rb += QCAP) {",
                  "for (int rb = 0; rb < n_q && n_q < 0; rb += QCAP) {"),),
    # the queue's parts left out: the chain sums, the gate
    "q_nochain": (("fg_chain<LDH, LDW>(hp, wf, row, srow(col), win) +\n",
                   "0.f +\n"),),
    "q_nogate": (("qv[i] = col < R ? tanhf(v) : sigmoidf(v);", "qv[i] = v;"),),
    "no_chain": (("#pragma unroll 4\n      for (int k = 0; k < R; ++k) {",
                  "#pragma unroll 4\n      for (int k = 0; k < 0; ++k) {"),),
    # parts of the save form's traffic left out: the tfsg stores, the
    # float32 residual's loads and stores, the skip sum's
    "no_tfsg": (("st32(tp, pack2(vf[2 * h], vf[2 * h + 1]));", "(void)tp;"),
                ("st32(tp + R, pack2(vg[2 * h], vg[2 * h + 1]));", "")),
    "no_h32": (("    if (read_h) stage_rows_f32<R, LDHF>(", "    if (0) "
                "stage_rows_f32<R, LDHF>("),
               ("          if (a.keep_h)\n            *reinterpret_cast<"
                "float2*>(a.hf + m * R + c) =", "          if (0)\n"
                "            *reinterpret_cast<float2*>(a.hf + m * R + c) =")),
    "no_skacc": (("    if (read_s)\n      stage_rows_f32<S, LDSF>(",
                  "    if (0)\n      stage_rows_f32<S, LDSF>("),
                 ("              *reinterpret_cast<float2*>(a.skacc + m * S "
                  "+ c) = s;", "              ;")),
    # the save forms' occupancy: one block an SM at every width (up to 255
    # registers a thread), three at R = 16, or blocks of 4 warps, four an
    # SM, where two blocks of 8 run
    "blocks1": (("kMinBlocks = R + S <= 48 ? 2 : 1;", "kMinBlocks = 1;"),),
    "blocks3": (("kMinBlocks = R + S <= 48 ? 2 : 1;",
                 "kMinBlocks = R <= 16 ? 3 : R + S <= 48 ? 2 : 1;"),),
    "warps4": (("kWarps = 8, kThreads",
                "kWarps = R + S <= 48 ? 4 : 8, kThreads"),
               ("kMinBlocks = R + S <= 48 ? 2 : 1;",
                "kMinBlocks = R + S <= 48 ? 4 : 1;")),
    # fg in one pass at R = 32 (its sums and taps all live at once)
    "one_fg_pass": (("constexpr int FP = R >= 32 ? 2 : 1,",
                     "constexpr int FP = R >= 64 ? 2 : 1,"),),
    # the wide save forward's parts left out: the residual's fmaf chain,
    # the wait for each weight slab (its reads race the copy: outputs wrong
    # by design; the edit is anchored at the save form's tile loop, whose
    # ring step the wide recompute form's repeats); the shared edits above
    # reach the wide forms' passes too
    "wide_no_chain": (("#pragma unroll 2\n      for (int k = 0; k < KH; ++k) {",
                       "#pragma unroll 2\n      for (int k = 0; k < 0; ++k) {"),),
    "wide_no_wait": ((WIDE_STEP, WIDE_STEP.replace(
        "      cp_async_wait<0>();\n", "")),),
}


def compile_source(text: str, include: Path, tag: str,
                   name: str = "stack_kernel") -> Path:
    """``text`` (a ``<name>.cu``, including headers from ``include``)
    compiled with the build's nvcc flags into
    ``build/movenet_tpu_torch/<tag>/``, named by its hash."""
    return compile_sources([text], include, tag, name)[0]


def compile_sources(texts, include: Path, tag: str,
                    name: str = "stack_kernel"):
    """``compile_source`` of each of ``texts``, one nvcc each, all started
    together; their library paths (nvcc's output beside each, ``.log``)."""
    from movenet_tpu_torch.ops.cuda import build

    outs, procs = [], []
    for text in texts:
        h = hashlib.sha256(text.encode())
        for header in sorted(include.glob("*.cuh")):
            h.update(header.read_bytes())
        out = build.build_dir() / tag / f"{name}-{h.hexdigest()[:16]}.so"
        outs.append(out)
        if not out.is_file():
            out.parent.mkdir(parents=True, exist_ok=True)
            src = out.with_suffix(".cu")
            src.write_text(text)
            procs.append((out, subprocess.Popen(
                [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(include),
                 "-o", str(out), str(src)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
    for out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
        out.with_suffix(".log").write_text(log)
    return outs


def _load(name: str, path: Path):
    """The module at ``path`` under ``name``, registered in sys.modules
    (dataclasses need that)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def parent_kernels(parent: Path):
    """(bound library, wrapper module) of ``parent``'s trunk kernels; the
    wrapper sees the parent's own ``ops/stack_kernel.py`` (its layouts)."""
    pkg = parent / "movenet_tpu_torch"
    csrc = pkg / "csrc"
    out = compile_source((csrc / "stack_kernel.cu").read_text(), csrc,
                         "parent")
    mod = _load("parent_stack_kernel", pkg / "ops" / "cuda" / "stack_kernel.py")
    mod.sk = _load("parent_ops_stack_kernel", pkg / "ops" / "stack_kernel.py")
    return mod.bind(ctypes.CDLL(str(out))), mod


def parent_gated_kernels(parent: Path):
    """(bound library, wrapper module) of ``parent``'s gated-block
    kernels."""
    pkg = parent / "movenet_tpu_torch"
    csrc = pkg / "csrc"
    out = compile_source((csrc / "gated_block.cu").read_text(), csrc,
                         "parent", "gated_block")
    mod = _load("parent_gated_block", pkg / "ops" / "cuda" / "gated_block.py")
    return mod.bind(ctypes.CDLL(str(out))), mod


def inlined_source(name: str) -> str:
    """``csrc/<name>.cu`` with the split-TF32 headers inlined
    (``mma_tf32.cuh``, and ``wgmma_tf32.cuh`` where it is included), so
    that a variant's edit may reach their helpers."""
    from movenet_tpu_torch.ops.cuda import build

    mma = (build.CSRC / "mma_tf32.cuh").read_text().replace(
        "#pragma once\n", "")
    wg = (build.CSRC / "wgmma_tf32.cuh").read_text().replace(
        "#pragma once\n", "").replace('#include "mma_tf32.cuh"\n', "")
    return (build.CSRC / f"{name}.cu").read_text().replace(
        '#include "mma_tf32.cuh"\n', mma).replace(
        '#include "wgmma_tf32.cuh"\n', wg)


def apply_edits(text: str, name: str, edits) -> str:
    """``text`` with each (old, new) edit of variant ``name``, each old
    text found exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: its edit does not apply")
        text = text.replace(old, new)
    return text


def gated_variant_kernels(names=None) -> dict:
    """{name: (bound library, wrapper module)} of this checkout's
    ``gated_block.cu`` with each of GATED_VARIANTS (those in ``names`` if
    given), compiled in parallel; prints ptxas' registers of each."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.ops.cuda import gated_block as kg

    table = {k: v for k, v in GATED_VARIANTS.items()
             if names is None or k in names}
    base = inlined_source("gated_block")
    texts = [apply_edits(base, name, edits) for name, edits in table.items()]
    libs = compile_sources(texts, build.CSRC, "variants", "gated_block")
    for name, lib in zip(table, libs):
        log = lib.with_suffix(".log")
        regs = re.findall(r"Used (\d+) registers", log.read_text()) \
            if log.is_file() else []
        print(f"variant {name}: registers {' '.join(regs)}", flush=True)
    return {name: (kg.bind(ctypes.CDLL(str(lib))), kg)
            for name, lib in zip(table, libs)}


def variant_kernels(table, names=None) -> dict:
    """{name: bound library} of this checkout's source with each variant
    of ``table`` (VARIANTS or FWD_VARIANTS; those in ``names`` if given),
    compiled in parallel.  Prints ptxas' registers and spills of each
    variant's save-form layer kernels."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks
    from movenet_tpu_torch.utils.time_spec import ptxas_text

    if names is not None:
        unknown = set(names) - set(table)
        if unknown:
            raise SystemExit(f"unknown variants: {sorted(unknown)}")
        table = {k: v for k, v in table.items() if k in names}
    base = inlined_source("stack_kernel")
    texts = [apply_edits(base, name, edits) for name, edits in table.items()]
    libs = compile_sources(texts, build.CSRC, "variants")
    for name, lib in zip(table, libs):
        log = lib.with_suffix(".log")
        text = ptxas_text(log.read_text() if log.is_file() else "",
                          "stack_layer_kernel")
        for line in text.splitlines():
            if "ELi0EE" not in line:   # the save forms, not the recompute
                print(f"variant {name}: {line}", flush=True)
    return {name: ks.bind(ctypes.CDLL(str(lib)))
            for name, lib in zip(table, libs)}


def fwd_inputs(torch, name: str, seed: int = 0):
    """(the save forward's arguments (pack, table2, ctx, b_fg, w_fg, w_out,
    b_out, dilations, batch), the projection triple, generator) at shape
    ``name``."""
    from movenet_tpu_torch.ops import stack_kernel as sk

    b, r, s, dil, v = {**SHAPES, **WIDE_SHAPES}[name]
    n, bf = len(dil), torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    codes = torch.randint(0, v, (b, T), generator=g, device="cuda",
                          dtype=torch.int32)
    prev = torch.cat([torch.full_like(codes[:, :1], -1), codes[:, :-1]], 1)
    pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)],
                     0).t().contiguous()
    trip = (rn(b, T // 10, r, scale=0.5).to(bf),
            rn(r, 10 * r, scale=r ** -0.5), rn(10 * r, scale=0.1))
    win = 3 * r
    with torch.no_grad():
        ctx = sk.ctx_flatten(trip, bf)
        w_fg = rn(n, win, 2 * r, scale=win ** -0.5)
        w_out = rn(n, r, r + s, scale=r ** -0.5)
        table2 = rn(2 * v, r, scale=0.5).to(bf)
        b_fg = rn(n * b, 2 * r, scale=0.1)
        b_out = rn(n, r + s, scale=0.1)
    return (pack, table2, ctx, b_fg, w_fg, w_out, b_out, dil, b), trip, g


def inputs(torch, name: str, seed: int = 0):
    """The backward's arguments (hsave, tfsg, ctx, w_fg, w_out, dskip,
    pack, vocab, dilations, proj) at shape ``name``."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    fargs, trip, g = fwd_inputs(torch, name, seed)
    pack, _, ctx, _, w_fg, w_out, _, dil, b = fargs
    with torch.no_grad():
        _, hsave, tfsg = ks.run_fwd(ks.library(), *fargs, ks._stream(pack))
    s = w_out.shape[2] - w_out.shape[1]
    dskip = (torch.randn(b, T, s, generator=g, device="cuda")
             * 1e-3).to(torch.bfloat16)
    return (hsave, tfsg, ctx, w_fg, w_out, dskip, pack,
            {**SHAPES, **WIDE_SHAPES}[name][4], dil, sk._ctx_proj_args(trip))


def head_inputs(torch, seed: int = 0, c: int = 64):
    """The merged forward's arguments (x, ctx, b_fg, w_fg, w_out, b_out,
    targets (T, B), w1, b1, w2, b2, dilations, rf, parity) at the
    breakdancing widths with C classes."""
    b, r, s, dil, _ = SHAPES["breakdancing"]
    n, bf, win = len(dil), torch.bfloat16, 3 * r
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    tgt = torch.randint(0, c, (T, b), generator=g, device="cuda",
                        dtype=torch.int32)
    return (rn(b, T, r, scale=0.5).to(bf), rn(b, T, r, scale=0.5).to(bf),
            rn(n * b, 2 * r, scale=0.1), rn(n, win, 2 * r, scale=win ** -0.5),
            rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), tgt,
            rn(s, c, scale=s ** -0.5), rn(c, scale=0.1),
            rn(c, c, scale=c ** -0.5), rn(c, scale=0.1), dil, sum(dil) + 1,
            True)


def recompute_inputs(torch, name: str, seed: int = 0, dtype=None):
    """(forward args (x, ctx, b_fg, w_fg, w_out, b_out, dilations), dskip)
    of the recompute kernels at shape ``name``, the activations in ``dtype``
    (bf16 by default)."""
    b, r, s, dil, has_ctx = {**RECOMPUTE_SHAPES, **WIDE_RECOMPUTE_SHAPES}[name]
    n, bf = len(dil), dtype or torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    win = (3 if has_ctx else 2) * r
    fargs = (rn(b, T, r, scale=0.5).to(bf),
             rn(b, T, r, scale=0.5).to(bf) if has_ctx else None,
             rn(n * b, 2 * r, scale=0.1), rn(n, win, 2 * r, scale=win ** -0.5),
             rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), dil)
    return fargs, rn(b, T, s, scale=1e-3).to(bf)


def gated_inputs(torch, name: str, seed: int = 0):
    """((h, ctx, b_fg, w_fg, w_out), b_out, dres, dskip, d) of one gated
    block at shape ``name`` of GATED_SHAPES."""
    b, r, s, d = GATED_SHAPES[name]
    win, bf = 3 * r, torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    args = (rn(b, T, r, scale=0.5).to(bf), rn(b, T, r, scale=0.5).to(bf),
            rn(b, 2 * r, scale=0.1), rn(win, 2 * r, scale=win ** -0.5),
            rn(r, r + s, scale=r ** -0.5))
    return (args, rn(1, r + s, scale=0.1), rn(b, T, r, scale=1e-3).to(bf),
            rn(b, T, s, scale=1e-3).to(bf), d)


def time_gated(torch, old, name: str, repeats: int, card: str,
               variants=None) -> None:
    """Print the gated-block kernels' times at ``name`` by call and by
    grid (against ``old`` = (library, wrapper module) of another source,
    in turns; each of ``variants`` beside them)."""
    from movenet_tpu_torch.ops.cuda import gated_block as kg

    args, b_out, dres, dskip, d = gated_inputs(torch, name)
    st = kg._stream(args[0])
    sides = {"this": (kg.library(), kg)}
    if old is not None:
        sides["parent"] = old
    for vname, v in (variants or {}).items():
        sides[f"variant {vname}"] = v
    fns = {"fwd": {k: (lambda lib=lib, mod=mod: mod.run_fwd(
                       lib, *args, b_out, d, st))
                   for k, (lib, mod) in sides.items()},
           "bwd": {k: (lambda lib=lib, mod=mod: mod.run_bwd(
                       lib, *args, dres, dskip, d, st))
                   for k, (lib, mod) in sides.items()}}
    names = {"fwd": ("res", "skip"),
             "bwd": ("dh", "dctx", "db_fg", "dw_fg", "dw_out", "db_out")}
    for kind, by_side in fns.items():
        order = ("parent", "this", "this", "parent") if old is not None \
            else ("this",)
        order += tuple(k for k in by_side if k.startswith("variant"))
        ms = {}
        for side in order:
            ms.setdefault(side, []).append(events_ms(torch, by_side[side],
                                                     repeats))
        line = f"gated_block_{kind} {name}: " + "; ".join(
            f"{side} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
            for side, vals in ms.items())
        new, again = by_side["this"](), by_side["this"]()
        line += "; two calls bit-equal: " + str(all(
            torch.equal(u, v) for u, v in zip(new, again) if u is not None))
        for side, fn in by_side.items():
            if side != "this" and "no_mma" not in side:
                line += f"; against {side}: " + diff_text(names[kind], new,
                                                           fn())
        for side, fn in by_side.items():
            grids = by_grid(torch, fn, GATED_GRIDS)
            line += f"; by grid ({side}) " + ", ".join(
                f"{k} {v:.3f}" for k, v in grids.items() if v > 0) \
                + f" (device {sum(grids.values()):.3f} ms)"
        print(f"{line}; {card}", flush=True)


def time_merged_bwd(torch, lib, old, repeats: int, card: str) -> None:
    """Print the merged backward's time at the breakdancing widths (C =
    64, parity CE) against ``old``, and whether the two give the same
    bits."""
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    args = head_inputs(torch)
    x, ctx, _, w_fg, w_out, _, tgt, w1, b1, w2, b2, dil, rf, parity = args
    st = ks._stream(x)
    with torch.no_grad():
        skip, hsave, tfsg = ks.run_head_fwd(lib, *args, stream=st)[2:]

    def side(slib, smod):
        return lambda: smod.run_head_bwd(
            slib, hsave, tfsg, ctx, w_fg, w_out, skip, tgt, w1, b1, w2, b2,
            1.0, dil, rf, parity, stream=st)

    fns = {"this": side(lib, ks), "parent": side(*old)}
    ms = {}
    for name in ("parent", "this", "this", "parent"):
        ms.setdefault(name, []).append(events_ms(torch, fns[name], repeats))
    new, prev = fns["this"](), fns["parent"]()
    equal = all(torch.equal(u, v) for u, v in zip(new, prev)
                if u is not None)
    print("stack_head_bwd breakdancing C=64: " + "; ".join(
        f"{k} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
        for k, vals in ms.items()) + f"; bit-equal to the parent: {equal}; "
        + diff_text(("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out",
                     "dw1", "db1", "dw2", "db2"), new, prev) + f"; {card}",
        flush=True)


def time_recompute(torch, lib, old, name: str, repeats: int,
                   card: str, dtype=None, variants=None,
                   replay: bool = False) -> None:
    """Print the recompute forward's and backward's times at ``name`` (with
    ``replay``, the replay strategy's), the activations in ``dtype``
    (against ``old`` = (library, wrapper module) of another source;
    ``variants``: {name: library} of RECOMPUTE_VARIANTS, each timed by call
    and by grid, not compared)."""
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    fargs, dskip = recompute_inputs(torch, name, dtype=dtype)
    name = f"{name} {str(fargs[0].dtype).split('.')[-1]}"
    st = ks._stream(fargs[0])
    strategy = "replay" if replay else "tails"

    def fwd(slib, smod):
        run = smod.run_fwd_replay if replay else smod.run_fwd_tails
        return run(slib, *fargs, stream=st)

    def bwd(slib, smod, out):
        x, ctx, b_fg, w_fg, w_out, b_out, dil = fargs
        if replay:
            return smod.run_bwd_replay(slib, x, out[1], out[2], ctx, w_fg,
                                       w_out, b_out, dskip, dil, stream=st)
        return smod.run_bwd_tails(slib, x, out[1], ctx, b_fg, w_fg, w_out,
                                  b_out, dskip, dil, stream=st)

    sides = {"this": (lib, ks)}
    if old is not None:
        try:
            fwd(*old)
            sides["parent"] = old
        except NotImplementedError as e:
            print(f"{strategy} {name}: the parent raises: {e}", flush=True)
    fns = {"fwd": {}, "bwd": {}}
    for side, (slib, smod) in sides.items():
        out = fwd(slib, smod)
        fns["fwd"][side] = (lambda slib=slib, smod=smod: fwd(slib, smod))
        fns["bwd"][side] = (lambda slib=slib, smod=smod, out=out:
                            bwd(slib, smod, out))
    names = {"fwd": ("skip", "ckpt", "tfsg") if replay else ("skip",),
             "bwd": ("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out")}
    for kind, by_side in fns.items():
        order = ("parent", "this", "this", "parent") if len(by_side) > 1 \
            else ("this",)
        ms = {}
        for side in order:
            ms.setdefault(side, []).append(events_ms(torch, by_side[side],
                                                     repeats))
        line = f"stack_{kind}_{strategy} {name}: " + "; ".join(
            f"{side} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
            for side, vals in ms.items())
        if len(by_side) > 1:
            new, old_out = by_side["this"](), by_side["parent"]()
            equal = all((u is None and v is None) or torch.equal(u, v)
                        for u, v in zip(new, old_out))
            line += (f"; bit-equal to the parent: {equal}; "
                     + diff_text(names[kind], new, old_out))
        for side, fn in by_side.items():
            grids = by_grid(torch, fn, RECOMPUTE_GRIDS)
            line += f"; by grid ({side}) " + ", ".join(
                f"{k} {v:.3f}" for k, v in grids.items() if v > 0) \
                + f" (device {sum(grids.values()):.3f} ms)"
        print(f"{line}; {card}", flush=True)
    for vname, vlib in (variants or {}).items():
        out = fwd(vlib, ks)
        for kind, fn in (("fwd", lambda: fwd(vlib, ks)),
                         ("bwd", lambda: bwd(vlib, ks, out))):
            grids = by_grid(torch, fn, RECOMPUTE_GRIDS)
            print(f"stack_{kind}_{strategy} {name} variant {vname}: "
                  f"{events_ms(torch, fn, repeats):.3f} ms; by grid "
                  + ", ".join(f"{k} {v:.3f}" for k, v in grids.items()
                              if v > 0) + f"; {card}", flush=True)


def sass_counts(path) -> dict:
    """{kernel (mangled name): (HGMMA, HMMA, local-memory instructions)}
    of a built library, from ``cuobjdump -sass``: wgmma issues HGMMA,
    mma.sync HMMA, register spills LDL and STL."""
    from movenet_tpu_torch.ops.cuda import build

    tool = str(Path(build.nvcc_path()).with_name("cuobjdump"))
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = [0, 0, 0]
        elif name and "HGMMA" in line:
            out[name][0] += 1
        elif name and "HMMA" in line:
            out[name][1] += 1
        elif name and re.search(r"\b(LDL|STL)\b", line):
            out[name][2] += 1
    return {k: tuple(v) for k, v in out.items()}


def time_forward(torch, lib, old, name: str, repeats: int, card: str,
                 tag: str = "") -> None:
    """Print the save forward's (``name`` a shape of SHAPES) or the merged
    forward's (``name`` "merged") time by call and by grid, against
    ``old`` = (library, wrapper module) of another source; ``tag`` follows
    the label."""
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    if name == "merged":
        args = head_inputs(torch)
        label, outs = "stack_head_fwd breakdancing C=64", (
            "loss", "match", "skip", "hsave", "tfsg")
        st = ks._stream(args[0])
        sides = {"this": lambda: ks.run_head_fwd(lib, *args, stream=st)}
        if old is not None:
            sides["parent"] = lambda: old[1].run_head_fwd(old[0], *args,
                                                          stream=st)
    else:
        args = fwd_inputs(torch, name)[0]
        label, outs = f"stack_fwd {name}", ("skip", "hsave", "tfsg")
        st = ks._stream(args[0])
        sides = {"this": lambda: ks.run_fwd(lib, *args, st)}
        if old is not None:
            sides["parent"] = lambda: old[1].run_fwd(old[0], *args, st)
    order = ("parent", "this", "this", "parent") if old is not None \
        else ("this",)
    ms = {}
    for side in order:
        ms.setdefault(side, []).append(events_ms(torch, sides[side],
                                                 repeats))
    line = f"{label}{tag}: " + "; ".join(
        f"{side} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
        for side, vals in ms.items())
    if old is not None:
        new, prev = sides["this"](), sides["parent"]()
        if name == "merged":
            rel = abs(float(new[0]) - float(prev[0])) / abs(float(prev[0]))
            line += (f"; loss relative difference {rel:.3g}, match "
                     f"{float(new[1]):.0f} vs {float(prev[1]):.0f}")
            new, prev, outs = new[2:], prev[2:], outs[2:]
        line += "; " + diff_text(outs, new, prev) + "; bit-equal share " \
            + ", ".join(f"{n} {float((u == v).float().mean()):.4f}"
                        for n, u, v in zip(outs, new, prev))
    for side, fn in sides.items():
        grids = by_grid(torch, fn, FWD_GRIDS)
        line += f"; by grid ({side}) " + ", ".join(
            f"{k} {v:.3f}" for k, v in grids.items() if v > 0) \
            + f" (device {sum(grids.values()):.3f} ms)"
    print(f"{line}; {card}", flush=True)


def diff_text(names, new, old) -> str:
    """Each output's largest difference over its scale (None skipped)."""
    diff = []
    for label, x, y in zip(names, new, old):
        if x is None:
            continue
        err = float((x.float() - y.float()).abs().max())
        diff.append(f"{label} {err / float(y.float().abs().max()):.2e}")
    return "difference over scale: " + ", ".join(diff)


def events_ms(torch, fn, repeats: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def by_grid(torch, fn, grids=GRIDS) -> dict:
    """Device ms of one call of ``fn`` (after a warm call) by grid:
    ``grids`` ((label, kernel name part) pairs), the rest under
    "other"."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k, _ in grids}
    out["other"] = 0.0
    for e in prof.key_averages():
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.device_time_total <= 0):
            continue
        name = re.sub(r"\s+", "", e.key)
        group = next((k for k, pat in grids if re.search(pat, name)),
                     "other")
        out[group] += e.device_time_total / 1e3
    return out


def main(argv=None) -> None:
    import torch

    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--variants", nargs="?", const="", default=None,
                    help="time the diagnostic builds too (all, or those "
                    "named, comma-separated)")
    ap.add_argument("--recompute", action="store_true")
    ap.add_argument("--replay", action="store_true")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"),
                    default="bfloat16")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--forward", action="store_true")
    ap.add_argument("--gated", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_stack_bwd needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    names = args.variants.split(",") if args.variants else None
    if args.gated:
        old = parent_gated_kernels(args.parent) if args.parent else None
        variants = gated_variant_kernels(names) \
            if args.variants is not None else {}
        shapes = args.shapes if args.shapes != ",".join(SHAPES) \
            else ",".join(GATED_SHAPES)
        for name in shapes.split(","):
            time_gated(torch, old, name, args.repeats, card, variants)
        return
    lib = ks.library()
    if args.sass:
        from movenet_tpu_torch.ops.cuda import build

        for kernel, (hg, hm, loc) in sass_counts(
                build.build(["stack_kernel"])["stack_kernel"]).items():
            if re.search(r"stack_(layer_wg_f32|bwd_wg|wgrad_wg)_kernel",
                         kernel):
                print(f"sass {kernel}: {hg} HGMMA, {hm} HMMA, {loc} "
                      "local-memory instructions", flush=True)
    old = parent_kernels(args.parent) if args.parent else None
    if args.recompute or args.replay:
        variants = variant_kernels(RECOMPUTE_VARIANTS, names) \
            if args.variants is not None else {}
        default = WIDE_RECOMPUTE_SHAPES if args.replay else RECOMPUTE_SHAPES
        shapes = args.shapes if args.shapes != ",".join(SHAPES) \
            else ",".join(default)
        for name in shapes.split(","):
            time_recompute(torch, lib, old, name, args.repeats, card,
                           getattr(torch, args.dtype), variants, args.replay)
        return
    if args.forward:
        variants = variant_kernels(FWD_VARIANTS, names) \
            if args.variants is not None else {}
        shapes = args.shapes if args.shapes != ",".join(SHAPES) \
            else ",".join(SHAPES) + ",merged"
        for name in shapes.split(","):
            time_forward(torch, lib, old, name, args.repeats, card)
            for vname, vlib in variants.items():
                time_forward(torch, vlib, None, name, args.repeats, card,
                             f" variant {vname}")
        return
    variants = variant_kernels(VARIANTS, names) \
        if args.variants is not None else {}
    for name in args.shapes.split(","):
        bargs = inputs(torch, name)
        st = ks._stream(bargs[1])

        def new():
            return ks.run_bwd(lib, *bargs, stream=st)

        line = f"stack_bwd {name}: "
        if old is None:
            line += f"{events_ms(torch, new, args.repeats):.3f} ms"
        else:
            def parent():
                return old[1].run_bwd(old[0], *bargs, stream=st)

            p1 = events_ms(torch, parent, args.repeats)
            n1 = events_ms(torch, new, args.repeats)
            n2 = events_ms(torch, new, args.repeats)
            p2 = events_ms(torch, parent, args.repeats)
            got, want = new(), parent()
            equal = all((u is None and v is None) or torch.equal(u, v)
                        for u, v in zip(got, want))
            line += (f"this {n1:.3f}, {n2:.3f} ms; parent {p1:.3f}, "
                     f"{p2:.3f} ms; bit-equal to the parent: {equal}; "
                     + diff_text(("dtab", "dxc", "db_fg", "dw_fg", "dw_out",
                                  "db_out", "dwup_aug"), got, want))
        print(f"{line}; {grid_text(torch, new)}; {card}", flush=True)
        for vname, vlib in variants.items():
            def variant():
                return ks.run_bwd(vlib, *bargs, stream=st)

            print(f"stack_bwd {name} variant {vname}: "
                  f"{events_ms(torch, variant, args.repeats):.3f} ms; "
                  f"{grid_text(torch, variant)}; {card}", flush=True)
        del bargs
    if old is not None:
        time_merged_bwd(torch, lib, old, args.repeats, card)


def grid_text(torch, fn) -> str:
    grids = by_grid(torch, fn)
    return "by grid " + ", ".join(
        f"{k} {v:.3f}" for k, v in grids.items() if v > 0) \
        + f" (device {sum(grids.values()):.3f} ms)"


if __name__ == "__main__":
    main()
