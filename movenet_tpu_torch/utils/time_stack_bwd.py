"""Device time of the save-strategy trunk backward (``stack_bwd``), by
call and by grid, at the training shapes, optionally against another
copy of the kernel source on the same card; with ``--recompute``, of the
recompute strategy's forward and backward (``stack_fwd_tails``,
``stack_bwd_tails``) instead.

    python -m movenet_tpu_torch.utils.time_stack_bwd [--parent DIR]
        [--shapes breakdancing,exp03,exp04] [--repeats 5]
    python -m movenet_tpu_torch.utils.time_stack_bwd --recompute
        [--parent DIR] [--shapes exp02,flagship] [--repeats 5]

Shapes (T = 160,000, bf16, video as the stride-10 projection triple,
seeded random codes, table, triple, weights and dskip):
breakdancing (B=2, dilations (1,2,4) x 3, R=S=64, V=64), exp03 (B=3,
(1,2,1,2), R=32, S=8, V=128), exp04 (B=2, 1..8192, R=16, S=8, V=128).
hsave and tfsg come from the kernel forward.  Each call is timed by CUDA
events (mean of ``--repeats`` after a warm call), and once under
``torch.profiler`` by grid.  With ``--parent DIR`` (a checkout of another
commit, e.g. ``git archive`` unpacked under ``build/``), that copy's
``csrc/stack_kernel.cu`` is compiled with the same nvcc flags and bound
by its own ``ops/cuda/stack_kernel.py``; the two are timed in turns
(parent, this, this, parent) and their gradients compared (max
difference over each gradient's scale).  With ``--variants``, two
diagnostic builds of this checkout's source are timed beside it by grid:
``no_mma`` (the tensor-core products left out: the loads, stores and
epilogues alone) and ``one_pass`` (big*big only, no split passes); their
gradients are wrong by design and are not compared.

``--recompute`` shapes (T = 160,000, bf16, seeded random x, weights and
dskip): exp02 (experiment 02 through the CLI: B=2, dilations (1,2,4) x
3, R=64, S=8, flat ctx) and flagship (B=2, dilations 1..512 x 3, R=S=64,
no ctx).  Each side's backward takes its own forward's saved tensors
(the parent's layout may differ); the outputs are compared as above.  A
parent that raises at a shape is reported and not timed.  Prints the
card's name and power limit.  Needs a CUDA device and nvcc.
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
RECOMPUTE_SHAPES = {"exp02": (2, 64, 8, (1, 2, 4) * 3, True),
                    "flagship": (2, 64, 64, tuple(2 ** i for i in range(10))
                                 * 3, False)}
T = 160_000
# the grids of the save backward (and the merged backward's head
# launch, and the recompute strategy's layer-forward and W_out launches),
# by the kernel name each launch carries
GRIDS = (("layer", "stack_bwd_layer_kernel"),
         ("wgrad W_fg", "stack_wgrad_kernel<0"),
         ("wgrad W_out", "stack_wgrad_kernel<1"),
         ("wgrad W_up", "stack_wgrad_kernel<2"),
         ("wgrad W_out (gated)", "stack_wgrad_kernel<3"),
         ("layer forward", "stack_tails_layer_kernel"),
         ("reductions", "reduce_kernel"),
         ("head", "stack_head_bwd_kernel"))


# diagnostic edits of csrc/stack_kernel.cu: (text, replacement)
VARIANTS = {
    "no_mma": ('  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "',
               '  if (0) asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32'
               '.f32 "'),
    "one_pass": ("  if (SPLIT_A) mma_tf32(d, a.small, b.big);\n"
                 "  mma_tf32(d, a.big, b.small);\n", ""),
}


def compile_source(text: str, include: Path, tag: str,
                   name: str = "stack_kernel") -> Path:
    """``text`` (a ``<name>.cu``, including headers from ``include``)
    compiled with the build's nvcc flags into
    ``build/movenet_tpu_torch/<tag>/``, named by its hash."""
    from movenet_tpu_torch.ops.cuda import build

    h = hashlib.sha256(text.encode())
    for header in sorted(include.glob("*.cuh")):
        h.update(header.read_bytes())
    out = build.build_dir() / tag / f"{name}-{h.hexdigest()[:16]}.so"
    if not out.is_file():
        out.parent.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        src.write_text(text)
        subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                        str(include), "-o", str(out), str(src)], check=True,
                       capture_output=True)
    return out


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


def variant_kernels(name: str):
    """The bound library of this checkout's source with VARIANTS[name]."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    text = (build.CSRC / "stack_kernel.cu").read_text()
    old, new = VARIANTS[name]
    if text.count(old) != 1:
        raise RuntimeError(f"variant {name}: its edit does not apply")
    return ks.bind(ctypes.CDLL(str(compile_source(
        text.replace(old, new), build.CSRC, "variants"))))


def inputs(torch, name: str, seed: int = 0):
    """The backward's arguments (hsave, tfsg, ctx, w_fg, w_out, dskip,
    pack, vocab, dilations, proj) at shape ``name``."""
    from movenet_tpu_torch.ops import stack_kernel as sk
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    b, r, s, dil, v = SHAPES[name]
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
        _, hsave, tfsg = ks.run_fwd(
            ks.library(), pack, rn(2 * v, r, scale=0.5).to(bf), ctx,
            rn(n * b, 2 * r, scale=0.1), w_fg, w_out, rn(n, r + s,
                                                         scale=0.1),
            dil, b, ks._stream(pack))
    dskip = rn(b, T, s, scale=1e-3).to(bf)
    return (hsave, tfsg, ctx, w_fg, w_out, dskip, pack, v, dil,
            sk._ctx_proj_args(trip))


def recompute_inputs(torch, name: str, seed: int = 0):
    """(forward args (x, ctx, b_fg, w_fg, w_out, b_out, dilations), dskip)
    of the recompute kernels at shape ``name``."""
    b, r, s, dil, has_ctx = RECOMPUTE_SHAPES[name]
    n, bf = len(dil), torch.bfloat16
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device="cuda") * scale

    win = (3 if has_ctx else 2) * r
    fargs = (rn(b, T, r, scale=0.5).to(bf),
             rn(b, T, r, scale=0.5).to(bf) if has_ctx else None,
             rn(n * b, 2 * r, scale=0.1), rn(n, win, 2 * r, scale=win ** -0.5),
             rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), dil)
    return fargs, rn(b, T, s, scale=1e-3).to(bf)


def time_recompute(torch, lib, old, name: str, repeats: int,
                   card: str) -> None:
    """Print the recompute forward's and backward's times at ``name``
    (against ``old`` = (library, wrapper module) of another source)."""
    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    fargs, dskip = recompute_inputs(torch, name)
    st = ks._stream(fargs[0])
    sides = {"this": (lib, ks)}
    if old is not None:
        try:
            old[1].run_fwd_tails(old[0], *fargs, stream=st)
            sides["parent"] = old
        except NotImplementedError as e:
            print(f"recompute {name}: the parent raises: {e}", flush=True)
    fns = {"fwd": {}, "bwd": {}}
    for side, (slib, smod) in sides.items():
        saved = smod.run_fwd_tails(slib, *fargs, stream=st)[1]
        fns["fwd"][side] = (lambda slib=slib, smod=smod: smod.run_fwd_tails(
            slib, *fargs, stream=st))
        fns["bwd"][side] = (lambda slib=slib, smod=smod, saved=saved:
                            smod.run_bwd_tails(slib, fargs[0], saved,
                                               *fargs[1:-1], dskip,
                                               fargs[-1], stream=st))
    names = {"fwd": ("skip",),
             "bwd": ("dx", "dctx", "db_fg", "dw_fg", "dw_out", "db_out")}
    for kind, by_side in fns.items():
        order = ("parent", "this", "this", "parent") if len(by_side) > 1 \
            else ("this",)
        ms = {}
        for side in order:
            ms.setdefault(side, []).append(events_ms(torch, by_side[side],
                                                     repeats))
        line = f"stack_{kind}_tails {name}: " + "; ".join(
            f"{side} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
            for side, vals in ms.items())
        if len(by_side) > 1:
            line += "; " + diff_text(names[kind], by_side["this"](),
                                     by_side["parent"]())
        print(f"{line}; {grid_text(torch, by_side['this'])}; {card}",
              flush=True)


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
        group = next((k for k, pat in grids if pat in name), "other")
        out[group] += e.device_time_total / 1e3
    return out


def main(argv=None) -> None:
    import torch

    from movenet_tpu_torch.ops.cuda import stack_kernel as ks

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--recompute", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("time_stack_bwd needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    lib = ks.library()
    old = parent_kernels(args.parent) if args.parent else None
    if args.recompute:
        shapes = args.shapes if args.shapes != ",".join(SHAPES) \
            else ",".join(RECOMPUTE_SHAPES)
        for name in shapes.split(","):
            time_recompute(torch, lib, old, name, args.repeats, card)
        return
    variants = {n: variant_kernels(n) for n in VARIANTS} if args.variants \
        else {}
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
            line += (f"this {n1:.3f}, {n2:.3f} ms; parent {p1:.3f}, "
                     f"{p2:.3f} ms; " + diff_text(
                         ("dtab", "dxc", "db_fg", "dw_fg", "dw_out",
                          "db_out", "dwup_aug"), new(), parent()))
        print(f"{line}; {grid_text(torch, new)}; {card}", flush=True)
        for vname, vlib in variants.items():
            def variant():
                return ks.run_bwd(vlib, *bargs, stream=st)

            print(f"stack_bwd {name} variant {vname}: "
                  f"{events_ms(torch, variant, args.repeats):.3f} ms; "
                  f"{grid_text(torch, variant)}; {card}", flush=True)
        del bargs


def grid_text(torch, fn) -> str:
    grids = by_grid(torch, fn)
    return "by grid " + ", ".join(
        f"{k} {v:.3f}" for k, v in grids.items() if v > 0) \
        + f" (device {sum(grids.values()):.3f} ms)"


if __name__ == "__main__":
    main()
