"""Device time of the head/CE kernels (``head_fwd``, ``head_bwd``; with
``--packed`` ``head_fwd_packed``, ``head_bwd_packed``) at the training
shapes, optionally against another copy of the kernel source on the same
card.

    python -m movenet_tpu_torch.utils.time_head [--parent DIR]
        [--shapes 64,64,2,8,128,3,...] [--repeats 5] [--variants]
    python -m movenet_tpu_torch.utils.time_head --packed [--parent DIR]
        [--repeats 5] [--variants]
    python -m movenet_tpu_torch.utils.time_head --sass

Shapes (S, C, B), T = 160,000, bf16, parity CE, targets in the codes
pack (seeded random skip, codes and weights, as ``chip_smoke.py``'s wide
head phase makes them): the breakdancing head (64, 64, 2), experiment
03's (8, 128, 3), experiment 04's (8, 128, 2), (16, 256, 2) and the
flagship's (64, 256, 2).  Each call is timed by CUDA events (mean of
``--repeats`` after a warm call), and once under ``torch.profiler`` by
grid.  With ``--parent DIR`` (a checkout of another commit, e.g. ``git
archive`` unpacked under ``build/``), that copy's ``csrc/head_loss.cu``
is compiled with the same nvcc flags and bound by its own
``ops/cuda/head_loss.py``; the two are timed in turns (parent, this,
this, parent), and each output's largest difference over its scale is
printed (the backward of each side takes the forward's p of this
checkout).  With ``--variants``, diagnostic builds of this checkout's
source, each with one part of the kernels left out (VARIANTS), are
timed beside it; their outputs are wrong by design and are not compared.
``--packed`` times the packed kernels instead, at the breakdancing head
(S = C = 64, B = 2, T = 160,000; targets exactly B wide), parity CE and
clean, in the same turns against ``--parent`` with each output's
difference over its scale, beside this checkout's unpacked pair on the
same inputs; it prints each side's registers, spills and dynamic shared
memory a block of the two packed kernels, and with ``--variants`` times
PACKED_VARIANTS (parts of the packed kernels left out or changed).
``--sass`` prints, for each kernel of the built library, its SASS
instruction count and the count of each kind that shows where its work
runs (HMMA: tensor cores; FFMA: float32 fused multiply-adds; LDS, STS,
LDG, STG: shared and global memory; LDL, STL: spills; SHFL; MUFU: exp
and log), from ``cuobjdump -sass``.
Prints the card's name and power limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from movenet_tpu_torch.utils.time_stack_bwd import (_load, by_grid,
                                                    compile_source,
                                                    diff_text, events_ms)

SHAPES = ((64, 64, 2), (8, 128, 3), (8, 128, 2), (16, 256, 2),
          (64, 256, 2))
T, RF = 160_000, 24
# diagnostic edits of csrc/head_loss.cu: name -> ((text, replacement), ...)
VARIANTS = {
    "no_y": (("y_seq(rows, w1t_cols, S, y);",
              "y_seq(rows, w1t_cols, 0, y);"),),
    "no_z_mma": (("          mma_bf16(z[j], af, b);", ""),),
    "no_p_store": (("    if (a.p_out) {", "    if (false) {"),),
    "fast_exp": (("expf(", "__expf("),),
    "no_dy_mma": (("              mma_bf16_add(dy[j], dza[kk], b);", ""),),
    "no_colsums": (("    colsum_add<NT>(d, nt, cs2);", ""),
                   ("      colsum_add<8>(dy, nt - 8 * ch, cs1 + 64 * ch);",
                    "")),
    "bwd_one_block": (("__launch_bounds__(kThreads, NT > 16 || KS > 4 ? 1 : 2)"
                       "\n    head_bwd_kernel",
                       "__launch_bounds__(kThreads, 1)\n    head_bwd_kernel"),),
    "no_scratch_stores": (("store_a(a.ly,", "if (0) store_a(a.ly,"),
                          ("store_a(a.dzr,", "if (0) store_a(a.dzr,"),
                          ("store_a(a.dyr,", "if (0) store_a(a.dyr,")),
}
# diagnostic edits of the packed kernels, as VARIANTS
PACKED_VARIANTS = {
    "no_mma": (("  if (SA) mma_tf32(d, a.small, b.big);\n"
                "  if (SB) mma_tf32(d, a.big, b.small);\n"
                "  mma_tf32(d, a.big, b.big);\n", ""),),
    "one_pass": tuple((f"constexpr Passes kPass{n} = {{true, true}};",
                       f"constexpr Passes kPass{n} = {{false, false}};")
                      for n in ("Y", "Z", "Dy", "Dskip", "Dw2", "Dw1")),
    "no_ties": (("constexpr float kTieMargin = 1.f / 16384.f;",
                 "constexpr float kTieMargin = -1.f;"),),
    "all_ties": (("constexpr float kTieMargin = 1.f / 16384.f;",
                  "constexpr float kTieMargin = 1e30f;"),),
    "no_wgrad": (("for (int k0 = 0; k0 < kBwdRows; k0 += 8) {",
                  "for (int k0 = 0; k0 < 0; k0 += 8) {"),),
}
PACKED_GRIDS = (("forward", "head_fwd_packed_kernel"),
                ("backward", "head_bwd_packed_kernel"),
                ("reductions", "reduce_kernel"))
GRIDS = (("forward", "head_fwd_kernel"), ("backward rows",
                                          "head_bwd_kernel"),
         ("weight gradients", "head_wgrad_kernel"),
         ("reductions", "reduce_kernel"))


def parent_kernels(parent: Path):
    """(bound library, wrapper module) of ``parent``'s head kernels."""
    pkg = parent / "movenet_tpu_torch"
    csrc = pkg / "csrc"
    out = compile_source((csrc / "head_loss.cu").read_text(), csrc,
                         "parent", "head_loss")
    mod = _load("parent_head_loss", pkg / "ops" / "cuda" / "head_loss.py")
    return mod.bind(ctypes.CDLL(str(out))), mod


SASS_KINDS = ("HMMA", "FFMA", "LDSM", "STSM", "LDS", "STS", "LDG", "STG",
              "LDL", "STL", "SHFL", "MUFU", "BAR")


def sass_report() -> None:
    """Print each kernel's SASS instruction count and SASS_KINDS counts."""
    import re
    from movenet_tpu_torch.ops.cuda import build

    lib = build.build(["head_loss"])["head_loss"]
    cuobjdump = Path(build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                         block)
        counts = {k: sum(1 for o in ops if o == k) for k in SASS_KINDS}
        print(f"sass {name}: {len(ops)} instructions; " + ", ".join(
            f"{k} {v}" for k, v in counts.items() if v), flush=True)


def variant_kernels(table=VARIANTS):
    """{name: bound library} of this checkout's source with each variant
    of ``table`` (VARIANTS or PACKED_VARIANTS), compiled in parallel."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.ops.cuda import head_loss as kh

    base = (build.CSRC / "head_loss.cu").read_text()

    def one(name):
        text = base
        for old, new in table[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: its edit does not apply")
            text = text.replace(old, new)
        return kh.bind(ctypes.CDLL(str(compile_source(
            text, build.CSRC, "variants", "head_loss"))))

    with ThreadPoolExecutor(len(table)) as ex:
        return dict(zip(table, ex.map(one, table)))


def packed_resources(log: Path, lib) -> str:
    """ptxas' registers and spills of the two packed kernels from an nvcc
    log, and their dynamic shared memory a block where ``lib`` reports
    it."""
    text = log.read_text() if log.is_file() else ""
    out = []
    for bwd, kernel in enumerate(("head_fwd_packed_kernel",
                                  "head_bwd_packed_kernel")):
        m = re.search(r"Compiling entry function '\S*" + kernel
                      + r"\S*'(.*?)(?=Compiling entry function|\Z)", text,
                      re.S)
        info = "; ".join(
            line.split("info    :")[-1].strip()
            for line in m.group(1).splitlines()
            if "registers" in line or "spill" in line) if m else \
            "not in the nvcc log"
        try:
            fn = lib.movenet_head_packed_smem
        except AttributeError:
            smem = "dynamic shared memory not reported by this source"
        else:
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_long
            smem = f"{fn(bwd)} bytes of dynamic shared memory a block"
        out.append(f"{kernel}: {info}; {smem}")
    return "; ".join(out)


def inputs(torch, s: int, c: int, b: int):
    """The forward's arguments at (S, C, B), as chip_smoke's wide head
    phase makes them."""
    g = torch.Generator(device="cuda").manual_seed(s * c + b)
    codes = torch.randint(0, c, (b, T), generator=g, device="cuda",
                          dtype=torch.int32)
    prev = torch.cat([torch.full_like(codes[:, :1], -1), codes[:, :-1]], 1)
    pack = torch.cat([codes, prev, torch.roll(codes, -1, 1)],
                     0).t().contiguous()
    skip = torch.randn(b, T, s, generator=g, device="cuda").to(
        torch.bfloat16)
    w1 = torch.randn(s, c, generator=g, device="cuda") / 4
    b1 = torch.randn(c, generator=g, device="cuda") * 0.1
    w2 = torch.randn(c, c, generator=g, device="cuda") * (2.5 / c ** 0.5)
    b2 = torch.randn(c, generator=g, device="cuda") * 0.1
    return (skip, pack, w1, b1, w2, b2, RF, True, 2 * b)


def grid_text(torch, fn) -> str:
    grids = by_grid(torch, fn, GRIDS)
    return "by grid " + ", ".join(
        f"{k} {v:.3f}" for k, v in grids.items() if v > 0) \
        + f" (device {sum(grids.values()):.3f} ms)"


def time_shape(torch, sides, s, c, b, repeats, card, variants) -> None:
    """Print head_fwd's and head_bwd's times at (S, C, B) for each side
    ((library, wrapper module) by name), and of each variant library."""
    from movenet_tpu_torch.ops.cuda import head_loss as kh

    fargs = inputs(torch, s, c, b)
    st = kh._stream(fargs[0])
    p = kh.run_fwd(sides["this"][0], *fargs, stream=st)[2]
    dloss = torch.tensor(1.0 / (b * (T - RF)), device="cuda")
    bargs = fargs[:2] + (p,) + fargs[2:-1] + (dloss, fargs[-1])
    fns = {"head_fwd": {}, "head_bwd": {}}
    for side, (slib, smod) in sides.items():
        fns["head_fwd"][side] = (lambda slib=slib, smod=smod: smod.run_fwd(
            slib, *fargs, stream=st))
        fns["head_bwd"][side] = (lambda slib=slib, smod=smod: smod.run_bwd(
            slib, *bargs, stream=st))
    names = {"head_fwd": ("loss", "match", "p"),
             "head_bwd": ("dskip", "dw1", "db1", "dw2", "db2")}
    for kind, by_side in fns.items():
        order = ("parent", "this", "this", "parent") if len(by_side) > 1 \
            else ("this",)
        ms = {}
        for side in order:
            ms.setdefault(side, []).append(events_ms(torch, by_side[side],
                                                     repeats))
        line = f"{kind} S={s} C={c} B={b}: " + "; ".join(
            f"{side} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
            for side, vals in ms.items())
        if len(by_side) > 1:
            line += "; " + diff_text(names[kind], by_side["this"](),
                                     by_side["parent"]())
        print(f"{line}; {grid_text(torch, by_side['this'])}; {card}",
              flush=True)
    for vname, vlib in variants.items():
        fwd = events_ms(torch, lambda: kh.run_fwd(vlib, *fargs, stream=st),
                        repeats)
        bwd = events_ms(torch, lambda: kh.run_bwd(vlib, *bargs, stream=st),
                        repeats)
        print(f"variant {vname} S={s} C={c} B={b}: head_fwd {fwd:.3f} ms, "
              f"head_bwd {bwd:.3f} ms; {card}", flush=True)
    del p, bargs, fns


def time_packed(torch, parent, repeats, card, variants) -> None:
    """Print head_fwd_packed's and head_bwd_packed's times at the
    breakdancing head, parity CE and clean, against ``parent``'s source
    in turns when given; each side's registers and shared memory; this
    checkout's unpacked pair on the same inputs; and PACKED_VARIANTS."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.ops.cuda import head_loss as kh

    this = compile_source((build.CSRC / "head_loss.cu").read_text(),
                          build.CSRC, "this", "head_loss")
    sides = {"this": (kh.bind(ctypes.CDLL(str(this))), kh)}
    logs = {"this": this.with_suffix(".log")}
    if parent:
        pkg = parent / "movenet_tpu_torch"
        sides["parent"] = parent_kernels(parent)
        logs["parent"] = compile_source(
            (pkg / "csrc" / "head_loss.cu").read_text(), pkg / "csrc",
            "parent", "head_loss").with_suffix(".log")
    for side, (slib, _) in sides.items():
        print(f"packed {side}: {packed_resources(logs[side], slib)}",
              flush=True)
    vlibs = variant_kernels(PACKED_VARIANTS) if variants else {}
    s, c, b = 64, 64, 2
    skip, pack, w1, b1, w2, b2 = inputs(torch, s, c, b)[:6]
    tgt = pack[:, 2 * b:].contiguous()
    st = kh._stream(skip)
    dloss = torch.tensor(1.0 / (b * (T - RF)), device="cuda")
    w = (w1, b1, w2, b2)
    shape = f"S={s} C={c} B={b} T={T}"
    for parity in (True, False):
        fns = {"head_fwd_packed": {}, "head_bwd_packed": {}}
        for side, (slib, smod) in sides.items():
            fns["head_fwd_packed"][side] = (
                lambda slib=slib, smod=smod: smod.run_fwd(
                    slib, skip, tgt, *w, RF, parity, 0, False, st,
                    packed=True))
            fns["head_bwd_packed"][side] = (
                lambda slib=slib, smod=smod: smod.run_bwd(
                    slib, skip, tgt, None, *w, RF, parity, dloss, 0, st))
        names = {"head_fwd_packed": ("loss", "match", "p"),
                 "head_bwd_packed": ("dskip", "dw1", "db1", "dw2", "db2")}
        for kind, by_side in fns.items():
            order = ("parent", "this", "this", "parent") \
                if len(by_side) > 1 else ("this",)
            ms = {}
            for side in order:
                ms.setdefault(side, []).append(
                    events_ms(torch, by_side[side], repeats))
            line = f"{kind} parity={parity} {shape}: " + "; ".join(
                f"{side} " + ", ".join(f"{v:.3f}" for v in vals) + " ms"
                for side, vals in ms.items())
            if len(by_side) > 1:
                line += "; " + diff_text(names[kind], by_side["this"](),
                                         by_side["parent"]())
            grids = by_grid(torch, by_side["this"], PACKED_GRIDS)
            line += "; by grid " + ", ".join(
                f"{k} {v:.3f}" for k, v in grids.items() if v > 0)
            print(f"{line}; {card}", flush=True)
        for vname, vlib in vlibs.items():
            fwd = events_ms(torch, lambda: kh.run_fwd(
                vlib, skip, tgt, *w, RF, parity, 0, False, st, packed=True),
                repeats)
            bwd = events_ms(torch, lambda: kh.run_bwd(
                vlib, skip, tgt, None, *w, RF, parity, dloss, 0, st),
                repeats)
            print(f"variant {vname} parity={parity} {shape}: "
                  f"head_fwd_packed {fwd:.3f} ms, head_bwd_packed "
                  f"{bwd:.3f} ms; {card}", flush=True)
    # the unpacked pair on the same inputs (targets from column 0)
    lib = sides["this"][0]
    fwd = events_ms(torch, lambda: kh.run_fwd(lib, skip, tgt, *w, RF, True,
                                              0, True, st), repeats)
    p = kh.run_fwd(lib, skip, tgt, *w, RF, True, 0, True, st)[2]
    bwd = events_ms(torch, lambda: kh.run_bwd(lib, skip, tgt, p, *w, RF,
                                              True, dloss, 0, st), repeats)
    print(f"unpacked pair parity=True {shape}: head_fwd {fwd:.3f} ms, "
          f"head_bwd {bwd:.3f} ms, together {fwd + bwd:.3f} ms; {card}",
          flush=True)


def main(argv=None) -> None:
    import torch

    from movenet_tpu_torch.ops.cuda import head_loss as kh

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--shapes", default=",".join(
        ",".join(str(x) for x in sh) for sh in SHAPES))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--packed", action="store_true")
    args = ap.parse_args(argv)
    if args.sass:
        sass_report()
        return
    if not torch.cuda.is_available():
        raise SystemExit("time_head needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    if args.packed:
        time_packed(torch, args.parent, args.repeats, card, args.variants)
        return
    sides = {"this": (kh.library(), kh)}
    if args.parent:
        sides["parent"] = parent_kernels(args.parent)
    variants = variant_kernels() if args.variants else {}
    vals = [int(x) for x in args.shapes.split(",")]
    with torch.no_grad():
        for i in range(0, len(vals), 3):
            time_shape(torch, sides, *vals[i:i + 3], args.repeats, card,
                       variants)


if __name__ == "__main__":
    main()
