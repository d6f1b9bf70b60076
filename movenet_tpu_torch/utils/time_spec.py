"""Device time of the AR kernel: the speculative form per iteration,
beside the standard form's step, or (``--standard``) the standard form
per step at B = 1, 8 and 32, optionally against another copy of the
kernel source on the same card; and the single-block stream rates that
the kernel's design rests on.

    python -m movenet_tpu_torch.utils.time_spec [--parent [DIR]]
        [--probe] [--variants] [--repeats 3] [--no-fixture]
    python -m movenet_tpu_torch.utils.time_spec --standard [--parent [DIR]]
    python -m movenet_tpu_torch.utils.time_spec --fetch-parent [DIR]

Cases: the four flagship cases of ``chip_smoke.py``'s phase 4 (layer 10 x
stack 3, C=256, R=S=64, RF=3072, seeded random weights with head2 x 10,
n = RF + 2048, B=1: greedy exact o3 d1, greedy fast o3 d1, greedy fast o2
d2, T=1.0 parity fast o3 d1 seed 3; the same seeded prompts) and the two
trained-fixture cases (``utils/fixtures.train_overfit`` trained on the
card, greedy fast o3 at depths 1 and 2).  A case's iterations are its
generated samples less its hits (each iteration emits one code and one
per committed guess), which ``utils/spec_sim.simulate_spec_hits`` also
replays from the codes; per-iteration time is kernel time over them.
The standard kernel (same form, same inputs) gives the step it is
compared with.  Times by CUDA events, mean of ``--repeats`` after a warm
call.

``--standard``: the four standard forms (exact, fast, and both with
video: seeded random frames at the flagship's 160) at the flagship width,
greedy, at B = 1, 8 and 32, n = RF + 2048, seeded prompts; per case the
kernel ms and us per step of each side, and the stream bound per step:
the packed stream's bytes over the single-block bulk-copy rate measured
in the same run (two 64 KB stages, as the kernel's ring).  No speculative
case runs.

``--parent DIR``: DIR holds another copy of ``ar_sampler.cu`` and its
wrapper ``ar_sampler.py`` (default ``build/ab``; where they are missing,
``git show HEAD:`` fills them in, which needs a git checkout: run
``--fetch-parent`` there before copying the tree to a machine without
one).  That copy is compiled with the build's nvcc flags and bound by
its own wrapper; the two are timed in turns (parent, this, this,
parent) in this one process, and their codes and hits must be bit-equal.
The AR kernel moves with nvcc's scheduling, so only such one-process
comparisons count.

``--probe``: how fast one block alone on the card moves the flagship's
weight stream (exact, and fast at depth 1) into its SM: bulk copies into
a ring of shared-memory stages, the same with the consumers reading
every float, and 256 threads with 16 grouped ``__ldg`` each
(``ops/cuda/ar_sampler.stream_probe``).

``--variants``: diagnostic builds of this checkout's source with one part
left out (VARIANTS), timed beside it (with ``--standard``, in each
standard case), and this source with other rings (RINGS: slab size and
stage count); the variants' codes are wrong by design, and their
per-iteration times use their own hit counts.

Prints the card's name and power limit.  Needs a CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from movenet_tpu_torch.utils.time_stack_bwd import (_load, compile_source,
                                                    events_ms)

ROOT = Path(__file__).resolve().parents[2]
FLAGSHIP = dict(layer_size=10, stack_size=3, input_channels=256,
                residual_channels=64, skip_channels=64)
N_GEN = 2048
# chip_smoke.py phase 4: (label, temperature, fast, order, depth, seed)
CASES = (("greedy exact o3 d1", 0.0, False, 3, 1, 0),
         ("greedy fast o3 d1", 0.0, True, 3, 1, 0),
         ("greedy fast o2 d2", 0.0, True, 2, 2, 0),
         ("T=1.0 parity fast o3 d1", 1.0, True, 3, 1, 3))
PARENT_FILES = {"ar_sampler.cu": "movenet_tpu_torch/csrc/ar_sampler.cu",
                "ar_sampler.py": "movenet_tpu_torch/ops/cuda/ar_sampler.py"}
# diagnostic edits of csrc/ar_sampler.cu: name -> ((text, replacement), ...)
VARIANTS = {
    # the producer copies nothing: consumers read whatever the stages hold
    "no_copy": (("""    mbar_expect_tx(full + stage, bytes);
    bulk_copy(ring + static_cast<size_t>(stage) * q.stage_bytes, src + off,
              bytes, full + stage);""", "    mbar_arrive(full + stage);"),),
    # no fmaf chains: each slab's weights are read and summed once
    "no_fma": (("quad_fma<NCH, LEAKY>(x, q + u, w[u], acc);",
                "acc[0] += w[u].x;"),
               ("quad_fma<NCH, LEAKY>(x, q, slab[q * sh.ncols], acc);",
                "acc[0] += slab[q * sh.ncols].x;")),
    # no gate functions: tanh (and sigmoid) left out
    "no_gate": (("CH(k, oG)[i] = __fmul_rn(tanhf(f), sigmoidf_(g));",
                 "CH(k, oG)[i] = __fmul_rn(f, g);"),
                ("const float v0 = tanhf(__fadd_rn(CH(k, oP0)[i], CH(k, oP1)[i]));",
                 "const float v0 = __fadd_rn(CH(k, oP0)[i], CH(k, oP1)[i]);"),
                ("""                tanhf(__fadd_rn(CH(k, oP0)[R + i], CH(k, oP1)[R + i]));""",
                 """                __fadd_rn(CH(k, oP0)[R + i], CH(k, oP1)[R + i]);""")),
    # every consumer thread arrives on `empty` (256 arrivals, no
    # __syncwarp) in place of one lane per warp after a __syncwarp
    "thread_release": (("""      mbar_init(empty + s, kWarps);
    }
    fence_mbar_init();
    misc[2] = 0;""", """      mbar_init(empty + s, kConsumers);
    }
    fence_mbar_init();
    misc[2] = 0;"""), ("""  __syncwarp();
  if ((threadIdx.x & 31) == 0) mbar_arrive(pp.empty + pp.stage);""",
                                       "  mbar_arrive(pp.empty + pp.stage);")),
}
# (no variant drops the named barriers: the consumer warps would then
# disagree on when the sampling ends, and the ring would wait forever
# for the releases of a warp that has stopped)
# (slab bytes, most stages) of the ring timed beside the default
# (--variants): the slab size apart from the ring's depth
RINGS = ((32768, 2), (32768, 32), (16384, 32))


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def fetch_parent(parent: Path) -> None:
    """Fill ``parent`` with the HEAD commit's kernel source and wrapper
    where they are missing."""
    parent.mkdir(parents=True, exist_ok=True)
    for name, path in PARENT_FILES.items():
        if not (parent / name).is_file():
            text = subprocess.run(["git", "show", f"HEAD:{path}"], cwd=ROOT,
                                  capture_output=True, text=True,
                                  check=True).stdout
            (parent / name).write_text(text)


def bind(mod, lib: ctypes.CDLL):
    """``mod`` (a copy of ``ops/cuda/ar_sampler.py``) launching through
    ``lib``.  A copy with ``bind_library`` declares its own C interface;
    an older one (one launch function per form) is declared here."""
    if hasattr(mod, "bind_library"):
        mod.bind_library(lib)
    else:
        lib.movenet_ar_sampler_launch.argtypes = mod._ARGTYPES
        lib.movenet_ar_sampler_launch.restype = ctypes.c_int
        lib.movenet_ar_sampler_spec_launch.argtypes = mod._SPEC_ARGTYPES
        lib.movenet_ar_sampler_spec_launch.restype = ctypes.c_int
        lib.movenet_cuda_error_string.argtypes = [ctypes.c_int]
        lib.movenet_cuda_error_string.restype = ctypes.c_char_p
    mod._kernel_lib = lambda: lib
    return mod


def parent_side(parent: Path):
    """The wrapper module of ``parent``'s copy, bound to its own build."""
    fetch_parent(parent)
    out = compile_source((parent / "ar_sampler.cu").read_text(), parent,
                         parent.name, "ar_sampler")
    mod = _load(f"{parent.name}_ar_sampler", parent / "ar_sampler.py")
    return bind(mod, ctypes.CDLL(str(out)))


def variant_sides():
    """{name: wrapper module bound to this checkout's source with that
    variant's edits}, compiled in parallel."""
    from movenet_tpu_torch.ops.cuda import build

    base = (build.CSRC / "ar_sampler.cu").read_text()
    wrapper = build.CSRC.parent / "ops" / "cuda" / "ar_sampler.py"

    def one(name):
        text = base
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: its edit does not apply")
            text = text.replace(old, new)
        lib = ctypes.CDLL(str(compile_source(text, build.CSRC, "variants",
                                             "ar_sampler")))
        return bind(_load(f"variant_{name}", wrapper), lib)

    if not VARIANTS:
        return {}
    with ThreadPoolExecutor(len(VARIANTS)) as ex:
        return dict(zip(VARIANTS, ex.map(one, VARIANTS)))


def ptxas_text(log: str, kernel: str = "ar_sampler_kernel") -> str:
    """ptxas' registers, spills and shared memory of each instantiation
    of ``kernel`` in an ``nvcc -Xptxas -v`` log."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            cur = m.group(1)
            continue
        if cur and kernel in cur and ("registers" in line or "spill" in line):
            out.append(f"{cur}: {line.split('info    :')[-1].strip()}")
    return "\n".join(out)


def flagship_model(torch):
    from movenet_tpu_torch.config import ModelConfig
    from movenet_tpu_torch.models.wavenet import make_wavenet

    model = make_wavenet(ModelConfig(**FLAGSHIP, compute_dtype="float32"),
                         generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model.head2.kernel.mul_(10.0)   # as chip_smoke.py's flagship
    return model.to("cuda").eval()


def cases(torch, np, fixture: bool):
    """[(label, prepared inputs, order, depth)] in chip_smoke's order."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars
    from movenet_tpu_torch.utils import fixtures

    model = flagship_model(torch)
    rf = model.receptive_fields
    rng = np.random.default_rng(2)
    out = []
    for label, temp, fast, order, depth, seed in CASES:
        prompt = rng.integers(0, model.input_channels, size=(1, rf))
        out.append((label, ars.prepare(
            model, prompt, rf + N_GEN, temperature=temp, seed=seed,
            parity_sampling=True, fast=fast, speculative=True,
            spec_order=order, spec_depth=depth), order, depth))
    if fixture:
        trained, codes = fixtures.train_overfit(
            fixtures.sine_wave(), device="cuda",
            generator=torch.Generator().manual_seed(0))
        frf = trained.receptive_fields
        for depth in (1, 2):
            out.append((f"trained fixture greedy fast o3 d{depth}",
                        ars.prepare(trained, codes[None, :frf],
                                    frf + N_GEN, fast=True,
                                    speculative=True, spec_depth=depth),
                        3, depth))
    return out


def time_case(torch, sides, variants, label, inp, order, depth, repeats,
              card) -> dict:
    """Print one case's times; returns {side: [ms, ...]} and counts."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars
    from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

    gen = inp.n_samples - inp.rf
    # a wrapper copy older than the standard form's ring caches its
    # speculative stream on the inputs as spec_stream
    inp.spec_stream = {}
    runs = {side: (lambda m=m: m.ar_sampler_spec(inp, order, depth))
            for side, m in sides.items()}
    got = {side: fn() for side, fn in runs.items()}
    torch.cuda.synchronize()
    codes, hits = got["this"]
    iters = gen - int(hits)
    replay, replay_iters = simulate_spec_hits(
        torch.cat([inp.prompt, codes], 1)[0].cpu().numpy(),
        inp.weights["front_cur"].shape[0], inp.rf, order, depth)
    if replay != int(hits) or replay_iters != iters:
        raise RuntimeError(f"{label}: hits {int(hits)} / iterations {iters} "
                           f"against the replay's {replay} / {replay_iters}")
    equal = all(torch.equal(c, codes) and int(h) == int(hits)
                for c, h in got.values())
    parents = [side for side in sides if side != "this"]
    ms = {}
    for side in parents + ["this", "this"] + parents[::-1]:
        ms.setdefault(side, []).append(events_ms(torch, runs[side], repeats))
    std_ms = events_ms(torch, lambda: ars.ar_sampler(inp), repeats)
    std_us = std_ms * 1e3 / gen
    parts = []
    for side, vals in ms.items():
        mean = sum(vals) / len(vals)
        parts.append(f"{side} " + ", ".join(f"{v:.3f}" for v in vals)
                     + f" ms ({mean * 1e3 / iters:.2f} us/iteration, "
                     f"{mean * 1e3 / iters / std_us:.2f}x the standard "
                     f"step; {mean * 1e3 / gen:.2f} us/sample)")
    for side in parents:
        speed = (sum(ms[side]) / len(ms[side])) / (
            sum(ms["this"]) / len(ms["this"]))
        parts.append(f"this is {speed:.3f}x faster than {side}")
    print(f"spec {label}: {iters} iterations ({int(hits)} hits of {gen} "
          f"samples); " + "; ".join(parts) + f"; standard kernel "
          f"{std_ms:.3f} ms ({std_us:.2f} us/step); codes and hits "
          f"{'bit-equal' if equal else 'DIFFER'} across sides; {card}",
          flush=True)
    runs = {name: (lambda m=m: m.ar_sampler_spec(inp, order, depth))
            for name, m in variants.items()}
    if variants:
        lib = ars._kernel_lib()
        c_in, r = inp.weights["front_cur"].shape
        s = inp.weights["w_out"].shape[2] - r
        for slab, most in RINGS:
            lay = ars.smem_layout(inp.fast, depth + 1, c_in, r, s,
                                  len(inp.dilations), False, slab, most)
            runs[f"ring {lay['n_stages']} x {lay['stage_bytes']}"] = (
                lambda slab=slab, most=most: ars.run_spec(
                    lib, inp, order, depth, None,
                    torch.cuda.current_stream().cuda_stream, slab, most))
    for vname, fn in runs.items():
        _, vhits = fn()
        vms = events_ms(torch, fn, repeats)
        viters = gen - int(vhits)
        print(f"variant {vname} {label}: {vms:.3f} ms, {viters} iterations "
              f"({vms * 1e3 / viters:.2f} us/iteration); {card}",
              flush=True)
    if not equal:
        raise RuntimeError(f"{label}: codes or hits differ across sides")
    return dict(ms=ms, iters=iters, std_us=std_us, gen=gen)


# --standard: (label, fast, video) of the forms, and the batch sizes
STANDARD_FORMS = (("exact", False, False), ("fast", True, False),
                  ("video exact", False, True), ("video fast", True, True))
STANDARD_BATCHES = (1, 8, 32)


def ring_rate(torch) -> float:
    """GB/s at which one block moves the flagship's fast stream into its
    SM by bulk copies into two 64 KB stages, the kernel's ring."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    dil = tuple([2 ** i for i in range(10)] * 3)
    nbytes = ars._stream_index(True, 1, dil, 64, 64, 256).numel() * 4
    lay = ars.smem_layout(True, 1, 256, 64, 64, len(dil))
    return ars.stream_probe(nbytes, "bulk copy", n_stages=lay["n_stages"],
                            slab_bytes=lay["stage_bytes"])


def standard_inputs(torch, np, model):
    """(label, prepared inputs) of each --standard case, in turn."""
    from movenet_tpu_torch.config import ModelConfig
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    rf = model.receptive_fields
    frames = ModelConfig(**FLAGSHIP).max_video_frames
    for batch in STANDARD_BATCHES:
        prompt = np.random.default_rng(batch).integers(
            0, model.input_channels, size=(batch, rf))
        gen = torch.Generator(device="cuda").manual_seed(batch)
        video = torch.rand(batch, frames, 64, 64, 1, generator=gen,
                           device="cuda") * 255.0
        for label, fast, with_video in STANDARD_FORMS:
            yield f"{label} B={batch}", ars.prepare(
                model, prompt, rf + N_GEN, fast=fast,
                video=video if with_video else None)


def time_standard(torch, sides, label, inp, repeats, rate, card) -> dict:
    """Print one standard case's times; the codes of every side must be
    bit-equal.  Returns {side: [ms, ...]}."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    gen = inp.n_samples - inp.rf
    runs = {side: (lambda m=m: m.ar_sampler(inp)) for side, m in sides.items()}
    got = {side: fn() for side, fn in runs.items()}
    torch.cuda.synchronize()
    equal = all(torch.equal(c, got["this"]) for c in got.values())
    parents = [side for side in sides if side != "this"]
    ms = {}
    for side in parents + ["this", "this"] + parents[::-1]:
        ms.setdefault(side, []).append(events_ms(torch, runs[side], repeats))
    nbytes = 4 * ars.pack_stream(inp, 1).numel()
    bound_us = nbytes / (rate * 1e3)
    parts = []
    for side, vals in ms.items():
        mean = sum(vals) / len(vals)
        parts.append(f"{side} " + ", ".join(f"{v:.3f}" for v in vals)
                     + f" ms ({mean * 1e3 / gen:.2f} us/step)")
    for side in parents:
        speed = (sum(ms[side]) / len(ms[side])) / (
            sum(ms["this"]) / len(ms["this"]))
        parts.append(f"this is {speed:.3f}x faster than {side}")
    print(f"standard {label} (n = RF + {gen}, greedy): " + "; ".join(parts)
          + f"; stream bound {bound_us:.2f} us/step ({nbytes} bytes / "
          f"{rate:.1f} GB/s); codes {'bit-equal' if equal else 'DIFFER'} "
          f"across sides; {card}", flush=True)
    if not equal:
        raise RuntimeError(f"standard {label}: codes differ across sides")
    return ms


def probe(torch, card) -> dict:
    """Single-block rates (GB/s) for the flagship's exact and fast
    (depth 1) streams."""
    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    dil = [2 ** i for i in range(10)] * 3
    rates = {}
    for fast in (False, True):
        nbytes = ars._stream_index(fast, 2, tuple(dil), 64, 64,
                                   256).numel() * 4
        for mode in ars.PROBE_MODES:
            # the ring's stages fill about 200 KB of shared memory
            for slab in ((4096, 8192, 16384, 32768) if mode != "grouped __ldg"
                         else (16384,)):
                stages = min(48, 204800 // slab)
                gbs = ars.stream_probe(nbytes, mode, n_stages=stages,
                                       slab_bytes=slab)
                rates[(fast, mode, slab)] = gbs
                print(f"probe {'fast' if fast else 'exact'} stream "
                      f"({nbytes} bytes): {mode}, {stages} stages of "
                      f"{slab} bytes: {gbs:.1f} GB/s ({nbytes / gbs / 1e3:.2f}"
                      f" us a pass); {card}", flush=True)
    return rates


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parent", type=Path, nargs="?", action="append",
                    const=ROOT / "build" / "ab", default=None)
    ap.add_argument("--fetch-parent", type=Path, nargs="?",
                    const=ROOT / "build" / "ab", default=None)
    ap.add_argument("--probe", action="store_true")
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--no-fixture", action="store_true")
    ap.add_argument("--standard", action="store_true")
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args(argv)
    if args.fetch_parent:
        fetch_parent(args.fetch_parent)
        print(f"parent source in {args.fetch_parent}")
        return
    import numpy as np
    import torch

    from movenet_tpu_torch.ops.cuda import ar_sampler as ars

    if not torch.cuda.is_available():
        raise SystemExit("time_spec needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = card_line()
    print(f"card: {card}", flush=True)
    if args.probe:
        probe(torch, card)
    from movenet_tpu_torch.ops.cuda import build

    ars._kernel_lib()
    print(ptxas_text(build.build_logs.get("ar_sampler", "")), flush=True)
    sides = {"this": ars}
    for parent in args.parent or ():
        sides[parent.name] = parent_side(parent)
    if args.standard:
        rate = ring_rate(torch)
        print(f"single-block bulk-copy rate into two 64 KB stages: "
              f"{rate:.1f} GB/s; {card}", flush=True)
        model = flagship_model(torch)
        variants = variant_sides() if args.variants else {}
        for label, inp in standard_inputs(torch, np, model):
            with torch.no_grad():
                time_standard(torch, sides, label, inp, args.repeats, rate,
                              card)
                gen = inp.n_samples - inp.rf
                for vname, m in variants.items():
                    vms = events_ms(torch, lambda m=m: m.ar_sampler(inp),
                                    args.repeats)
                    print(f"variant {vname} standard {label}: {vms:.3f} ms "
                          f"({vms * 1e3 / gen:.2f} us/step); {card}",
                          flush=True)
        return
    variants = variant_sides() if args.variants else {}
    for label, inp, order, depth in cases(torch, np, not args.no_fixture):
        with torch.no_grad():
            time_case(torch, sides, variants, label, inp, order, depth,
                      args.repeats, card)


if __name__ == "__main__":
    main()
