"""The AR sampler kernel's packed weight stream (ops/cuda/ar_sampler.py,
pack_stream), on the CPU, in the speculative form and the standard one
(audio and video, widths that are not multiples of 4): it holds every
weight the kernel reads, bit for bit, in the order of the kernel's
phases and in the layout its consumer threads read, each dot's segments
padded to a multiple of 4 rows with zeros; its slabs are 16-byte aligned
multiples of 16 bytes; the ring plus the chain buffers fit a block's
shared memory at the flagship width; and the Python layout agrees with
the kernel source's (csrc/ar_layout.cuh, built with g++)."""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from movenet_tpu_torch.config import ModelConfig
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops.cuda import ar_sampler as ars
from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

FLAGSHIP_DILATIONS = [2 ** i for i in range(10)] * 3


def _model(c=32, r=16, s=16, layer=3, stack=2, video=False):
    torch.set_num_threads(2)
    kw = dict(max_audio_frames=1000, max_video_frames=1) if video else {}
    cfg = ModelConfig(layer_size=layer, stack_size=stack, input_channels=c,
                      residual_channels=r, skip_channels=s, **kw)
    return make_wavenet(cfg, generator=torch.Generator().manual_seed(0)).eval()


def _columns(inp, kind, l):
    """{dot i: its weight column (rows in order)} of one phase, straight
    from the weight tensors."""
    w = inp.weights
    r = w["front_cur"].shape[1]
    r2 = 2 * r
    if kind == "P":      # W_ctx of every layer; fast layer 0: w_p0c[R:]
        return {i: (w["w_p0c"][r:, i % r2] if inp.fast and i < r2
                    else w["w_fg"][i // r2, r2:, i % r2])
                for i in range(len(inp.dilations) * r2)}
    if kind == "A":
        return {i: w["w_fg"][l, (i // r2) * r:(i // r2 + 1) * r, i % r2]
                for i in range(2 * r2)}
    if kind in ("C", "ML"):
        return {i: w["w_out"][l, :, i] for i in range(w["w_out"].shape[2])}
    if kind in ("H1", "H2"):
        m = w["h1_w" if kind == "H1" else "h2_w"]
        return {i: m[:, i] for i in range(m.shape[1])}
    if kind == "F0":
        return {i: w["w_p0c"][:r, i] for i in range(r2)}
    if kind == "M2":
        return {i: w["w_fg"][l + 1, :r2, i] for i in range(r2)}
    out = {i: w["w_prod"][l, :, i] for i in range(r2)}
    out.update({r2 + i: w["w_fg"][l + 1, :r2, i] for i in range(r2)})
    out.update({2 * r2 + i: w["w_out"][l, :, i]
                for i in range(w["w_out"].shape[2])})
    return out


def _decode(stream, inp, nch, slab_bytes):
    """Walk the stream phase by phase: check each dot's rows against its
    weight column (a dot of m segments: each segment's rows padded to a
    multiple of 4), each slab's size and offset, and that every float no
    dot owns is zero; returns the count of floats the dots own."""
    w = inp.weights
    c_in, r = w["front_cur"].shape
    s = w["w_out"].shape[2] - r
    n_layers = len(inp.dilations)
    flat = stream.numpy()
    owned = np.zeros(flat.size, bool)
    base = 0
    for kind, l in ars.stream_phases(inp.fast, nch, inp.dilations,
                                     inp.ctx is not None):
        sh = ars.phase_shape(kind, r, s, c_in, n_layers, slab_bytes)
        ks, ncols = sh["ks"], sh["ncols"]
        assert sh["slab_bytes"] == 4 * ks * ncols
        assert sh["slab_bytes"] % 16 == 0 and (4 * base) % 16 == 0
        assert sh["kv"] % ks == 0
        segs = {i: (seg, m) for a, b, seg, m
                in ars.phase_dots(kind, r, s, c_in, n_layers)
                for i in range(a, b)}
        start = {}                      # rows a thread has taken so far
        for i, col in sorted(_columns(inp, kind, l).items()):
            c = i % ars.CONSUMERS
            seg, m = segs[i]
            segp = -(-seg // 4) * 4
            assert col.numel() == seg * m
            v0 = start.get(c, 0)
            for k in range(col.numel()):
                v = v0 + (k // seg) * segp + k % seg
                pos = (base + (v // ks) * ks * ncols + ((v % ks) // 4) * 4
                       * ncols + 4 * c + v % 4)
                assert flat[pos].view(np.int32) == \
                    col[k].numpy().view(np.int32), (kind, l, i, k)
                owned[pos] = True
            start[c] = v0 + m * segp
        assert max(start.values()) == sh["kv"]
        base += sh["n_slabs"] * ks * ncols
    assert base == flat.size
    assert not flat[~owned].any()
    return int(owned.sum())


@pytest.mark.parametrize("slab_bytes", [ars.SLAB_BYTES, 2048])
@pytest.mark.parametrize("nch", [2, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_stream_holds_every_weight_in_phase_order(fast, nch, slab_bytes):
    model = _model()
    rf = model.receptive_fields
    inp = ars.prepare(model, np.zeros((1, rf), np.int64), rf + 4, fast=fast,
                      speculative=True, spec_depth=nch - 1)
    stream = ars.pack_stream(inp, nch, slab_bytes)
    assert stream.dtype == torch.float32 and stream.is_contiguous()
    if slab_bytes == ars.SLAB_BYTES:
        # prepare packed it once for the request's depth
        assert inp.streams[(nch, slab_bytes)] is stream
    n_owned = _decode(stream, inp, nch, slab_bytes)
    # every weight the form reads, counted from the tensors: the fast
    # form reads W_fg of the layers after the first, and again in M2
    w = inp.weights
    if fast:
        late = sum(1 for d in inp.dilations[1:] if d < nch)
        want = (w["w_fg"][1:].numel() + late * w["w_fg"][0].numel()
                + w["w_out"].numel() + w["w_prod"][:-1].numel()
                + w["w_p0c"].numel())
    else:
        want = w["w_fg"].numel() + w["w_out"].numel()
    want += w["h1_w"].numel() + w["h2_w"].numel()
    assert n_owned == want


@pytest.mark.parametrize("nch", [2, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_ring_and_chains_fit_shared_memory_at_flagship_width(fast, nch):
    lay = ars.smem_layout(fast, nch, 256, 64, 64, len(FLAGSHIP_DILATIONS))
    assert lay["total"] <= ars.SMEM_LIMIT == 232_448
    assert lay["stage_bytes"] == ars.SLAB_BYTES == 65536
    assert lay["n_stages"] == 2
    # the flagship's slabs: 64 KB, or 32 KB where a phase has 128 dots
    for kind, _ in ars.stream_phases(fast, nch, FLAGSHIP_DILATIONS):
        want = 32768 if kind in ("C", "ML", "F0", "M2") else 65536
        assert ars.phase_shape(kind, 64, 64, 256, 30)["slab_bytes"] == want
    nbytes = 4 * ars._stream_index(fast, nch, tuple(FLAGSHIP_DILATIONS), 64,
                                   64, 256).numel()
    # 3.3 MB exact; 4.3 (depth 1) and 4.5 MB (depth 2, M2 at 5 layers) fast
    want = {2: 4_325_376, 3: 4_521_984}[nch] if fast else 3_276_800
    assert nbytes == want


def test_layout_raises_above_the_shared_memory_of_a_block():
    with pytest.raises(ValueError, match="232,448"):
        ars.smem_layout(True, 3, 8192, 64, 64, 30)
    # the byte counts, in the standard form too (C=8192: 197,560 bytes
    # of chain buffers, biases and tables beside two 64 KB stages)
    with pytest.raises(ValueError, match=r"needs 328664 bytes .* 197560 "
                                         r"\+ two ring stages of 65552"):
        ars.smem_layout(False, 1, 8192, 64, 64, 30)
    # widths that are not multiples of 4 take the ring (padded segments)
    assert ars.smem_layout(False, 2, 30, 10, 6, 6)["n_stages"] >= 2


@pytest.mark.parametrize("order,depth", [(3, 1), (2, 2)])
def test_iterations_are_generated_samples_less_hits(order, depth):
    """time_spec's per-iteration time divides by generated - hits: each
    iteration emits one code plus one per committed guess, as the
    spec_sim replay counts."""
    model = _model()
    rf = model.receptive_fields
    with torch.no_grad():
        model.head2.kernel.mul_(10.0)
    prompt = np.random.default_rng(4).integers(0, 32, size=(1, rf))
    inp = ars.prepare(model, prompt, rf + 60, speculative=True,
                      spec_order=order, spec_depth=depth)
    codes, hits = ars.ar_sampler_spec_plain(inp)
    replay, iters = simulate_spec_hits(
        torch.cat([inp.prompt, codes], 1)[0].numpy(), 32, rf, order, depth)
    assert int(hits) == replay > 0
    assert iters == 60 - int(hits)


def test_time_spec_variant_edits_apply():
    """Each diagnostic edit of utils/time_spec.py matches the kernel
    source exactly once, so --variants builds what it says."""
    from movenet_tpu_torch.ops.cuda import build
    from movenet_tpu_torch.utils import time_spec

    src = (build.CSRC / "ar_sampler.cu").read_text()
    for name, edits in time_spec.VARIANTS.items():
        for old, _ in edits:
            assert src.count(old) == 1, name


def _standard_want(inp):
    """The floats of every weight the standard form reads."""
    w = inp.weights
    r = w["front_cur"].shape[1]
    if inp.fast:
        want = (w["w_fg"][1:, :2 * r].numel() + w["w_out"].numel()
                + w["w_prod"][:-1].numel() + w["w_p0c"][:r].numel())
    else:
        want = w["w_fg"][:, :2 * r].numel() + w["w_out"].numel()
    if inp.ctx is not None:         # W_ctx of every layer, in phase P
        want += len(inp.dilations) * r * 2 * r
    return want + w["h1_w"].numel() + w["h2_w"].numel()


@pytest.mark.parametrize("slab_bytes", [ars.SLAB_BYTES, 2048])
@pytest.mark.parametrize("widths", [(32, 16, 16), (30, 10, 6)],
                         ids=["C32R16S16", "C30R10S6"])
@pytest.mark.parametrize("video", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_standard_stream_holds_every_weight_in_phase_order(
        fast, video, widths, slab_bytes):
    """nch = 1: the standard form's stream, audio and video (phase P and
    the (L, 3R, 2R) W_fg), at widths that are and are not multiples of
    4; each padding row is zero and no dot owns it."""
    c, r, s = widths
    model = _model(c, r, s, video=video)
    rf = model.receptive_fields
    vid = torch.zeros(2, 1, 64, 64, 1) if video else None
    inp = ars.prepare(model, np.zeros((2, rf), np.int64), rf + 4, fast=fast,
                      video=vid)
    stream = ars.pack_stream(inp, 1, slab_bytes)
    if slab_bytes == ars.SLAB_BYTES:
        # prepare packed the standard stream once for the request
        assert inp.streams[(1, slab_bytes)] is stream
    assert _decode(stream, inp, 1, slab_bytes) == _standard_want(inp)
    assert [k for k, _ in ars.stream_phases(fast, 1, inp.dilations, video)
            ][:1] == (["P"] if video else ["A"] if not fast else ["F0"])


@pytest.mark.parametrize("video", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_standard_ring_fits_shared_memory_at_flagship_width(fast, video):
    """The flagship (also the widest C the repo configures: 256) in the
    standard form: two 64 KB stages beside the chain buffers, biases and,
    with video, the ctx row and per-step bias; the stream's bytes; phase
    P's 3,840 dots of 64 rows in 15 slabs of 64 KB."""
    lay = ars.smem_layout(fast, 1, 256, 64, 64, len(FLAGSHIP_DILATIONS),
                          video)
    assert lay["n_stages"] == 2 and lay["stage_bytes"] == 65536
    assert lay["fixed"] == (54_456 if video else 38_840)
    assert lay["total"] <= ars.SMEM_LIMIT
    nbytes = 4 * ars._stream_index(fast, 1, tuple(FLAGSHIP_DILATIONS), 64,
                                   64, 256, ars.SLAB_BYTES, video).numel()
    want = 4_194_304 if fast else 3_276_800
    assert nbytes == want + (983_040 if video else 0)
    sh = ars.phase_shape("P", 64, 64, 256, 30)
    assert (sh["n"], sh["ks"], sh["n_slabs"], sh["slab_bytes"]) == \
        (3840, 64, 15, 65536)


_TWIN_SRC = r"""
#include "ar_layout.cuh"
using namespace ar_layout;
extern "C" long long fixed_bytes(int nch, int video, int c, int r, int s,
                                 int l) {
  return (long long)ring_fixed_bytes(nch, video != 0, c, r, s, l);
}
extern "C" int shape(int kind, int ks, int r, int s, int c, int l,
                     int* out) {
  PhaseShape sh;
  if (!phase_shape(kind, ks, r, s, c, l, &sh)) return 0;
  out[0] = sh.n; out[1] = sh.ks; out[2] = sh.kv; out[3] = sh.ncols;
  return 1;
}
"""


def test_layout_twin_matches_the_kernel_source(tmp_path):
    """smem_layout's fixed bytes and phase_shape are the kernel's own
    (ring_fixed_bytes, phase_shape in csrc/ar_layout.cuh, which holds no
    CUDA and builds with g++) at the flagship, the fixture and widths that
    are not multiples of 4, every form, with and without video."""
    from movenet_tpu_torch.ops.cuda import build

    src = tmp_path / "twin.cpp"
    src.write_text(_TWIN_SRC)
    lib_path = tmp_path / "twin.so"
    subprocess.run(["g++", "-std=c++17", "-shared", "-fPIC",
                    f"-I{build.CSRC}", str(src), "-o", str(lib_path)],
                   check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.fixed_bytes.restype = ctypes.c_longlong
    out = (ctypes.c_int * 4)()
    for c, r, s, n_layers in ((256, 64, 64, 30), (32, 16, 16, 6),
                              (30, 10, 6, 6), (129, 7, 5, 3)):
        for nch in (1, 2, 3):
            for video in ((False, True) if nch == 1 else (False,)):
                lay = ars.smem_layout(True, nch, c, r, s, n_layers, video)
                assert lib.fixed_bytes(nch, int(video), c, r, s, n_layers) \
                    == lay["fixed"], (c, r, s, nch, video)
        for k, kind in enumerate(ars.KINDS):
            for slab in (ars.SLAB_BYTES, 2048):
                sh = ars.phase_shape(kind, r, s, c, n_layers, slab)
                assert lib.shape(k, sh["ks"], r, s, c, n_layers, out) == 1
                assert list(out) == [sh["n"], sh["ks"], sh["kv"],
                                     sh["ncols"]], (kind, r, s, c)
