"""The speculative kernel's packed weight stream (ops/cuda/ar_sampler.py,
pack_spec_stream), on the CPU: it holds every weight the kernel reads,
bit for bit, in the order of the kernel's phases and in the layout its
consumer threads read; its slabs are 16-byte aligned multiples of 16
bytes; and the ring plus the chain buffers fit a block's shared memory
at the flagship width."""

import numpy as np
import pytest
import torch

from movenet_tpu_torch.config import ModelConfig
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops.cuda import ar_sampler as ars
from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

FLAGSHIP_DILATIONS = [2 ** i for i in range(10)] * 3


def _model(c=32, r=16, s=16, layer=3, stack=2):
    torch.set_num_threads(2)
    cfg = ModelConfig(layer_size=layer, stack_size=stack, input_channels=c,
                      residual_channels=r, skip_channels=s)
    return make_wavenet(cfg, generator=torch.Generator().manual_seed(0)).eval()


def _columns(inp, kind, l):
    """{dot i: its weight column (rows in order)} of one phase, straight
    from the weight tensors."""
    w = inp.weights
    r = w["front_cur"].shape[1]
    r2 = 2 * r
    if kind == "A":
        return {i: w["w_fg"][l, (i // r2) * r:(i // r2 + 1) * r, i % r2]
                for i in range(2 * r2)}
    if kind in ("C", "ML"):
        return {i: w["w_out"][l, :, i] for i in range(w["w_out"].shape[2])}
    if kind in ("H1", "H2"):
        m = w["h1_w" if kind == "H1" else "h2_w"]
        return {i: m[:, i] for i in range(m.shape[1])}
    if kind == "F0":
        return {i: w["w_p0c"][:, i] for i in range(r2)}
    if kind == "M2":
        return {i: w["w_fg"][l + 1, :, i] for i in range(r2)}
    out = {i: w["w_prod"][l, :, i] for i in range(r2)}
    out.update({r2 + i: w["w_fg"][l + 1, :, i] for i in range(r2)})
    out.update({2 * r2 + i: w["w_out"][l, :, i]
                for i in range(w["w_out"].shape[2])})
    return out


def _decode(stream, inp, nch, slab_bytes):
    """Walk the stream phase by phase: check each dot's rows against its
    weight column, each slab's size and offset, and that every float no
    dot owns is zero; returns the count of floats the dots own."""
    w = inp.weights
    c_in, r = w["front_cur"].shape
    s = w["w_out"].shape[2] - r
    flat = stream.numpy()
    owned = np.zeros(flat.size, bool)
    base = 0
    for kind, l in ars.spec_phases(inp.fast, nch, inp.dilations):
        sh = ars.spec_phase_shape(kind, r, s, c_in, slab_bytes)
        ks, ncols = sh["ks"], sh["ncols"]
        assert sh["slab_bytes"] == 4 * ks * ncols
        assert sh["slab_bytes"] % 16 == 0 and (4 * base) % 16 == 0
        assert sh["kv"] % ks == 0
        start = {}                      # rows a thread has taken so far
        for i, col in sorted(_columns(inp, kind, l).items()):
            c = i % ars.SPEC_CONSUMERS
            v0 = start.get(c, 0)
            for k in range(col.numel()):
                v = v0 + k
                pos = (base + (v // ks) * ks * ncols + ((v % ks) // 4) * 4
                       * ncols + 4 * c + v % 4)
                assert flat[pos].view(np.int32) == \
                    col[k].numpy().view(np.int32), (kind, l, i, k)
                owned[pos] = True
            start[c] = v0 + col.numel()
        assert max(start.values()) == sh["kv"]
        base += sh["n_slabs"] * ks * ncols
    assert base == flat.size
    assert not flat[~owned].any()
    return int(owned.sum())


@pytest.mark.parametrize("slab_bytes", [ars.SPEC_SLAB_BYTES, 2048])
@pytest.mark.parametrize("nch", [2, 3])
@pytest.mark.parametrize("fast", [False, True])
def test_stream_holds_every_weight_in_phase_order(fast, nch, slab_bytes):
    model = _model()
    rf = model.receptive_fields
    inp = ars.prepare(model, np.zeros((1, rf), np.int64), rf + 4, fast=fast,
                      speculative=True, spec_depth=nch - 1)
    stream = ars.pack_spec_stream(inp, nch, slab_bytes)
    assert stream.dtype == torch.float32 and stream.is_contiguous()
    if slab_bytes == ars.SPEC_SLAB_BYTES:
        # prepare packed it once for the request's depth
        assert inp.spec_stream[(nch, slab_bytes)] is stream
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
    lay = ars.spec_smem_layout(fast, nch, 256, 64, 64,
                               len(FLAGSHIP_DILATIONS))
    assert lay["total"] <= ars.SPEC_SMEM_LIMIT == 232_448
    assert lay["stage_bytes"] == ars.SPEC_SLAB_BYTES == 65536
    assert lay["n_stages"] == 2
    # the flagship's slabs: 64 KB, or 32 KB where a phase has 128 dots
    for kind, _ in ars.spec_phases(fast, nch, FLAGSHIP_DILATIONS):
        want = 32768 if kind in ("C", "ML", "F0", "M2") else 65536
        assert ars.spec_phase_shape(kind, 64, 64, 256)["slab_bytes"] == want
    nbytes = 4 * ars._stream_index(fast, nch, tuple(FLAGSHIP_DILATIONS), 64,
                                   64, 256).numel()
    # 3.3 MB exact; 4.3 (depth 1) and 4.5 MB (depth 2, M2 at 5 layers) fast
    want = {2: 4_325_376, 3: 4_521_984}[nch] if fast else 3_276_800
    assert nbytes == want


def test_layout_raises_above_the_shared_memory_of_a_block():
    with pytest.raises(ValueError, match="232,448"):
        ars.spec_smem_layout(True, 3, 8192, 64, 64, 30)
    with pytest.raises(ValueError, match="multiples of 4"):
        ars.spec_smem_layout(False, 2, 30, 16, 16, 6)


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
