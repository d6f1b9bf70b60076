"""The AR sampler kernel (csrc/ar_sampler.cu) in its standard form,
audio-only and with video context, against its plain torch version, on a
CUDA GPU: at a small width, at widths that are not multiples of 4, and
where the weight stream is several times the kernel's ring of stages.  Imports only
torch and the port, so that it runs on a machine without JAX:

    python -m pytest tests/test_torch_ar_sampler_cuda.py -q

Without a card every test skips."""

import numpy as np
import pytest
import torch

from movenet_tpu_torch.config import ModelConfig
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops.cuda import ar_sampler as ars


@pytest.fixture
def gpu_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                      residual_channels=16, skip_channels=16)
    model = make_wavenet(cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        # greedy decisions get a margin above float32 summation noise
        model.head2.kernel.mul_(10.0)
    return model.to("cuda").eval()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4, 32])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_kernel_matches_plain(gpu_model, batch, fast, temperature):
    rf = gpu_model.receptive_fields
    prompt = np.random.default_rng(batch).integers(0, 32, size=(batch, rf))
    inp = ars.prepare(gpu_model, prompt, rf + 300, temperature=temperature,
                      seed=3, fast=fast)
    before = ars.launch_counts[inp.name]
    got = ars.ar_sampler(inp)
    torch.cuda.synchronize()
    assert ars.launch_counts[inp.name] == before + 1
    want = ars.ar_sampler_plain(inp)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.fixture
def gpu_video_model():
    """A video-conditioned model at the same width: 1 frame -> 1000
    samples, and a seeded (4, 1, 64, 64, 1) video."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                      residual_channels=16, skip_channels=16,
                      max_audio_frames=1000, max_video_frames=1)
    model = make_wavenet(cfg, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        model.head2.kernel.mul_(10.0)
    video = np.random.default_rng(4).uniform(0, 255, (4, 1, 64, 64, 1))
    return model.to("cuda").eval(), torch.tensor(video, dtype=torch.float32,
                                                 device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
@pytest.mark.parametrize("n", [300, 1100])      # 1100: past T_ctx = 1000
def test_video_kernel_matches_plain(gpu_video_model, batch, fast,
                                    temperature, n):
    model, video = gpu_video_model
    rf = model.receptive_fields
    prompt = np.random.default_rng(batch).integers(0, 32, size=(batch, rf))
    inp = ars.prepare(model, prompt, n, temperature=temperature, seed=3,
                      video=video[:batch], fast=fast)
    assert inp.name == ("ar_sampler_ctx_fast" if fast
                        else "ar_sampler_ctx_exact")
    before = ars.launch_counts[inp.name]
    got = ars.ar_sampler(inp)
    torch.cuda.synchronize()
    assert ars.launch_counts[inp.name] == before + 1
    want = ars.ar_sampler_plain(inp)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_wrapper_rejects_a_wrong_input(gpu_model):
    rf = gpu_model.receptive_fields
    inp = ars.prepare(gpu_model, np.zeros((2, rf), np.int64), rf + 8)
    inp.b_fg = inp.b_fg.double()
    with pytest.raises(ValueError, match="b_fg is torch.float64"):
        ars.ar_sampler(inp)
    inp = ars.prepare(gpu_model, np.zeros((2, rf), np.int64), rf + 8)
    inp.ctx = torch.zeros(2, rf + 8, 16, device="cuda")
    with pytest.raises(ValueError, match=r"w_fg has shape \(6, 32, 32\)"):
        ars.ar_sampler(inp)      # video inputs need the (L, 3R, 2R) taps


def _sharp_model(cfg, seed):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = make_wavenet(cfg, generator=torch.Generator().manual_seed(seed))
    with torch.no_grad():
        model.head2.kernel.mul_(10.0)
    return model.to("cuda").eval()


def _video(batch, seed=4):
    v = np.random.default_rng(seed).uniform(0, 255, (batch, 1, 64, 64, 1))
    return torch.tensor(v, dtype=torch.float32, device="cuda")


def _kernel_vs_plain(model, batch, fast, temperature, n_gen, video):
    rf = model.receptive_fields
    c = model.input_channels
    prompt = np.random.default_rng(batch).integers(0, c, size=(batch, rf))
    inp = ars.prepare(model, prompt, rf + n_gen, temperature=temperature,
                      seed=3, fast=fast,
                      video=_video(batch) if video else None)
    before = ars.launch_counts[inp.name]
    got = ars.ar_sampler(inp)
    torch.cuda.synchronize()
    assert ars.launch_counts[inp.name] == before + 1
    want = ars.ar_sampler_plain(inp)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return inp


@pytest.fixture(scope="module")
def odd_models():
    """C=30, R=10, S=6 (no width a multiple of 4), audio-only and with
    video (1 frame -> 1000 samples)."""
    kw = dict(layer_size=3, stack_size=2, input_channels=30,
              residual_channels=10, skip_channels=6)
    return (_sharp_model(ModelConfig(**kw), 0),
            _sharp_model(ModelConfig(**kw, max_audio_frames=1000,
                                     max_video_frames=1), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("video", [False, True])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_kernel_matches_plain_at_widths_not_multiples_of_4(
        odd_models, batch, video, fast, temperature):
    _kernel_vs_plain(odd_models[int(video)], batch, fast, temperature, 300,
                     video)


@pytest.fixture(scope="module")
def wide_models():
    """Layer 3 x stack 2, C=256, R=S=64, audio-only and with video: one
    step's weight stream (0.9 MB exact, 1.1 MB fast, 0.2 MB more with
    video) is several times the kernel's ring (two 64 KB stages), and
    h2_w alone (256 KB) is larger than it."""
    kw = dict(layer_size=3, stack_size=2, input_channels=256,
              residual_channels=64, skip_channels=64)
    return (_sharp_model(ModelConfig(**kw), 1),
            _sharp_model(ModelConfig(**kw, max_audio_frames=1000,
                                     max_video_frames=1), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 4, 32])
@pytest.mark.parametrize("video", [False, True])
@pytest.mark.parametrize("fast", [False, True])
def test_kernel_matches_plain_where_the_stream_wraps_the_ring(
        wide_models, batch, video, fast):
    model = wide_models[int(video)]
    inp = _kernel_vs_plain(model, batch, fast, 1.0 if batch == 4 else 0.0,
                           200, video)
    lay = ars.smem_layout(fast, 1, 256, 64, 64, len(model.dilations), video)
    stream = inp.streams[(1, ars.SLAB_BYTES)]
    ring_bytes = lay["n_stages"] * lay["stage_bytes"]
    assert 4 * stream.numel() > 4 * ring_bytes     # several times the ring
