"""The speculative sampler kernel (csrc/ar_sampler.cu,
ar_sampler_kernel<FAST, NCH > 1, false>) against its plain torch version and against the
standard kernel, on a CUDA GPU.  Imports only torch and the port, so that
it runs on a machine without JAX:

    python -m pytest tests/test_torch_spec_sampler_cuda.py -q

Without a card every test skips."""

import numpy as np
import pytest
import torch

from movenet_tpu_torch.config import ModelConfig
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops.cuda import ar_sampler as ars
from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits


def _gpu_model(sharpen: bool):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                      residual_channels=16, skip_channels=16)
    model = make_wavenet(cfg, generator=torch.Generator().manual_seed(0))
    if sharpen:
        with torch.no_grad():
            # greedy decisions get a margin above float32 summation noise
            model.head2.kernel.mul_(10.0)
    return model.to("cuda").eval()


@pytest.fixture
def gpu_model():
    return _gpu_model(sharpen=True)


def _wide_model(sharpen: bool):
    """Layer 3 x stack 2, R=S=64, C=256: one iteration's weight stream
    (0.9 MB exact, 1.3 MB fast) is several times the kernel's ring of
    stages (about 192 KB), and h2_w alone (256 KB) is larger than it, so
    the stages wrap within an iteration and across iterations."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=256,
                      residual_channels=64, skip_channels=64)
    model = make_wavenet(cfg, generator=torch.Generator().manual_seed(1))
    if sharpen:
        with torch.no_grad():
            model.head2.kernel.mul_(10.0)
    return model.to("cuda").eval()


@pytest.fixture(scope="module")
def wide_model():
    return _wide_model(sharpen=True)


@pytest.fixture(scope="module")
def wide_model_plain_head():
    return _wide_model(sharpen=False)


@pytest.fixture
def gpu_model_plain_head():
    return _gpu_model(sharpen=False)


SPEC_CASES = [(o, d, True) for o in (2, 3) for d in (1, 2)] \
    + [(3, 1, False), (3, 2, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("order,depth,adaptive", SPEC_CASES)
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_kernel_matches_plain(gpu_model, order, depth, adaptive, fast,
                                   temperature):
    rf = gpu_model.receptive_fields
    prompt = np.random.default_rng(order * 10 + depth).integers(
        0, 32, size=(1, rf))
    # an odd count past RF: the t+1 / t+2 guards at the end are exercised
    inp = ars.prepare(gpu_model, prompt, rf + 301, temperature=temperature,
                      seed=3, fast=fast, speculative=True)
    before = ars.launch_counts[inp.spec_name]
    got, hits = ars.ar_sampler_spec(inp, order, depth, adaptive)
    torch.cuda.synchronize()
    assert ars.launch_counts[inp.spec_name] == before + 1
    want, want_hits = ars.ar_sampler_spec_plain(inp, order, depth, adaptive)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert int(hits) == int(want_hits)
    codes = torch.cat([inp.prompt, got], dim=1)[0].cpu().numpy()
    assert int(hits) == simulate_spec_hits(codes, 32, rf, order, depth,
                                           adaptive)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_kernel_codes_equal_standard_kernel(gpu_model_plain_head,
                                                 fast, depth, temperature):
    """On unsharpened weights the decisions have no margin to spare; the
    codes are still equal because every chain runs the standard kernel's
    float32 operations in the same order.  The server's validation
    relies on exactly this."""
    model = gpu_model_plain_head
    rf = model.receptive_fields
    prompt = np.random.default_rng(7).integers(0, 32, size=(1, rf))
    kw = dict(temperature=temperature, seed=5, fast=fast)
    want = ars.cuda_generate(model, prompt, rf + 400, **kw)
    got, hits = ars.cuda_generate(model, prompt, rf + 400, speculative=True,
                                  spec_depth=depth, return_stats=True, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert int(hits) == simulate_spec_hits(got[0].cpu().numpy(), 32, rf,
                                           3, depth)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_kernel_matches_plain_where_the_stream_wraps_the_ring(
        wide_model, order, depth, fast, temperature):
    model = wide_model
    rf = model.receptive_fields
    prompt = np.random.default_rng(order * 10 + depth).integers(
        0, 256, size=(1, rf))
    inp = ars.prepare(model, prompt, rf + 201, temperature=temperature,
                      seed=3, fast=fast, speculative=True,
                      spec_order=order, spec_depth=depth)
    lay = ars.smem_layout(fast, depth + 1, 256, 64, 64, len(model.dilations))
    stream = inp.streams[(depth + 1, ars.SLAB_BYTES)]
    ring_bytes = lay["n_stages"] * lay["stage_bytes"]
    assert 4 * stream.numel() > 4 * ring_bytes     # several times the ring
    got, hits = ars.ar_sampler_spec(inp)
    want, want_hits = ars.ar_sampler_spec_plain(inp)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert int(hits) == int(want_hits)
    codes = torch.cat([inp.prompt, got], dim=1)[0].cpu().numpy()
    assert int(hits) == simulate_spec_hits(codes, 256, rf, order, depth)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("depth", [1, 2])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_spec_kernel_codes_equal_standard_kernel_where_the_stream_wraps(
        wide_model_plain_head, fast, depth, temperature):
    model = wide_model_plain_head
    rf = model.receptive_fields
    prompt = np.random.default_rng(11).integers(0, 256, size=(1, rf))
    kw = dict(temperature=temperature, seed=5, fast=fast)
    want = ars.cuda_generate(model, prompt, rf + 300, **kw)
    got, hits = ars.cuda_generate(model, prompt, rf + 300, speculative=True,
                                  spec_depth=depth, return_stats=True, **kw)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert int(hits) == simulate_spec_hits(got[0].cpu().numpy(), 256, rf,
                                           3, depth)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("order,depth", [(3, 1), (2, 2)])
@pytest.mark.parametrize("fast", [False, True])
def test_spec_kernel_at_widths_not_multiples_of_4(order, depth, fast):
    """C=30, R=10, S=6: the stream pads each dot's segments to 4 rows, and
    the chains' codes still equal the plain version's and the standard
    kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=30,
                      residual_channels=10, skip_channels=6)
    model = make_wavenet(cfg, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        model.head2.kernel.mul_(10.0)
    model = model.to("cuda").eval()
    rf = model.receptive_fields
    prompt = np.random.default_rng(5).integers(0, 30, size=(1, rf))
    inp = ars.prepare(model, prompt, rf + 301, fast=fast, speculative=True,
                      spec_order=order, spec_depth=depth)
    got, hits = ars.ar_sampler_spec(inp)
    want, want_hits = ars.ar_sampler_spec_plain(inp)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert int(hits) == int(want_hits)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  ars.ar_sampler(inp).cpu().numpy())


@pytest.mark.cuda
def test_spec_wrapper_rejects_a_wrong_input(gpu_model):
    rf = gpu_model.receptive_fields
    inp = ars.prepare(gpu_model, np.zeros((1, rf), np.int64), rf + 8,
                      speculative=True)
    inp.ring = inp.ring.double()
    with pytest.raises(ValueError, match="ring is torch.float64"):
        ars.ar_sampler_spec(inp)
    plain = ars.prepare(gpu_model, np.zeros((1, rf), np.int64), rf + 8)
    with pytest.raises(ValueError, match="speculative=True"):
        ars.ar_sampler_spec(plain)
