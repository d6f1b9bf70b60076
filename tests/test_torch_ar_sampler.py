"""movenet_tpu_torch AR sampler (ops/cuda/ar_sampler.py) against the JAX
Pallas kernel run in interpret mode on the CPU, at the small size of
tests/test_pallas_sampler.py (layer 3 x stack 2, C=32, R=S=16); the
video cases at layer 3 x stack 1 with 1 video frame for 1000 samples.
The CUDA kernel itself runs only on a GPU:
tests/test_torch_ar_sampler_cuda.py holds it against the plain version
there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movenet_tpu.config import ModelConfig
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.ops.pallas import ar_sampler as jars

from movenet_tpu_torch.models.convert import load_jax_params
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops.cuda import ar_sampler as ars
from movenet_tpu_torch.ops.cuda import build

torch.set_num_threads(1)


def _models(sharpen=False, global_classes=0):
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                      residual_channels=16, skip_channels=16,
                      compute_dtype="float32",
                      global_classes=global_classes)
    jm = j_make(cfg)
    labels = jnp.zeros((1,), jnp.int32) if global_classes else None
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, jm.receptive_fields), jnp.int32),
                        None, labels, method=JWaveNet.init_all)
    if sharpen:
        # as tests/test_pallas_sampler.py does: greedy decisions get a
        # margin above float32 reassociation noise
        p = dict(variables["params"])
        p["head2"] = dict(p["head2"],
                          kernel=jnp.asarray(p["head2"]["kernel"]) * 10.0)
        variables = {"params": p}
    return jm, variables, load_jax_params(make_wavenet(cfg), variables)


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def video_models():
    """A video-conditioned model with global classes: 1 frame -> 1000
    samples (three stride-10 stages), head2 x 10 as ``_models``; and a
    seeded (2, 1, 64, 64, 1) video."""
    cfg = ModelConfig(layer_size=3, stack_size=1, input_channels=32,
                      residual_channels=16, skip_channels=16,
                      compute_dtype="float32", max_audio_frames=1000,
                      max_video_frames=1, global_classes=3)
    jm = j_make(cfg)
    video = np.random.default_rng(11).uniform(
        0, 255, (2, 1, 64, 64, 1)).astype(np.float32)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((2, 1000), jnp.int32), jnp.asarray(video),
                        jnp.zeros((2,), jnp.int32), method=JWaveNet.init_all)
    p = dict(variables["params"])
    p["head2"] = dict(p["head2"],
                      kernel=jnp.asarray(p["head2"]["kernel"]) * 10.0)
    variables = {"params": p}
    return jm, variables, load_jax_params(make_wavenet(cfg), variables), \
        video


@pytest.mark.parametrize("with_context", [False, True])
def test_stack_sampler_params_equal(models, with_context):
    jm, variables, tm = models
    want = jars.stack_sampler_params(jm, variables, with_context)
    got = ars.stack_sampler_params(tm, with_context)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    r = tm.residual_channels
    assert got["w_fg"].shape[1] == (3 if with_context else 2) * r


@pytest.mark.parametrize("with_context", [False, True])
def test_stack_fast_weights_equal(models, with_context):
    jm, variables, tm = models
    want = jars.stack_fast_weights(jm, jars.stack_sampler_params(
        jm, variables, with_context))
    got = ars.stack_fast_weights(tm, ars.stack_sampler_params(
        tm, with_context))
    assert set(got) == set(want)
    for k in want:
        # the weight products are float32 matmuls summed in another order
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)
    assert not got["w_prod"][-1].any()


@pytest.mark.parametrize("batch", [1, 4])
def test_plain_greedy_matches_pallas(models, batch, rng_np):
    jm, variables, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(batch, rf)).astype(np.int32)
    n = rf + 160
    want = np.asarray(jars.pallas_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=0.0,
        interpret=True))
    got = ars.plain_generate(tm, prompt, n, temperature=0.0).numpy()
    assert got.shape == (batch, n) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_plain_fast_mode_matches_pallas(rng_np):
    jm, variables, tm = _models(sharpen=True)
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(1, rf)).astype(np.int32)
    n = rf + 160
    want = np.asarray(jars.pallas_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=0.0,
        interpret=True, fast=True))
    got = ars.plain_generate(tm, prompt, n, fast=True).numpy()
    np.testing.assert_array_equal(got, want)
    exact = ars.plain_generate(tm, prompt, n, fast=False).numpy()
    np.testing.assert_array_equal(got, exact)


@pytest.mark.parametrize("parity", [True, False])
def test_plain_sampled_matches_pallas(models, parity, rng_np):
    jm, variables, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(2, rf)).astype(np.int32)
    n = rf + 120
    want = np.asarray(jars.pallas_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=0.7, seed=5,
        parity_sampling=parity, interpret=True))
    got = ars.plain_generate(tm, prompt, n, temperature=0.7, seed=5,
                             parity_sampling=parity).numpy()
    np.testing.assert_array_equal(got, want)


def test_plain_global_labels_match_pallas(rng_np):
    jm, variables, tm = _models(global_classes=3)
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(2, rf)).astype(np.int32)
    labels = np.asarray([1, 2], np.int32)
    n = rf + 80
    want = np.asarray(jars.pallas_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=0.0,
        labels=jnp.asarray(labels), interpret=True))
    got = ars.plain_generate(tm, prompt, n, labels=labels).numpy()
    np.testing.assert_array_equal(got, want)


def test_wrapper_on_cpu_takes_the_plain_version(models, rng_np):
    jm, _, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(2, rf)).astype(np.int32)
    before = dict(ars.launch_counts)
    got = ars.cuda_generate(tm, prompt, rf + 40, temperature=1.0, seed=2,
                            fast=True)
    want = ars.plain_generate(tm, prompt, rf + 40, temperature=1.0, seed=2,
                              fast=True)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert ars.launch_counts == before       # no kernel ran
    inp = ars.prepare(tm, prompt, rf + 40)
    assert inp.ring.shape == (2, sum(tm.dilations), 16)
    assert inp.b_fg.shape == (len(tm.dilations), 2, 32)
    np.testing.assert_array_equal(inp.init_codes[0].numpy(), prompt[:, -1])


def test_plain_margins_are_reported(models, rng_np):
    jm, _, tm = models
    rf = jm.receptive_fields
    inp = ars.prepare(tm, rng_np.integers(0, 32, size=(1, rf)), rf + 20)
    codes, margins = ars.ar_sampler_plain(inp, return_margins=True)
    assert margins.shape == codes.shape == (1, 20)
    assert (margins >= 0).all()
    np.testing.assert_array_equal(codes.numpy(),
                                  ars.ar_sampler_plain(inp).numpy())


def test_error_checks(models):
    jm, _, tm = models
    rf = jm.receptive_fields
    with pytest.raises(ValueError, match="batch sizes"):
        ars.cuda_generate(tm, np.zeros((3, rf), np.int32), rf + 10)
    with pytest.raises(ValueError, match="must exceed RF"):
        ars.cuda_generate(tm, np.zeros((1, rf), np.int32), rf)
    with pytest.raises(ValueError, match="requires speculative"):
        ars.cuda_generate(tm, np.zeros((1, rf), np.int32), rf + 10,
                          return_stats=True)
    with pytest.raises(ValueError, match="speculative sampling supports "
                       "B=1"):
        ars.cuda_generate(tm, np.zeros((2, rf), np.int32), rf + 10,
                          speculative=True)
    with pytest.raises(ValueError, match=r"\[0, 32\)"):
        ars.cuda_generate(tm, np.full((1, rf), 32, np.int32), rf + 10)
    with pytest.raises(ValueError, match="prompt must be"):
        ars.cuda_generate(tm, np.zeros((1, rf - 1), np.int32), rf + 10)


VIDEO_CASES = {
    # label: (batch, n - RF or absolute n, temperature, fast, labels)
    "greedy B=2 exact": (2, 160, 0.0, False, False),
    "greedy B=1 fast": (1, 160, 0.0, True, False),
    "T=1.0 parity B=2": (2, 120, 1.0, False, False),
    "greedy B=2 labels": (2, 100, 0.0, False, True),
    # past T_ctx = 1000 the kernel path conditions on zero rows
    "greedy B=2 past T_ctx": (2, None, 0.0, False, False),
}


@pytest.mark.parametrize("case", sorted(VIDEO_CASES))
def test_plain_video_matches_pallas(video_models, case):
    jm, variables, tm, video = video_models
    batch, extra, temp, fast, with_labels = VIDEO_CASES[case]
    rf = jm.receptive_fields
    n = 1100 if extra is None else rf + extra
    prompt = np.random.default_rng(batch).integers(
        0, 32, size=(batch, rf)).astype(np.int32)
    labels = np.asarray([1, 2][:batch], np.int32) if with_labels else None
    want = np.asarray(jars.pallas_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=temp, seed=5,
        video=jnp.asarray(video[:batch]),
        labels=None if labels is None else jnp.asarray(labels),
        interpret=True, fast=fast))
    got = ars.plain_generate(tm, prompt, n, temperature=temp, seed=5,
                             video=torch.from_numpy(video[:batch]),
                             labels=labels, fast=fast).numpy()
    assert got.shape == (batch, n)
    np.testing.assert_array_equal(got, want)


def test_video_inputs_and_route(video_models):
    """The video inputs: (L, 3R, 2R) taps, the context bias, ctx rows
    zero past T_ctx; the wrapper on CPU tensors takes the plain version
    and counts no launch; speculation refuses video."""
    jm, _, tm, video = video_models
    rf = jm.receptive_fields
    prompt = np.zeros((2, rf), np.int32)
    v = torch.from_numpy(video)
    inp = ars.prepare(tm, prompt, 1100, video=v, fast=True)
    assert inp.name == "ar_sampler_ctx_fast"
    assert ars.prepare(tm, prompt, rf + 8, video=v).name == \
        "ar_sampler_ctx_exact"
    assert inp.ctx.shape == (2, 1100, 16) and inp.ctx.is_contiguous()
    np.testing.assert_array_equal(
        inp.ctx[:, :1000].numpy(), tm.encode_video(v).detach().numpy())
    assert not inp.ctx[:, 1000:].any()
    assert inp.weights["w_fg"].shape == (3, 48, 32)
    assert inp.weights["w_p0c"].shape == (32, 32)
    before = dict(ars.launch_counts)
    np.testing.assert_array_equal(ars.ar_sampler(inp).numpy(),
                                  ars.ar_sampler_plain(inp).numpy())
    assert ars.launch_counts == before
    with pytest.raises(ValueError, match="without video"):
        ars.cuda_generate(tm, prompt[:1], rf + 8, video=v[:1],
                          speculative=True)
    with pytest.raises(ValueError, match="video batch 2 != prompt batch 1"):
        ars.cuda_generate(tm, prompt[:1], rf + 8, video=v)


def test_ring_bytes_limit_message():
    # sum of dilations 32767 at R=16, B=32: 64 MiB of rings
    cfg = ModelConfig(layer_size=15, stack_size=1, input_channels=4,
                      residual_channels=16, skip_channels=4)
    tm = make_wavenet(cfg)
    rf = tm.receptive_fields
    with pytest.raises(ValueError, match="ring buffers need 64 MiB VMEM "
                       r"at batch=32 \(sum of dilations 32767, R=16\)"):
        ars.cuda_generate(tm, np.zeros((32, rf), np.int32), rf + 1)


def test_build_sources_and_missing_nvcc(monkeypatch, tmp_path):
    assert "ar_sampler" in build.sources()
    assert build.build_dir().name == "movenet_tpu_torch"
    monkeypatch.setenv("MOVENET_TORCH_BUILD_DIR", str(tmp_path))
    assert build.build_dir() == tmp_path
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load("ar_sampler")
    with pytest.raises(KeyError):
        build.build(["no_such_kernel"])
