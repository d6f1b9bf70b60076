"""movenet_tpu_torch cached samplers against movenet_tpu.models.sampler on
the CPU (layer 3 x stack 2, C=32, R=S=16, float32): codes equal JAX's,
greedy and sampled, and the incremental logits equal the parallel
forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movenet_tpu.config import ModelConfig
from movenet_tpu.models import sampler as jsampler
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make

from movenet_tpu_torch.models import sampler as tsampler
from movenet_tpu_torch.models.convert import load_jax_params
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops import jax_random

torch.set_num_threads(1)


def _models(global_classes=0):
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                      residual_channels=16, skip_channels=16,
                      compute_dtype="float32",
                      global_classes=global_classes)
    jm = j_make(cfg)
    rf = jm.receptive_fields
    labels = jnp.zeros((1,), jnp.int32) if global_classes else None
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, rf), jnp.int32), None, labels,
                        method=JWaveNet.init_all)
    return jm, variables, load_jax_params(make_wavenet(cfg), variables)


@pytest.fixture(scope="module")
def models():
    return _models()


def test_fast_generate_greedy_matches_jax(models, rng_np):
    jm, variables, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(2, rf)).astype(np.int32)
    n = rf + 120
    want = np.asarray(jsampler.fast_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=0.0))
    got = tsampler.fast_generate(tm, prompt, n, temperature=0.0).numpy()
    assert got.shape == (2, n) and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parity", [True, False])
def test_fast_generate_sampled_matches_jax(models, parity, rng_np):
    jm, variables, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(3, rf)).astype(np.int32)
    n = rf + 100
    want = np.asarray(jsampler.fast_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=1.0,
        rng=jax.random.PRNGKey(7), parity_sampling=parity))
    got = tsampler.fast_generate(
        tm, prompt, n, temperature=1.0, rng=jax_random.PRNGKey(7),
        parity_sampling=parity).numpy()
    np.testing.assert_array_equal(got, want)


def test_cold_start_equals_warm_start(models, rng_np):
    jm, variables, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(1, rf)).astype(np.int32)
    warm = tsampler.fast_generate(tm, prompt, rf + 60, temperature=1.0,
                                  rng=jax_random.PRNGKey(2))
    cold = tsampler.fast_generate(tm, prompt, rf + 60, temperature=1.0,
                                  rng=jax_random.PRNGKey(2),
                                  warm_start=False)
    np.testing.assert_array_equal(cold.numpy(), warm.numpy())


def test_incremental_logits_equal_parallel_forward(models, rng_np):
    jm, variables, tm = models
    codes = rng_np.integers(0, 32, size=(2, 50)).astype(np.int32)
    got = tsampler.incremental_logits(tm, codes)
    with torch.no_grad():
        parallel = tm.backbone(torch.from_numpy(codes), None)
    np.testing.assert_allclose(got.numpy(), parallel.numpy(), atol=1e-5,
                               rtol=0)
    want = np.asarray(jsampler.incremental_logits(jm, variables,
                                                  jnp.asarray(codes)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


def test_naive_generate_matches_fast_and_jax(models, rng_np):
    jm, variables, tm = models
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(1, rf)).astype(np.int32)
    n = rf + 30
    naive = tsampler.naive_generate(tm, prompt, n).numpy()
    fast = tsampler.fast_generate(tm, prompt, n, temperature=0.0).numpy()
    np.testing.assert_array_equal(naive, fast)
    want = np.asarray(jsampler.naive_generate(jm, variables,
                                              jnp.asarray(prompt), n))
    np.testing.assert_array_equal(naive, want)


def test_fast_generate_global_labels_match_jax(rng_np):
    jm, variables, tm = _models(global_classes=3)
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(2, rf)).astype(np.int32)
    labels = np.asarray([2, 1], np.int32)
    n = rf + 64
    want = np.asarray(jsampler.fast_generate(
        jm, variables, jnp.asarray(prompt), n, temperature=0.0,
        labels=jnp.asarray(labels)))
    got = tsampler.fast_generate(tm, prompt, n, temperature=0.0,
                                 labels=labels).numpy()
    np.testing.assert_array_equal(got, want)


def test_fast_generate_rejects_short_n(models):
    jm, _, tm = models
    rf = jm.receptive_fields
    with pytest.raises(ValueError):
        tsampler.fast_generate(tm, np.zeros((1, rf), np.int32), rf)
