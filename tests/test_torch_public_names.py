"""The JAX package's public names and its audio ops in the port.

Every name in the ``__all__`` of ``movenet_tpu``, ``.ops``, ``.train``,
``.utils``, ``.parallel`` and ``.types`` exists in the port's module of
the same name.  ``normalize_audio``, ``quantize_audio`` and
``one_hot_encode_audio`` on seeded waveforms, all-zero and constant
signals included, against JAX's: codes and one-hot columns exact, floats
within 2.4e-7 (XLA's and torch's float32 division and min/max agree to
the last bits but one).  ``dilated_causal_matmul`` in float32 within
rtol 1e-6 plus 1e-6 of the output's scale (a sum of products that
cancels keeps the absolute error of its terms), and from bfloat16
operands into float32 at the same bar.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from movenet_tpu.ops import conv as jconv
from movenet_tpu.ops.audio import normalize_audio as j_normalize
from movenet_tpu.ops.audio import one_hot_encode_audio as j_one_hot
from movenet_tpu.ops.audio import quantize_audio as j_quantize

from movenet_tpu_torch.ops import (
    dilated_causal_matmul,
    normalize_audio,
    one_hot_encode_audio,
    quantize_audio,
)

torch.set_num_threads(2)


@pytest.mark.parametrize("module", ["", ".ops", ".train", ".utils",
                                    ".parallel", ".types"])
def test_jax_public_names_exist_in_the_port(module):
    jmod = importlib.import_module("movenet_tpu" + module)
    tmod = importlib.import_module("movenet_tpu_torch" + module)
    missing = [n for n in jmod.__all__ if not hasattr(tmod, n)]
    assert not missing, missing
    if hasattr(tmod, "__all__"):
        assert set(jmod.__all__) <= set(tmod.__all__)


def test_package_constants_and_lazy_names():
    import movenet_tpu
    import movenet_tpu_torch
    from movenet_tpu_torch.models.sampler import fast_generate

    for name in ("MAX_AUDIO_FRAMES", "MAX_VIDEO_FRAMES", "VIDEO_FRAME_SIZE",
                 "UPSAMPLE_STRIDE"):
        assert getattr(movenet_tpu_torch, name) == getattr(movenet_tpu, name)
    assert movenet_tpu_torch.fast_generate is fast_generate
    with pytest.raises(AttributeError, match="no attribute 'nope'"):
        movenet_tpu_torch.nope  # noqa: B018


def _signals():
    rng = np.random.default_rng(11)
    return {
        "noise": rng.uniform(-0.7, 0.4, 4000).astype(np.float32),
        "sine": (0.3 * np.sin(np.arange(0, 400, 0.1)) + 0.05).astype(
            np.float32),
        "loud": (3.0 * rng.standard_normal(2000)).astype(np.float32),
        "zeros": np.zeros(1000, np.float32),
        "constant": np.full(1000, 0.25, np.float32),
        "zero_sum": np.array([-1.0, 0.5, 0.5, 0.0], np.float32),
    }


@pytest.mark.parametrize("name", list(_signals()))
def test_audio_ops_match_jax(name):
    x = _signals()[name]
    want = np.asarray(j_normalize(jnp.asarray(x)))
    got = normalize_audio(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    if name in ("zeros", "zero_sum"):   # the all-zero guard
        np.testing.assert_array_equal(got, x)
    for channels in (32, 256):
        for normalize in (True, False):
            q = quantize_audio(torch.from_numpy(x), channels, normalize)
            np.testing.assert_array_equal(
                q.numpy(), np.asarray(j_quantize(jnp.asarray(x), channels,
                                                 normalize)))
            assert q.dtype == torch.int32
        oh = one_hot_encode_audio(torch.from_numpy(x[None]), channels)
        np.testing.assert_array_equal(
            oh.numpy(), np.asarray(j_one_hot(jnp.asarray(x[None]), channels)))
        assert oh.shape == (channels, x.size)


@pytest.mark.parametrize("dilation", [1, 4, 300])
def test_dilated_causal_matmul_matches_jax(dilation):
    rng = np.random.default_rng(dilation)
    x = rng.standard_normal((2, 257, 12)).astype(np.float32)
    wc = rng.standard_normal((12, 20)).astype(np.float32)
    wp = rng.standard_normal((12, 20)).astype(np.float32)
    want = np.asarray(jconv.dilated_causal_matmul(
        jnp.asarray(x), jnp.asarray(wc), jnp.asarray(wp), dilation))
    got = dilated_causal_matmul(torch.from_numpy(x), torch.from_numpy(wc),
                                torch.from_numpy(wp), dilation)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * scale)
    # bf16 operands, float32 result: products exact, summed in float32
    xb, wcb, wpb = (jnp.asarray(a, jnp.bfloat16) for a in (x, wc, wp))
    want = np.asarray(jconv.dilated_causal_matmul(xb, wcb, wpb, dilation))
    got = dilated_causal_matmul(
        *(torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
          for a in (xb, wcb, wpb)), dilation)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
