"""movenet_tpu_torch numerics against movenet_tpu on the CPU: mu-law,
config, causal-conv geometry, the jax.random port, and that the port
imports without JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import movenet_tpu.config as jcfg
from movenet_tpu.ops import conv as jconv
from movenet_tpu.ops.mulaw import mu_law_decode as j_decode
from movenet_tpu.ops.mulaw import mu_law_encode as j_encode
from movenet_tpu.ops.pallas.ar_sampler import _positional_gumbel

import movenet_tpu_torch.config as tcfg
from movenet_tpu_torch.ops import conv as tconv
from movenet_tpu_torch.ops import jax_random
from movenet_tpu_torch.ops import mu_law_decode, mu_law_encode
from movenet_tpu_torch.ops.cuda.ar_sampler import (positional_bits,
                                                   positional_gumbel)

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------- mu-law
@pytest.mark.parametrize("qc", [16, 64, 128, 256])
def test_mulaw_encode_bit_equal(qc):
    rng = np.random.default_rng(qc)
    x = np.concatenate([
        np.linspace(-1, 1, 4097),
        np.sin(np.arange(0, 400, 0.1)),
        rng.uniform(-1.0, 1.0, 4096),
        [-1.5, 1.5, 3.0],            # no clamp: out-of-range codes
    ]).astype(np.float32)
    want = np.asarray(j_encode(jnp.asarray(x), qc))
    got = mu_law_encode(torch.from_numpy(x), qc).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("qc", [16, 256])
def test_mulaw_decode_matches_jax(qc):
    """Decoded floats agree to two units in the last place at |x| = 1:
    XLA's CPU expm1 is its own approximation (48 of the 256 decoded
    values at qc=256 differ from torch's in the last bits), so
    bit-equality is held on the codes, which survive the round trip
    exactly in both packages."""
    q = np.arange(qc)
    want = np.asarray(j_decode(jnp.asarray(q), qc))
    got = mu_law_decode(torch.from_numpy(q), qc).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=2.4e-7)
    back = mu_law_encode(torch.from_numpy(got), qc).numpy()
    np.testing.assert_array_equal(back, q)
    np.testing.assert_array_equal(
        back, np.asarray(j_encode(jnp.asarray(want), qc)))


def test_mulaw_known_values_and_truncating_cast():
    got = mu_law_encode(torch.tensor([-1.0, 0.0, 1.0]), 256)
    np.testing.assert_array_equal(got.numpy(), [0, 128, 255])
    # y + 1 < 0 below -1: truncation toward zero, not floor
    x = np.asarray([-1.01, -1.2], np.float32)
    np.testing.assert_array_equal(
        mu_law_encode(torch.from_numpy(x), 256).numpy(),
        np.asarray(j_encode(jnp.asarray(x), 256)))


# ---------------------------------------------------------------- config
def _fields(cls):
    out = {}
    for f in dataclasses.fields(cls):
        if f.default is not dataclasses.MISSING:
            out[f.name] = f.default
        else:
            out[f.name] = dataclasses.asdict(f.default_factory())
    return out


@pytest.mark.parametrize("name", ["ModelConfig", "MeshConfig",
                                  "TrainingConfig"])
def test_config_fields_and_defaults_match(name):
    assert _fields(getattr(tcfg, name)) == _fields(getattr(jcfg, name))


def test_jax_written_config_loads(tmp_path):
    mc = jcfg.ModelConfig(layer_size=10, stack_size=3, input_channels=256,
                          residual_channels=64, skip_channels=64,
                          global_classes=4, use_context=False)
    cfg = jcfg.TrainingConfig(model_config=mc, scheduler=None,
                              scheduler_milestones=[3, 5],
                              mesh=jcfg.MeshConfig(data=2, seq=1))
    cfg.save(tmp_path / "config.json")
    got = tcfg.TrainingConfig.load(tmp_path / "config.json")
    assert got.to_dict() == cfg.to_dict()
    assert got.model_config.receptive_fields == 3072
    assert got.model_config.dilations == mc.dilations
    again = tcfg.TrainingConfig.from_json(got.to_json())
    assert again == got


# ------------------------------------------------------------------ conv
@pytest.mark.parametrize("layer,stack", [(3, 2), (10, 3), (14, 1)])
def test_conv_geometry_matches(layer, stack):
    assert tconv.wavenet_dilations(layer, stack) == \
        jconv.wavenet_dilations(layer, stack)
    rf = jconv.receptive_field(layer, stack)
    assert tconv.receptive_field(layer, stack) == rf
    assert tconv.compute_output_size(rf + 5, layer, stack) == \
        jconv.compute_output_size(rf + 5, layer, stack)
    with pytest.raises(ValueError):
        tconv.compute_output_size(rf - 1, layer, stack)
    for s_in, s_out in [(160, 1600), (1, 5), (16, 160)]:
        assert tconv.upsample_kernel_size(s_in, s_out, stride=10) == \
            jconv.upsample_kernel_size(s_in, s_out, stride=10)


@pytest.mark.parametrize("shift", [0, 1, 3, 9])
def test_causal_pad_shift_matches(shift, rng_np):
    x = rng_np.standard_normal((2, 7, 3)).astype(np.float32)
    want = np.asarray(jconv.causal_pad_shift(jnp.asarray(x), shift))
    got = tconv.causal_pad_shift(torch.from_numpy(x), shift).numpy()
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ jax_random
@pytest.mark.parametrize("seed", [0, 3, 12345, -7, 2 ** 31 + 5])
def test_prng_key_and_fold_in_bit_equal(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jax_random.PRNGKey(seed),
                                  np.asarray(jax.random.key_data(key)))
    for t in (0, 1, 15, 3071, 100_000, 2 ** 32 - 1):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(key, t)))
        got = jax_random.fold_in(jax_random.PRNGKey(seed), t)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(1, 32), (4, 33), (8, 256)])
def test_random_bits_and_uniform_bit_equal(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 17)
    k = jax_random.fold_in(jax_random.PRNGKey(3), 17)
    np.testing.assert_array_equal(
        jax_random.random_bits(k, shape),
        np.asarray(jax.random.bits(key, shape, jnp.uint32)))
    tiny = np.finfo(np.float32).tiny
    np.testing.assert_array_equal(
        jax_random.uniform(k, shape, minval=tiny),
        np.asarray(jax.random.uniform(key, shape, minval=tiny)))
    # the Gumbel transform is two float32 logs: XLA's and torch's agree
    # to float32 rounding, not bit for bit
    np.testing.assert_allclose(
        jax_random.gumbel(k, shape),
        np.asarray(jax.random.gumbel(key, shape)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 3])
@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_categorical_equal(seed, scale):
    logits = (np.random.default_rng(seed).standard_normal((8, 256))
              * scale).astype(np.float32)
    for t in range(0, 40, 7):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        want = np.asarray(jax.random.categorical(key, logits, axis=-1))
        got = jax_random.categorical(
            jax_random.fold_in(jax_random.PRNGKey(seed), t),
            torch.from_numpy(logits)).numpy()
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------- positional gumbel
@pytest.mark.parametrize("seed,t,batch,c_in", [
    (0, 16, 1, 32), (3, 3072, 8, 256), (-5, 2 ** 20, 32, 256),
    (2 ** 31 - 1, 123_457, 4, 33)])
def test_positional_gumbel_matches(seed, t, batch, c_in):
    want = np.asarray(_positional_gumbel(
        jnp.asarray(seed, jnp.int32), jnp.asarray(t, jnp.int32), batch,
        c_in))
    bits = positional_bits(seed, t, batch, c_in).numpy()
    assert bits.min() >= 0 and bits.max() < 2 ** 24
    # the integer hash is bit-equal: JAX's own float tail applied to the
    # port's 24-bit integers reproduces JAX's noise exactly
    u = jnp.asarray(bits.astype(np.int32)).astype(jnp.float32) \
        * (1.0 / (1 << 24))
    tail = np.asarray(-jnp.log(-jnp.log(u + 1e-20) + 1e-20))
    np.testing.assert_array_equal(tail, want)
    got = positional_gumbel(seed, t, batch, c_in).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# -------------------------------------------------------- import isolation
def test_port_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import movenet_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "'movenet_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "assert not any(k == 'jax' or k.startswith('jax.') or "
        "k.startswith('movenet_tpu.') or k == 'movenet_tpu' "
        "for k, v in sys.modules.items() if v is not None), 'jax leaked'\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 14
