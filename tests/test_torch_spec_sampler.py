"""movenet_tpu_torch speculative sampler (ops/cuda/ar_sampler.py:
ar_sampler_spec_plain, prepare(speculative=True)) against the JAX
speculative kernel run in interpret mode on the CPU, at the small size of
tests/test_pallas_sampler.py (layer 3 x stack 2, C=32, R=S=16).  The CUDA
kernel runs only on a GPU: tests/test_torch_spec_sampler_cuda.py holds it
against the plain version there."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movenet_tpu.config import ModelConfig
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.ops.pallas import ar_sampler as jars
from movenet_tpu.utils.spec_sim import simulate_spec_hits as j_sim

from movenet_tpu_torch.models.convert import load_jax_params
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.ops.cuda import ar_sampler as ars
from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

torch.set_num_threads(1)

SMALL = dict(layer_size=3, stack_size=2, input_channels=32,
             residual_channels=16, skip_channels=16, compute_dtype="float32")


@functools.lru_cache(maxsize=1)
def _trained():
    """The JAX-trained sine fixture, once per process, in both packages."""
    from movenet_tpu.utils.fixtures import sine_wave, train_overfit

    jm, variables, codes = train_overfit(sine_wave())
    tm = load_jax_params(make_wavenet(ModelConfig(**SMALL)), variables)
    return jm, variables, tm.eval(), codes


def _random(global_classes=0, seed=0):
    cfg = ModelConfig(**SMALL, global_classes=global_classes)
    jm = j_make(cfg)
    labels = jnp.zeros((1,), jnp.int32) if global_classes else None
    variables = jm.init(jax.random.PRNGKey(seed),
                        jnp.zeros((1, jm.receptive_fields), jnp.int32),
                        None, labels, method=JWaveNet.init_all)
    return jm, variables, load_jax_params(make_wavenet(cfg), variables)


def _pallas_spec(jm, variables, prompt, n, **kw):
    codes, hits = jars.pallas_generate(
        jm, variables, jnp.asarray(prompt, jnp.int32), n, interpret=True,
        speculative=True, return_stats=True, **kw)
    return np.asarray(codes), int(hits)


@pytest.mark.parametrize("kw", [
    dict(fast=False, spec_order=3, spec_depth=1),
    dict(fast=False, spec_order=2, spec_depth=2),
    dict(fast=True, spec_order=3, spec_depth=1),
    dict(fast=True, spec_order=3, spec_depth=1, temperature=1.0, seed=3),
], ids=["exact-o3-d1", "exact-o2-d2", "fast-o3-d1", "T1-parity-fast-o3-d1"])
def test_spec_plain_matches_pallas_trained(kw):
    jm, variables, tm, codes = _trained()
    rf = jm.receptive_fields
    prompt = codes[None, :rf]
    n = rf + 201          # odd: the final-sample guards are exercised
    kw = dict(dict(temperature=0.0), **kw)
    want, want_hits = _pallas_spec(jm, variables, prompt, n, **kw)
    got, hits = ars.cuda_generate(tm, prompt, n, speculative=True,
                                  return_stats=True, **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(hits) == want_hits
    if kw["temperature"] == 0.0:
        assert want_hits > 0       # the trained fixture commits guesses


def test_spec_plain_global_labels_match_pallas(rng_np):
    jm, variables, tm = _random(global_classes=3, seed=1)
    rf = jm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(1, rf))
    labels = np.asarray([2], np.int32)
    n = rf + 201
    want, want_hits = _pallas_spec(jm, variables, prompt, n,
                                   temperature=0.0,
                                   labels=jnp.asarray(labels))
    got, hits = ars.cuda_generate(tm, prompt, n, labels=labels,
                                  speculative=True, return_stats=True)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(hits) == want_hits


COMBOS = [(o, d, a) for o in (2, 3) for d in (1, 2) for a in (True, False)]


@pytest.mark.parametrize("order,depth,adaptive", COMBOS)
@pytest.mark.parametrize("fast", [False, True])
def test_spec_plain_equals_standard_plain(order, depth, adaptive, fast):
    """Codes equal the standard plain sampler's, and the hit counter
    equals both packages' replays of those codes."""
    jm, _, tm, codes = _trained()
    rf = jm.receptive_fields
    n = rf + 151
    inp = ars.prepare(tm, codes[None, :rf], n, fast=fast, speculative=True)
    want = ars.ar_sampler_plain(inp)
    got, hits = ars.ar_sampler_spec_plain(inp, order, depth, adaptive)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    stream = torch.cat([inp.prompt, got], dim=1)[0].numpy()
    replay = simulate_spec_hits(stream, 32, rf, order, depth, adaptive)
    assert replay == j_sim(stream, 32, rf, order, depth, adaptive)
    assert int(hits) == replay[0]
    assert replay[0] + replay[1] == n - rf


def test_spec_plain_equals_standard_on_random_weights(rng_np):
    _, _, tm = _random(seed=2)
    rf = tm.receptive_fields
    prompt = rng_np.integers(0, 32, size=(1, rf))
    inp = ars.prepare(tm, prompt, rf + 130, temperature=0.8, seed=9,
                      parity_sampling=False, speculative=True, spec_depth=2)
    got, hits = ars.ar_sampler_spec_plain(inp)
    np.testing.assert_array_equal(got.numpy(),
                                  ars.ar_sampler_plain(inp).numpy())
    stream = torch.cat([inp.prompt, got], dim=1)[0].numpy()
    assert int(hits) == simulate_spec_hits(stream, 32, rf, 3, 2)[0]


def test_tables_seeded_as_jax_seeds_them():
    # duplicate transitions (1 -> 2 and 1 -> 3; the pair (1, 2) twice):
    # the last write wins, as in JAX's CPU scatter
    p = np.asarray([1, 2, 1, 3, 1, 2, 0, 1, 2, 5, 5, 5], np.int32)
    t2, t3 = ars.seed_spec_tables(p, 8, pair_table=True)
    pj = jnp.asarray(p)[None]
    j2 = jnp.full((8, 1), -1.0, jnp.float32).at[pj[0, :-1], 0].set(
        pj[0, 1:].astype(jnp.float32))
    j3 = jnp.full((8, 8), -1.0, jnp.float32).at[
        pj[0, :-2], pj[0, 1:-1]].set(pj[0, 2:].astype(jnp.float32))
    np.testing.assert_array_equal(t2, np.asarray(j2)[:, 0].astype(np.int32))
    np.testing.assert_array_equal(t3, np.asarray(j3).astype(np.int32))
    assert t2[1] == 2 and t3[1, 2] == 5 and t2[4] == -1
    assert t2.dtype == t3.dtype == np.int32


def test_wrapper_on_cpu_takes_the_plain_version():
    jm, _, tm, codes = _trained()
    rf = jm.receptive_fields
    inp = ars.prepare(tm, codes[None, :rf], rf + 60, fast=True,
                      speculative=True, spec_order=2, spec_adaptive=False)
    assert (inp.spec_order, inp.spec_depth, inp.spec_adaptive) == \
        (2, 1, False)
    before = dict(ars.launch_counts)
    got, hits = ars.ar_sampler_spec(inp)
    want, want_hits = ars.ar_sampler_spec_plain(inp, 2, 1, False)
    assert ars.launch_counts == before       # no kernel ran
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert hits.dtype == torch.int32 and hits.ndim == 0
    assert int(hits) == int(want_hits)
    codes_only = ars.cuda_generate(tm, codes[None, :rf], rf + 60,
                                   speculative=True)
    assert codes_only.shape == (1, rf + 60)


def _error(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def test_errors_match_jax(rng_np):
    jm, variables, tm = _random()
    rf = jm.receptive_fields
    p1 = rng_np.integers(0, 32, size=(1, rf)).astype(np.int32)
    p2 = rng_np.integers(0, 32, size=(2, rf)).astype(np.int32)
    cases = [
        (p2, dict(speculative=True)),
        (p1, dict(return_stats=True)),
        (p1, dict(speculative=True, spec_order=4)),
        (p1, dict(speculative=True, spec_depth=3)),
    ]
    for prompt, kw in cases:
        want = _error(lambda: jars.pallas_generate(
            jm, variables, jnp.asarray(prompt), rf + 8, temperature=0.0,
            interpret=True, **kw))
        got = _error(lambda: ars.cuda_generate(tm, prompt, rf + 8, **kw))
        assert got == want
    video = torch.zeros(1, 1, 64, 64, 1)
    assert "B=1 decoding without video" in _error(
        lambda: ars.cuda_generate(tm, p1, rf + 8, video=video,
                                  speculative=True))
    inp = ars.prepare(tm, p1, rf + 8)
    assert "speculative=True" in _error(lambda: ars.ar_sampler_spec(inp))


def test_torch_fixture_is_hit_rich():
    """utils/fixtures.train_overfit trains in plain torch (the card's
    hit-rich fixture); on the CPU it must learn the sine well enough that
    the order-3 guesser commits most iterations."""
    from movenet_tpu_torch.utils.fixtures import sine_wave, train_overfit

    model, codes = train_overfit(sine_wave(), steps=150,
                                 generator=torch.Generator().manual_seed(0))
    assert not model.training and codes.dtype == np.int32
    rf = model.receptive_fields
    inp = ars.prepare(model, codes[None, :rf], rf + 200, speculative=True)
    got, hits = ars.ar_sampler_spec_plain(inp)
    np.testing.assert_array_equal(got.numpy(),
                                  ars.ar_sampler_plain(inp).numpy())
    assert int(hits) > 50


def test_large_c_downgrades_to_order_2():
    cfg = ModelConfig(layer_size=2, stack_size=1, input_channels=1025,
                      residual_channels=4, skip_channels=4)
    tm = make_wavenet(cfg, generator=torch.Generator().manual_seed(0))
    rf = tm.receptive_fields
    prompt = np.arange(rf)[None] * 7
    inp = ars.prepare(tm, prompt, rf + 6, speculative=True, spec_order=3)
    assert inp.spec_order == 2 and inp.t3 is None
    assert inp.t2.shape == (1025,) and inp.t2[0] == 7
    got, _ = ars.ar_sampler_spec_plain(inp)
    np.testing.assert_array_equal(got.numpy(),
                                  ars.ar_sampler_plain(inp).numpy())
    with pytest.raises(ValueError, match="pair table"):
        ars.ar_sampler_spec_plain(inp, order=3)
