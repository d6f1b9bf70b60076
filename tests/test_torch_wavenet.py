"""movenet_tpu_torch WaveNet and parameter converter against the JAX
model on the CPU, at the small size of tests/test_pallas_sampler.py
(layer 3 x stack 2, C=32, R=S=16), float32."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movenet_tpu.config import ModelConfig
from movenet_tpu.models.wavenet import VideoEncoder as JVideoEncoder
from movenet_tpu.models.wavenet import WaveNet as JWaveNet
from movenet_tpu.models.wavenet import make_wavenet as j_make

from movenet_tpu_torch.models.convert import (load_jax_params,
                                              params_from_jax,
                                              params_to_jax)
from movenet_tpu_torch.models.wavenet import VideoEncoder, make_wavenet

torch.set_num_threads(1)
ATOL = 1e-5   # XLA's CPU tanh is a rational approximation


def _cfg(case):
    kw = dict(layer_size=3, stack_size=2, input_channels=32,
              residual_channels=16, skip_channels=16,
              compute_dtype="float32")
    if case == "video":
        kw.update(max_audio_frames=1000, max_video_frames=1)
    if case == "global":
        kw.update(global_classes=3)
    return ModelConfig(**kw)


def _build(case, rng):
    cfg = _cfg(case)
    jm = j_make(cfg)
    t = 1000 if case == "video" else jm.receptive_fields + 40
    audio = rng.integers(0, 32, size=(2, t)).astype(np.int32)
    video = rng.standard_normal((2, 1, 64, 64, 1)).astype(np.float32) \
        if case == "video" else None
    labels = np.asarray([0, 2], np.int32) if case == "global" else None
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(audio),
                        None if video is None else jnp.asarray(video),
                        None if labels is None else jnp.asarray(labels),
                        method=JWaveNet.init_all)
    tm = load_jax_params(make_wavenet(cfg), variables)
    return cfg, jm, variables, tm, audio, video, labels


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def test_converter_round_trip_exact(rng_np):
    cfg = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                      residual_channels=16, skip_channels=16,
                      compute_dtype="float32", max_audio_frames=1000,
                      max_video_frames=1, global_classes=3)
    jm = j_make(cfg)
    audio = jnp.zeros((1, 1000), jnp.int32)
    video = jnp.zeros((1, 1, 64, 64, 1), jnp.float32)
    variables = jm.init(jax.random.PRNGKey(1), audio, video,
                        jnp.zeros((1,), jnp.int32), method=JWaveNet.init_all)
    sd = params_from_jax(variables)
    for name in ("head1.kernel", "global_embed.embedding",
                 "video_encoder.frame_proj.kernel",
                 "video_encoder.upsample_2.bias", "blocks_ctx_kernel"):
        assert name in sd
    tm = load_jax_params(make_wavenet(cfg), variables)
    assert set(tm.state_dict()) == set(sd)
    back = params_to_jax(tm.state_dict())
    flat_j = jax.tree_util.tree_leaves_with_path(variables["params"])
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        got = flat_b[path]
        assert got.dtype == np.asarray(leaf).dtype
        np.testing.assert_array_equal(got, np.asarray(leaf))


def test_converter_drops_modules_the_tree_lacks():
    cfg = _cfg("audio")
    jm = j_make(cfg)
    variables = jm.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, jm.receptive_fields), jnp.int32))
    assert "video_encoder" not in variables["params"]
    tm = load_jax_params(make_wavenet(cfg), variables)
    assert tm.video_encoder is None
    with pytest.raises(ValueError):
        tm.encode_video(torch.zeros(1, 1, 64, 64, 1))


@pytest.mark.parametrize("case", ["audio", "video", "global"])
def test_forward_matches_jax(case, rng_np):
    cfg, jm, variables, tm, audio, video, labels = _build(case, rng_np)
    kw = {}
    if video is not None:
        kw["video"] = jnp.asarray(video)
    if labels is not None:
        kw["global_features"] = jnp.asarray(labels)
    for unnorm, remove_last in ((True, True), (False, False)):
        want = np.asarray(jm.apply(variables, jnp.asarray(audio),
                                   output_unnormalized=unnorm,
                                   remove_last=remove_last, **kw))
        with torch.no_grad():
            got = tm(_t(audio), _t(video), _t(labels),
                     output_unnormalized=unnorm,
                     remove_last=remove_last).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["audio", "video", "global"])
def test_train_logits_matches_jax(case, rng_np):
    cfg, jm, variables, tm, audio, video, labels = _build(case, rng_np)
    want = np.asarray(jm.apply(
        variables, jnp.asarray(audio),
        None if video is None else jnp.asarray(video),
        None if labels is None else jnp.asarray(labels),
        method=JWaveNet.train_logits))
    with torch.no_grad():
        got = tm.train_logits(_t(audio), _t(video), _t(labels)).numpy()
    assert got.shape == want.shape == (2, audio.shape[1]
                                       - jm.receptive_fields, 32)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", ["audio", "video", "global"])
def test_prompt_state_matches_jax(case, rng_np):
    cfg, jm, variables, tm, audio, video, labels = _build(case, rng_np)
    rf = jm.receptive_fields
    prompt = audio[:, :rf + 5]   # T not a multiple of the dilations
    ctx_j = ctx_t = gv_j = gv_t = None
    if video is not None:
        ctx_j = jm.apply(variables, jnp.asarray(video),
                         method=JWaveNet.encode_video)[:, :prompt.shape[1]]
        with torch.no_grad():
            ctx_t = tm.encode_video(_t(video))[:, :prompt.shape[1]]
        np.testing.assert_allclose(ctx_t.numpy(), np.asarray(ctx_j),
                                   atol=ATOL, rtol=0)
    if labels is not None:
        gv_j = jm.apply(variables, jnp.asarray(labels),
                        method=JWaveNet.embed_global)
        gv_t = tm.embed_global(_t(labels))
        np.testing.assert_array_equal(gv_t.detach().numpy(),
                                      np.asarray(gv_j))
    bufs_j, last_j = jm.apply(variables, jnp.asarray(prompt), ctx_j, gv_j,
                              method=JWaveNet.prompt_state)
    with torch.no_grad():
        bufs_t, last_t = tm.prompt_state(_t(prompt), ctx_t, gv_t)
    assert len(bufs_t) == len(bufs_j)
    for bt, bj in zip(bufs_t, bufs_j):
        assert bt.shape == bj.shape
        np.testing.assert_allclose(bt.numpy(), np.asarray(bj), atol=ATOL,
                                   rtol=0)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j),
                               atol=ATOL, rtol=0)


def test_float_mass_input_matches_codes(rng_np):
    cfg, jm, variables, tm, audio, _, _ = _build("audio", rng_np)
    mass = np.eye(32, dtype=np.float32)[audio].transpose(0, 2, 1)
    want = np.asarray(jm.apply(variables, jnp.asarray(mass)))
    with torch.no_grad():
        got = tm(torch.from_numpy(mass)).numpy()
        from_codes = tm(_t(audio)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, from_codes, atol=1e-6, rtol=0)


def test_video_encoder_transposed_conv_stage(rng_np):
    """A schedule whose stage is not the dense stride-10 case (1 -> 5
    frames: kernel 5, stride 10) runs the transposed convolution."""
    je = JVideoEncoder(residual_channels=4, in_frames=1, out_frames=5,
                       frame_hw=(4, 4))
    video = rng_np.standard_normal((2, 1, 4, 4, 1)).astype(np.float32)
    variables = je.init(jax.random.PRNGKey(0), jnp.asarray(video))
    assert "upsample_0_kernel" in variables["params"]
    want = np.asarray(je.apply(variables, jnp.asarray(video)))
    te = VideoEncoder(4, in_frames=1, out_frames=5, frame_hw=(4, 4))
    te.load_state_dict(params_from_jax(variables))
    with torch.no_grad():
        got = te(torch.from_numpy(video)).numpy()
    assert got.shape == want.shape == (2, 5, 4)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_random_init_is_seeded_and_shaped():
    cfg = ModelConfig(layer_size=10, stack_size=3, input_channels=256,
                      residual_channels=64, skip_channels=64)
    a = make_wavenet(cfg, generator=torch.Generator().manual_seed(5))
    b = make_wavenet(cfg, generator=torch.Generator().manual_seed(5))
    assert a.receptive_fields == 3072
    for (name, pa), pb in zip(a.state_dict().items(),
                              b.state_dict().values()):
        assert torch.equal(pa, pb), name
    assert a.blocks_w_cur.shape == (30, 64, 128)
    assert a.head1.kernel.shape == (64, 256)
    assert a.head2.kernel.shape == (256, 256)
    std = float(a.blocks_w_cur.detach().std())
    assert 0.5 / 8 < std < 2.0 / 8          # lecun: about 1/sqrt(64)
