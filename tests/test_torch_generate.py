"""movenet_tpu_torch generate CLI, sample export and resampler on the CPU,
against the JAX package's (movenet_tpu/generate.py, utils/samples.py,
ops/resample.py) on the same checkpoint and signals; ``--dataset`` on a
video-conditioned checkpoint and a synthetic dataset tree."""

import importlib
import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax
import movenet_tpu.native.loader as j_native
import movenet_tpu.utils.samples as j_samples
from movenet_tpu.config import MeshConfig, ModelConfig, TrainingConfig
from movenet_tpu.data import make_synthetic_dataset
from movenet_tpu.generate import generate_from_checkpoint as j_generate
from movenet_tpu.generate import load_checkpoint_model as j_load
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.ops.resample import _resample_plan as j_plan
from movenet_tpu.ops.resample import resample as j_resample
from movenet_tpu.ops.resample import resample_to_length as j_to_length
from movenet_tpu.train import (create_train_state, make_optimizer,
                               save_checkpoint)
from movenet_tpu.train.loop import Batch

import movenet_tpu_torch.native.loader as t_native
import movenet_tpu_torch.utils.samples as samples
from movenet_tpu_torch import generate
from movenet_tpu_torch.config import TrainingConfig as TTrainingConfig
from movenet_tpu_torch.train.checkpoint import save_params
# the JAX checkpoint and its port twin, built once per module
from test_torch_serve import run_dirs  # noqa: F401

torch.set_num_threads(1)
# the module: ``movenet_tpu_torch.ops`` exports its function ``resample``
# under the same name, as the JAX package's ``ops`` does
t_resample = importlib.import_module("movenet_tpu_torch.ops.resample")


def _pcm(path):
    with wave.open(str(path)) as w:
        frames = w.readframes(w.getnframes())
        return (np.frombuffer(frames, "<i2").astype(np.int64),
                w.getnchannels(), w.getframerate(), w.getnframes())


def _capture(monkeypatch, module):
    """Record the codes each export_samples call of ``module`` gets."""
    seen = []
    real = module.export_samples

    def spy(out_dir, epoch, split, codes, *a, **kw):
        seen.append({k: np.asarray(v).copy() for k, v in codes.items()})
        return real(out_dir, epoch, split, codes, *a, **kw)

    monkeypatch.setattr(module, "export_samples", spy)
    return seen


@pytest.mark.parametrize("temperature,batch", [(0.0, 1), (1.0, 2)])
def test_generate_matches_jax(run_dirs, tmp_path, monkeypatch,  # noqa: F811
                              temperature, batch):
    j_seen = _capture(monkeypatch, j_samples)
    t_seen = _capture(monkeypatch, samples)
    n = 16 + 60
    kw = dict(n_samples=n, temperature=temperature, batch_size=batch,
              seed=3)
    want = j_generate(run_dirs[0], out_dir=tmp_path / "jax", **kw)
    got = generate.generate_from_checkpoint(
        run_dirs[1], out_dir=tmp_path / "port", device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for kind in ("generated", "prompt"):
        np.testing.assert_array_equal(t_seen[0][kind], j_seen[0][kind])
    assert t_seen[0]["generated"].shape == (batch, n)
    for kind, paths in want.items():
        assert [p.name for p in got[kind]] == [p.name for p in paths]
        for pj, pt in zip(paths, got[kind]):
            a, b = _pcm(pj), _pcm(pt)
            assert a[1:] == b[1:]                 # channels, rate, frames
            # mu-law decode differs from XLA's in the last float32 bits
            assert np.abs(a[0] - b[0]).max() <= 1


def test_cli_writes_wavs(run_dirs, tmp_path, capsys):  # noqa: F811
    n = 16 + 40
    generate.main(["--checkpoint", str(run_dirs[1]), "--n_samples",
                   str(n), "--temperature", "0", "--speculative", "1",
                   "--spec_depth", "2", "--out", str(tmp_path),
                   "--device", "cpu"])
    printed = capsys.readouterr().out.split()
    wavs = [p for p in printed if p.endswith(".wav")]
    assert len(wavs) == 2                      # generated + prompt
    pcm, channels, rate, frames = _pcm(wavs[0])
    assert channels == 2 and frames in (n, 16)
    assert {_pcm(w)[3] for w in wavs} == {n, 16}


@pytest.fixture(scope="module")
def video_run_dirs(tmp_path_factory):
    """A video-conditioned JAX checkpoint with global classes (2 frames
    -> 2000 samples, as tests/test_trainer.py shrinks the geometry), the
    same weights as a port checkpoint, and a synthetic dataset tree whose
    valid split has 4 clips of 1 s at 2 kHz."""
    root = tmp_path_factory.mktemp("video_run")
    mc = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                     residual_channels=16, skip_channels=16,
                     compute_dtype="float32", global_classes=2,
                     max_audio_frames=2000, max_video_frames=2)
    cfg = TrainingConfig(model_config=mc, optimizer="AdamW",
                         learning_rate=1e-3, scheduler=None, batch_size=1,
                         use_video=True, mesh=MeshConfig(data=1, seq=1))
    model = j_make(mc)
    state = create_train_state(
        model, cfg, make_optimizer(cfg, steps_per_epoch=1),
        jax.random.PRNGKey(0),
        Batch(codes=np.zeros((1, 2000), np.int32),
              video=np.zeros((1, 2, 64, 64, 1), np.float32),
              labels=np.zeros((1,), np.int32)))
    # greedy decisions get a margin above float32 summation noise
    params = dict(state.params)
    params["head2"] = dict(params["head2"],
                           kernel=params["head2"]["kernel"] * 10.0)
    save_checkpoint(root, 0, state.replace(params=params))
    cfg.save(root / "config.json")
    _, _, variables, step = j_load(root)
    port = tmp_path_factory.mktemp("video_run_port")
    save_params(port, step, variables["params"],
                TTrainingConfig.load(root / "config.json"))
    ds = tmp_path_factory.mktemp("video_ds")
    make_synthetic_dataset(ds, categories=["breakdancing", "salsa"],
                           clips_per_category=4, splits=("valid",),
                           audio_fps=2000, video_fps=2, duration_s=1.0,
                           frame_hw=(48, 48), seed=3)
    return root, port, ds
@pytest.fixture
def numpy_preprocessing(monkeypatch):
    """Both packages preprocess the clips with numpy (their native
    libraries' video agrees with it to 1e-2 only)."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(t_native, "available", lambda: False)


@pytest.mark.parametrize("temperature,batch", [(0.0, 1), (1.0, 1),
                                               (0.0, 2), (1.0, 2)])
def test_generate_dataset_matches_jax(video_run_dirs, numpy_preprocessing,
                                      tmp_path, monkeypatch, temperature,
                                      batch):
    """--dataset: prompts, video and labels from the valid split; on the
    CPU both packages take their cached sampler, so the codes agree."""
    j_seen = _capture(monkeypatch, j_samples)
    t_seen = _capture(monkeypatch, samples)
    jax_dir, port_dir, ds = video_run_dirs
    n = 16 + 60
    kw = dict(dataset_fp=str(ds), n_samples=n, temperature=temperature,
              batch_size=batch, seed=3)
    want = j_generate(jax_dir, out_dir=tmp_path / "jax", **kw)
    got = generate.generate_from_checkpoint(
        port_dir, out_dir=tmp_path / "port", device="cpu", **kw)
    assert sorted(got) == sorted(want)
    for kind in ("generated", "prompt"):
        np.testing.assert_array_equal(t_seen[0][kind], j_seen[0][kind])
    assert t_seen[0]["generated"].shape == (batch, n)
    for kind, paths in want.items():
        assert [p.name for p in got[kind]] == [p.name for p in paths]
    # the prompts are the first clips' codes, not silence
    batch0 = generate.first_batch(ds, TTrainingConfig.load(
        port_dir / "config.json").model_config, batch, True)
    np.testing.assert_array_equal(t_seen[0]["prompt"],
                                  batch0.codes[:, :16].numpy())
    assert batch0.video.shape == (batch, 2, 64, 64, 1)
    np.testing.assert_array_equal(batch0.labels.numpy(), [0, 0][:batch])


def test_speculative_with_video_takes_the_standard_route(
        video_run_dirs, numpy_preprocessing, tmp_path, monkeypatch,
        capsys):
    """B=1 --speculative 1 with video runs the AR kernel, not the
    speculative one (which refuses video), as the JAX CLI does; on the
    CPU the CLI writes the same codes as without --speculative."""
    cuda = torch.device("cuda")
    assert generate.sampler_route(cuda, 1, True, True) == "kernel"
    assert generate.sampler_route(cuda, 1, True, False) == "speculative"
    assert generate.sampler_route(cuda, 2, True, False) == "kernel"
    assert generate.sampler_route(cuda, 16, False, True) == "cached"
    assert generate.sampler_route(torch.device("cpu"), 1, True, True) \
        == "cached"
    _, port_dir, ds = video_run_dirs
    seen = _capture(monkeypatch, samples)
    n = 16 + 40
    for spec, out in (("1", "spec"), ("0", "plain")):
        generate.main(["--checkpoint", str(port_dir), "--dataset", str(ds),
                       "--n_samples", str(n), "--temperature", "0",
                       "--speculative", spec, "--out", str(tmp_path / out),
                       "--device", "cpu"])
    wavs = [p for p in capsys.readouterr().out.split() if p.endswith(".wav")]
    assert len(wavs) == 4 and {_pcm(w)[3] for w in wavs} == {n, 16}
    np.testing.assert_array_equal(seen[0]["generated"],
                                  seen[1]["generated"])
    with pytest.raises(ValueError, match="must exceed"):
        generate.generate_from_checkpoint(port_dir, n_samples=16,
                                          out_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="fewer than 8 readable"):
        generate.generate_from_checkpoint(port_dir, dataset_fp=str(ds),
                                          batch_size=8, out_dir=tmp_path,
                                          device="cpu")


def test_default_device_needs_cuda(run_dirs, tmp_path,  # noqa: F811
                                   monkeypatch):
    """No device named: the card, never a silent fall back to the CPU."""
    monkeypatch.setattr(generate.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.generate_from_checkpoint(run_dirs[1], out_dir=tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.load_checkpoint_model(run_dirs[1])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        generate.main(["--checkpoint", str(run_dirs[1]), "--out",
                       str(tmp_path)])


@pytest.mark.parametrize("orig,new,length", [
    (16_000, 44_100, 500), (44_100, 16_000, 1200), (3, 5, 97),
    (160_000, 16_000, 4000), (8_000, 8_000, 64)])
def test_resample_matches_jax(orig, new, length, rng_np):
    x = rng_np.standard_normal((2, length)).astype(np.float32)
    want = np.asarray(j_resample(jnp.asarray(x), orig, new))
    got = t_resample.resample(torch.from_numpy(x), orig, new).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    for a, b in zip(t_resample._resample_plan(orig, new, length, 6, 0.99),
                    j_plan(orig, new, length, 6, 0.99)):
        np.testing.assert_array_equal(a, b)


def test_resample_to_length_matches_jax(rng_np):
    x = rng_np.standard_normal(1234).astype(np.float32)
    want = np.asarray(j_to_length(jnp.asarray(x), 2000))
    got = t_resample.resample_to_length(torch.from_numpy(x), 2000).numpy()
    assert got.shape == (2000,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    x64 = torch.from_numpy(x.astype(np.float64))
    assert t_resample.resample(x64, 10, 7).dtype == torch.float64
    with pytest.raises(ValueError, match="positive"):
        t_resample.resample(torch.zeros(8), 0, 5)


def test_export_samples_resampled_matches_jax(tmp_path, rng_np):
    codes = {"generated": rng_np.integers(0, 256, size=(2, 300))}
    want = j_samples.export_samples(tmp_path / "jax", 3, "val", codes, 256,
                                    model_rate=16_000, target_rate=22_050,
                                    mp3=False)
    got = samples.export_samples(tmp_path / "port", 3, "val", codes, 256,
                                 model_rate=16_000, target_rate=22_050,
                                 mp3=False)
    assert [p.name for p in got["generated"]] == \
        [p.name for p in want["generated"]]
    for pj, pt in zip(want["generated"], got["generated"]):
        a, b = _pcm(pj), _pcm(pt)
        assert a[1:] == b[1:] and b[2] == 22_050
        assert np.abs(a[0] - b[0]).max() <= 1
    assert pt.parent == tmp_path / "port" / "epoch_0003" / "val"


def test_encode_mp3_without_ffmpeg(tmp_path, monkeypatch):
    wav = samples.write_wav(tmp_path / "a.wav", np.zeros(10), 16_000,
                            stereo=False)
    assert _pcm(wav)[1:] == (1, 16_000, 10)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert samples.encode_mp3(wav) is None
