"""movenet_tpu_torch generate CLI, sample export and resampler on the CPU,
against the JAX package's (movenet_tpu/generate.py, utils/samples.py,
ops/resample.py) on the same checkpoint and signals."""

import wave

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import movenet_tpu.utils.samples as j_samples
from movenet_tpu.generate import generate_from_checkpoint as j_generate
from movenet_tpu.ops.resample import _resample_plan as j_plan
from movenet_tpu.ops.resample import resample as j_resample
from movenet_tpu.ops.resample import resample_to_length as j_to_length

import movenet_tpu_torch.utils.samples as samples
from movenet_tpu_torch import generate
from movenet_tpu_torch.ops import resample as t_resample
# the JAX checkpoint and its port twin, built once per module
from test_torch_serve import run_dirs  # noqa: F401

torch.set_num_threads(1)


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


def test_dataset_raises(run_dirs, tmp_path):  # noqa: F811
    with pytest.raises(NotImplementedError, match="A.6"):
        generate.generate_from_checkpoint(run_dirs[1], dataset_fp="clips",
                                          out_dir=tmp_path, device="cpu")
    with pytest.raises(ValueError, match="must exceed"):
        generate.generate_from_checkpoint(run_dirs[1], n_samples=16,
                                          out_dir=tmp_path, device="cpu")


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
