"""movenet_tpu_torch data layer (movenet_tpu_torch/data, native/) against
the JAX package's (movenet_tpu/data, native/) on the CPU, at the sizes of
tests/test_data.py (4 kHz audio, 16 fps, 1 s clips, 48x48 frames).

Both packages preprocess through their native C++ library when it is
built; the comparisons of the numpy routes switch both libraries off
(``available`` -> False), and the port's library is built here and held
against the port's numpy route on its own."""

import os
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

import movenet_tpu.data.preprocess as j_pp
import movenet_tpu.native.loader as j_native
from movenet_tpu.data import get_dataloader as j_get_dataloader
from movenet_tpu.data import kinetics_index as j_index
from movenet_tpu.data import make_synthetic_dataset as j_make_dataset
from movenet_tpu.data.dataset import decode_clip as j_decode
from movenet_tpu.data.video import decode_media_file as j_decode_media

import movenet_tpu_torch.data.preprocess as pp
import movenet_tpu_torch.native.loader as native
from movenet_tpu_torch.data import (DataLoader, get_dataloader,
                                    kinetics_index, make_synthetic_dataset)
from movenet_tpu_torch.data.dataset import decode_clip
from movenet_tpu_torch.data.video import decode_media_file
from movenet_tpu_torch.native import build as native_build
from movenet_tpu_torch.train.loop import Batch

torch.set_num_threads(1)

GEOMETRY = dict(categories=["breakdancing", "salsa"], clips_per_category=3,
                audio_fps=4000, video_fps=16, duration_s=1.0,
                frame_hw=(48, 48), seed=7)


@pytest.fixture(scope="module")
def dataset_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_kinetics_synth")
    make_synthetic_dataset(root, **GEOMETRY)
    return root


@pytest.fixture
def numpy_routes(monkeypatch):
    """Both packages preprocess with numpy, whatever is built."""
    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)


@pytest.fixture(scope="module")
def built_native():
    """The port's native library, built here as tests/test_native.py
    builds the JAX package's."""
    try:
        native_build.build()
    except (OSError, RuntimeError) as e:
        pytest.skip(f"native build unavailable: {e}")
    assert native.available()
    return native


def _entries(idx):
    return [(e.context, e.filepath) for e in idx.entries]


# ----------------------------------------------------------------- index
def test_synthetic_dataset_arrays_equal(dataset_root, tmp_path):
    j_make_dataset(tmp_path / "jax", **GEOMETRY)
    files = sorted(p.relative_to(dataset_root)
                   for p in dataset_root.rglob("*.npz"))
    assert len(files) == 2 * 3 + 2 * 1
    for rel in files:
        with np.load(dataset_root / rel) as a, \
                np.load(tmp_path / "jax" / rel) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("train", [True, False])
def test_kinetics_index_matches_jax(dataset_root, train):
    d = dataset_root / "train" / "breakdancing"
    (d / "clip_x_raw.npz").write_bytes(b"junk")     # skipped (_raw)
    (d / ".hidden.npz").write_bytes(b"junk")        # skipped (dotfile)
    (d / "notes.txt").write_text("not a clip")      # skipped (suffix)
    try:
        got, want = kinetics_index(dataset_root, train), \
            j_index(dataset_root, train)
        assert _entries(got) == _entries(want)
    finally:
        for name in ("clip_x_raw.npz", ".hidden.npz", "notes.txt"):
            (d / name).unlink()
    assert got.split == want.split and len(got) == len(want)
    assert got.contexts == want.contexts == ["breakdancing", "salsa"]
    assert got.context_to_id == want.context_to_id
    assert got.class_balance == want.class_balance
    for i in range(3):
        assert _entries(got.shard(i, 3)) == _entries(want.shard(i, 3))
    assert _entries(got.shuffled(5)) == _entries(want.shuffled(5))


def test_decode_npz_matches_jax(dataset_root):
    fp = str(dataset_root / "valid" / "salsa" / "clip_000.npz")
    got, want = decode_clip(fp), j_decode(fp)
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.audio, want.audio)
    assert got.info == want.info


# ------------------------------------------------------------ preprocess
@pytest.mark.parametrize("shape,target", [((3937,), 1600), ((2, 3937), 1600),
                                          ((4000,), 4000), ((2, 900), 1600)])
def test_preprocess_audio_equals_jax_numpy_route(numpy_routes, rng_np,
                                                 shape, target):
    audio = rng_np.standard_normal(shape).astype(np.float32)
    got = pp.preprocess_audio(audio, 256, target_frames=target)
    want = j_pp.preprocess_audio(audio, 256, target_frames=target)
    assert got.dtype == np.int32 and got.shape == (target,)
    np.testing.assert_array_equal(got, want)
    silent = np.zeros(500, np.float32)      # the all-zero guard
    np.testing.assert_array_equal(
        pp.preprocess_audio(silent, 64, target_frames=300),
        j_pp.preprocess_audio(silent, 64, target_frames=300))


@pytest.mark.parametrize("shape,num_frames", [((33, 48, 56, 3), 16),
                                              ((20, 64, 64, 3), 8),
                                              ((5, 64, 64, 1), 4),
                                              ((7, 30, 40, 3), 16)])
def test_preprocess_video_equals_jax_numpy_route(numpy_routes, rng_np,
                                                 shape, num_frames):
    video = rng_np.integers(0, 256, shape).astype(np.uint8)
    got = pp.preprocess_video(video, num_frames=num_frames)
    want = j_pp.preprocess_video(video, num_frames=num_frames)
    assert got.shape == (num_frames, 64, 64, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_numpy_helpers_equal_jax(rng_np):
    x = np.tanh(rng_np.standard_normal(400)).astype(np.float32)
    np.testing.assert_array_equal(pp.mu_law_encode_np(x, 256),
                                  j_pp.mu_law_encode_np(x, 256))
    q = rng_np.integers(0, 256, 100)
    np.testing.assert_array_equal(pp.mu_law_decode_np(q, 256),
                                  j_pp.mu_law_decode_np(q, 256))
    np.testing.assert_array_equal(pp.normalize_audio_np(x),
                                  j_pp.normalize_audio_np(x))
    np.testing.assert_array_equal(pp.resample_np(x, 400, 160),
                                  j_pp.resample_np(x, 400, 160))
    t = np.arange(10)
    for k in (4, 20, 1):
        np.testing.assert_array_equal(pp.uniform_temporal_subsample(t, k),
                                      j_pp.uniform_temporal_subsample(t, k))
    with pytest.raises(ValueError, match="expected"):
        pp.preprocess_video(np.zeros((2, 8, 8), np.uint8))


# ---------------------------------------------------------------- native
def test_native_audio_codes_match_numpy(built_native, rng_np, monkeypatch):
    audio = rng_np.standard_normal((2, 3937)).astype(np.float32)
    got = built_native.preprocess_audio(audio, 256, True, 1600)
    monkeypatch.setattr(native, "available", lambda: False)
    # identical integer codes (the same double-precision filter weights)
    np.testing.assert_array_equal(
        got, pp.preprocess_audio(audio, 256, target_frames=1600))
    silent = np.zeros((1, 1000), np.float32)
    np.testing.assert_array_equal(
        built_native.preprocess_audio(silent, 64, True, 500),
        pp.mu_law_encode_np(np.zeros(500), 64))


def test_native_video_matches_numpy(built_native, rng_np, monkeypatch):
    video = rng_np.integers(0, 255, (33, 48, 56, 3)).astype(np.uint8)
    got = built_native.preprocess_video(video, 16, (64, 64))
    monkeypatch.setattr(native, "available", lambda: False)
    want = pp.preprocess_video(video, num_frames=16)
    assert got.shape == want.shape == (16, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=1e-2)


def test_native_dispatch_used_by_preprocess(built_native, rng_np):
    video = rng_np.integers(0, 255, (20, 32, 32, 3)).astype(np.uint8)
    audio = rng_np.standard_normal(4410).astype(np.float32)
    np.testing.assert_array_equal(
        pp.preprocess_video(video, num_frames=8),
        built_native.preprocess_video(video, 8, (64, 64)))
    np.testing.assert_array_equal(
        pp.preprocess_audio(audio, 128, target_frames=800),
        built_native.preprocess_audio(audio, 128, True, 800))
    assert native_build.target().parent.name == "native"
    assert native_build.target().parent.parent.name == "movenet_tpu_torch"


# ---------------------------------------------------------------- loader
def _assert_batches_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert isinstance(g, Batch)
        for name in ("codes", "video", "labels", "codes_pack"):
            a, b = getattr(g, name), getattr(w, name)
            assert (a is None) == (b is None), name
            if a is None:
                continue
            assert isinstance(a, torch.Tensor) and a.device.type == "cpu"
            b = np.asarray(b)
            assert a.dtype == torch.from_numpy(b).dtype, name
            np.testing.assert_array_equal(a.numpy(), b, err_msg=name)


LOADER_CASES = {
    "video shuffled": dict(batch_size=2, use_video=True, num_workers=2,
                           shuffle=True, seed=1, max_audio_frames=1600),
    "audio only accumulation": dict(batch_size=2, use_video=False,
                                    num_workers=1, accumulation_steps=3,
                                    shuffle=False, max_audio_frames=800),
    "synchronized crop": dict(batch_size=2, use_video=True, num_workers=1,
                              batch_subsample_frac=0.25, shuffle=False,
                              max_audio_frames=1600),
    "reference crop": dict(batch_size=2, use_video=True, num_workers=1,
                           batch_subsample_frac=0.5,
                           synchronized_crop=False, shuffle=True, seed=3,
                           max_audio_frames=1600),
    "host pack": dict(batch_size=2, use_video=False, num_workers=2,
                      shuffle=False, max_audio_frames=4000, host_pack=True),
    "host pack accumulation": dict(batch_size=1, use_video=True,
                                   num_workers=2, accumulation_steps=2,
                                   shuffle=False, max_audio_frames=1600,
                                   host_pack=True),
    "valid split": dict(batch_size=2, use_video=True, num_workers=2,
                        shuffle=False, train=False, max_audio_frames=1600),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_dataloader_epoch_matches_jax(numpy_routes, dataset_root, case):
    kw = {"input_channels": 64, "max_video_frames": 16, "train": True,
          **LOADER_CASES[case]}
    got = get_dataloader(dataset_root, **kw)
    want = j_get_dataloader(dataset_root, **kw)
    assert len(got) == len(want)
    for epoch in (0, 1):
        _assert_batches_equal(list(got.epoch(epoch)),
                              list(want.epoch(epoch)))


def test_dataloader_substitutes_unreadable_clips(numpy_routes, dataset_root,
                                                 tmp_path):
    root = tmp_path / "ds"
    shutil.copytree(dataset_root, root)
    (root / "train" / "salsa" / "clip_bad.npz").write_bytes(b"not a zip")
    kw = dict(input_channels=64, batch_size=2, train=True, use_video=False,
              num_workers=1, shuffle=False, max_audio_frames=400,
              max_video_frames=16)
    got = list(get_dataloader(root, **kw).epoch(0))
    _assert_batches_equal(got, list(j_get_dataloader(root, **kw).epoch(0)))
    assert len(got) == 3 and got[0].codes.shape == (2, 400)


def test_meta_batches_match_jax(numpy_routes, dataset_root):
    """The raw Example groups (filepath per row) that sample export
    reads."""
    kw = dict(input_channels=64, batch_size=2, train=False, use_video=True,
              max_audio_frames=800, max_video_frames=16)
    got = list(get_dataloader(dataset_root, **kw).meta_batches())
    want = list(j_get_dataloader(dataset_root, **kw).meta_batches())
    assert len(got) == len(want) == 1
    for g, w in zip(got[0], want[0]):
        assert (g.context, g.filepath, g.label) == \
            (w.context, w.filepath, w.label)
        np.testing.assert_array_equal(g.codes, w.codes)
        np.testing.assert_array_equal(g.video, w.video)


def test_dataloader_options(dataset_root):
    idx = kinetics_index(dataset_root, train=True)
    with pytest.raises(ValueError, match="auto|on|off"):
        DataLoader(idx, input_channels=64, batch_size=2,
                   native_pipeline="sometimes")
    loader = DataLoader(idx, input_channels=64, batch_size=2)
    assert not loader._native_pipe_usable()          # .npz clips
    with pytest.raises(RuntimeError, match="not usable"):
        DataLoader(idx, input_channels=64, batch_size=2,
                   native_pipeline="on")._native_pipe_usable()
    with pytest.raises(ValueError, match="empty dataset"):
        DataLoader(idx.shard(7, 8), input_channels=64, batch_size=2)
    assert loader.steps_per_epoch() == len(loader) == 3


def test_curation_cli_matches_jax(dataset_root, tmp_path):
    import yaml

    from movenet_tpu.data.curate import main as j_main
    from movenet_tpu_torch.data.curate import main

    meta = {"train": {"breakdancing": ["clip_000", "clip_001"]},
            "valid": {"salsa": ["clip_000", "missing"]}}
    meta_fp = tmp_path / "meta.yaml"
    meta_fp.write_text(yaml.safe_dump(meta))
    for fn, out in ((main, tmp_path / "port"), (j_main, tmp_path / "jax")):
        fn([str(dataset_root), str(out), "--curation-metadata-fp",
            str(meta_fp)])
    for train in (True, False):
        got = [(c, os.path.relpath(f, tmp_path / "port")) for c, f in
               _entries(kinetics_index(tmp_path / "port", train))]
        want = [(c, os.path.relpath(f, tmp_path / "jax")) for c, f in
                _entries(j_index(tmp_path / "jax", train))]
        assert got == want and got


def test_bench_loader_cli(dataset_root, tmp_path, capsys):
    from movenet_tpu_torch.data.bench_loader import main

    stats = main([str(dataset_root), "--num-workers", "1", "--batch-size",
                  "2", "--max-audio-frames", "400", "--out",
                  str(tmp_path / "time.txt")])
    assert stats["batches"] == 3 and stats["examples"] == 6
    assert (tmp_path / "time.txt").read_text().startswith("time taken")


# --------------------------------------------------------- media decoding
FFPROBE_STUB = """#!{py}
import json, sys
args = sys.argv[1:]
if "-show_entries" in args:     # the C++ pipeline's channels query
    print(2)
else:                           # the Python path's JSON probe
    print(json.dumps({{"streams": [
        {{"codec_type": "video", "width": 96, "height": 72,
          "avg_frame_rate": "10/1"}},
        {{"codec_type": "audio", "sample_rate": "8000", "channels": 2}},
    ]}}))
"""

FFMPEG_STUB = """#!{py}
import hashlib, sys
import numpy as np

args = sys.argv[1:]
fp = args[args.index("-i") + 1]
rng = np.random.default_rng(int(hashlib.md5(fp.encode()).hexdigest()[:6], 16))
out = sys.stdout.buffer
if "f32le" in args:
    out.write((rng.standard_normal(2 * 100).astype(np.float32) * 0.3)
              .tobytes())
elif "gray" in args:
    assert args[args.index("-vf") + 1].startswith("scale=64:64"), args
    for i in range(5):
        out.write(rng.integers(0, 255, (64, 64), dtype=np.uint8).tobytes())
elif "rgb24" in args:
    for i in range(5):
        out.write(np.full((72, 96, 3), i, dtype=np.uint8).tobytes())
else:
    sys.exit(2)
"""


@pytest.fixture
def media_tree(tmp_path, monkeypatch):
    """Stub ffmpeg/ffprobe binaries (deterministic rawvideo/PCM per file,
    as tests/test_native_pipeline.py makes them) and a tree of .mp4
    names."""
    bindir = tmp_path / "bin"
    bindir.mkdir()
    for name, body in (("ffprobe", FFPROBE_STUB), ("ffmpeg", FFMPEG_STUB)):
        p = bindir / name
        p.write_text(body.format(py=sys.executable))
        p.chmod(p.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    root = tmp_path / "data"
    for cat, names in (("dance_a", ["c0", "c1"]), ("dance_b", ["c2", "c3"])):
        d = root / "train" / cat
        d.mkdir(parents=True)
        for n in names:
            (d / f"{n}.mp4").write_bytes(b"fake")
    return root


@pytest.mark.parametrize("scale_hw", [(64, 64), None])
def test_media_decode_matches_jax(media_tree, scale_hw):
    fp = media_tree / "train" / "dance_a" / "c0.mp4"
    got = decode_media_file(fp, scale_hw=scale_hw)
    want = j_decode_media(fp, scale_hw=scale_hw)
    np.testing.assert_array_equal(got.video, want.video)
    np.testing.assert_array_equal(got.audio, want.audio)
    assert got.info == want.info
    assert got.audio.shape == (2, 100)
    assert got.video.shape == ((5, 64, 64, 1) if scale_hw else (5, 72, 96, 3))


def test_media_decode_error_without_ffmpeg(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    with pytest.raises(RuntimeError, match="no ffmpeg"):
        decode_media_file(tmp_path / "clip.mp4")


def test_native_pipeline_matches_python_path(built_native, media_tree):
    index = kinetics_index(media_tree, train=True)

    def load(mode):
        loader = DataLoader(index, input_channels=64, batch_size=2,
                            use_video=True, num_workers=2, shuffle=False,
                            max_audio_frames=1000, max_video_frames=4,
                            native_pipeline=mode)
        return list(loader.epoch(0))

    native_batches = load("on")
    _assert_batches_equal(native_batches, load("off"))
    assert len(native_batches) == 2
    assert native_batches[0].video.shape == (2, 4, 64, 64, 1)
