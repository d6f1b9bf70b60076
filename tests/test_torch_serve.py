"""movenet_tpu_torch generation server over TCP on the CPU, against the
JAX server (movenet_tpu/serve.py, scan sampler) on the same weights."""

import base64
import io
import threading
import time
import wave

import jax
import numpy as np
import pytest
import torch

from movenet_tpu.config import MeshConfig, ModelConfig, TrainingConfig
from movenet_tpu.generate import load_checkpoint_model as j_load
from movenet_tpu.models.wavenet import make_wavenet as j_make
from movenet_tpu.serve import GenerationService as JService
from movenet_tpu.train import (create_train_state, make_optimizer,
                               save_checkpoint)
from movenet_tpu.train.loop import Batch

from movenet_tpu_torch.config import TrainingConfig as TTrainingConfig
from movenet_tpu_torch.generate import load_checkpoint_model
from movenet_tpu_torch.ops.cuda import ar_sampler as ars
from movenet_tpu_torch.serve import (GenerationServer, GenerationService,
                                     request)
from movenet_tpu_torch.train.checkpoint import (latest_step,
                                                restore_params, save_params)
from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def run_dirs(tmp_path_factory):
    """A JAX checkpoint + config.json, as tests/test_serve.py builds it,
    and the same weights written as a port checkpoint."""
    root = tmp_path_factory.mktemp("serve_run")
    mc = ModelConfig(layer_size=3, stack_size=2, input_channels=32,
                     residual_channels=16, skip_channels=16,
                     compute_dtype="float32",
                     max_audio_frames=512, max_video_frames=1)
    cfg = TrainingConfig(model_config=mc, optimizer="AdamW",
                         learning_rate=1e-3, scheduler=None,
                         batch_size=1, use_video=False,
                         mesh=MeshConfig(data=1, seq=1))
    model = j_make(mc)
    state = create_train_state(
        model, cfg, make_optimizer(cfg, steps_per_epoch=1),
        jax.random.PRNGKey(0),
        Batch(codes=np.zeros((1, model.receptive_fields + 1), np.int32),
              video=None))
    save_checkpoint(root, 0, state)
    cfg.save(root / "config.json")
    _, _, variables, step = j_load(root)
    port = tmp_path_factory.mktemp("serve_run_port")
    save_params(port, step, variables["params"],
                TTrainingConfig.load(root / "config.json"))
    return root, port


@pytest.fixture(scope="module")
def jax_service(run_dirs):
    return JService(run_dirs[0], prefer_pallas=False)


@pytest.fixture(scope="module")
def server(run_dirs):
    svc = GenerationService(run_dirs[1], device="cpu")
    srv = GenerationServer(("127.0.0.1", 0), svc)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv
    srv.shutdown()
    srv.server_close()
    t.join(timeout=10)
    assert not t.is_alive()


def _port(server):
    return server.server_address[1]


def test_checkpoint_round_trip(run_dirs, tmp_path):
    params, step = restore_params(run_dirs[1])
    assert step == 0 and latest_step(run_dirs[1]) == 0
    save_params(tmp_path, 7, params)
    again, step = restore_params(tmp_path)
    assert step == 7
    flat = jax.tree_util.tree_leaves_with_path(params)
    flat_again = dict(jax.tree_util.tree_leaves_with_path(again))
    assert len(flat) == len(flat_again)
    for path, leaf in flat:
        np.testing.assert_array_equal(flat_again[path], leaf)
    with pytest.raises(FileNotFoundError):
        restore_params(tmp_path / "empty")


def test_loaded_model_matches_jax_params(run_dirs):
    _, _, variables, _ = j_load(run_dirs[0])
    model, config, step = load_checkpoint_model(run_dirs[1], device="cpu")
    assert config.model_config.layer_size == 3 and step == 0
    assert model.video_encoder is None      # audio-only run
    np.testing.assert_array_equal(
        model.head2.kernel.detach().numpy(),
        np.asarray(variables["params"]["head2"]["kernel"]))


def test_ping_reports_model(server):
    resp = request("127.0.0.1", _port(server), {"op": "ping", "id": 7})
    assert resp["ok"] and resp["id"] == 7
    assert resp["model"]["receptive_fields"] == 16
    assert resp["model"]["input_channels"] == 32
    assert resp["model"]["sampler"] == "scan"
    assert resp["model"]["speculative"] == "off"


def test_greedy_codes_equal_jax_server(server, jax_service):
    n = server.service.rf + 40
    resp = request("127.0.0.1", _port(server),
                   {"id": 1, "n_samples": n, "temperature": 0.0})
    assert "error" not in resp, resp
    codes = np.asarray(resp["codes"])
    assert codes.shape == (1, n)
    np.testing.assert_array_equal(
        codes, jax_service.generate(n, temperature=0.0))
    assert resp["samples_per_sec"] > 0


@pytest.mark.parametrize("parity", [True, False])
def test_sampled_codes_equal_jax_server(run_dirs, server, jax_service,
                                        parity, rng_np):
    rf = server.service.rf
    prompt = rng_np.integers(0, 32, size=(2, rf))
    n = rf + 30
    if parity:
        resp = request("127.0.0.1", _port(server),
                       {"id": 2, "n_samples": n, "temperature": 1.0,
                        "seed": 3, "prompt": prompt.tolist()})
        codes = np.asarray(resp["codes"])
        want = jax_service.generate(n, temperature=1.0, prompt=prompt,
                                    seed=3)
    else:
        svc = GenerationService(run_dirs[1], device="cpu",
                                parity_sampling=False)
        codes = svc.generate(n, temperature=1.0, prompt=prompt, seed=3)
        want = JService(run_dirs[0], prefer_pallas=False,
                        parity_sampling=False).generate(
            n, temperature=1.0, prompt=prompt, seed=3)
    assert codes.shape == (2, n)
    np.testing.assert_array_equal(codes[:, :rf], prompt)
    np.testing.assert_array_equal(codes, want)


def test_short_prompt_left_padded_with_silence(server, jax_service):
    svc = server.service
    resp = request("127.0.0.1", _port(server),
                   {"id": 5, "n_samples": svc.rf + 8,
                    "temperature": 0.0, "prompt": [[1, 2, 3]]})
    codes = np.asarray(resp["codes"])
    assert codes.shape == (1, svc.rf + 8)
    assert svc.silent_code == jax_service.silent_code
    assert (codes[0, : svc.rf - 3] == svc.silent_code).all()
    np.testing.assert_array_equal(codes[0, svc.rf - 3: svc.rf], [1, 2, 3])


def test_long_prompt_keeps_most_recent_codes(server, jax_service, rng_np):
    svc = server.service
    prompt = rng_np.integers(0, 32, size=(1, svc.rf + 9))
    resp = request("127.0.0.1", _port(server),
                   {"id": 6, "n_samples": svc.rf + 12,
                    "temperature": 0.0, "prompt": prompt.tolist()})
    codes = np.asarray(resp["codes"])
    np.testing.assert_array_equal(codes[:, :svc.rf], prompt[:, -svc.rf:])
    np.testing.assert_array_equal(
        codes, jax_service.generate(svc.rf + 12, temperature=0.0,
                                    prompt=prompt))


def test_wav_format(server):
    svc = server.service
    n = svc.rf + 24
    resp = request("127.0.0.1", _port(server),
                   {"id": 3, "n_samples": n, "temperature": 0.0,
                    "format": "wav"})
    assert "codes" not in resp and len(resp["wav_b64"]) == 1
    with wave.open(io.BytesIO(base64.b64decode(resp["wav_b64"][0]))) as w:
        assert w.getnchannels() == 1 and w.getsampwidth() == 2
        assert w.getframerate() == 16_000 and w.getnframes() == n


def test_bad_requests_report_errors_and_keep_serving(server):
    port = _port(server)
    resp = request("127.0.0.1", port, {"id": 9, "n_samples": 4})
    assert "must exceed" in resp["error"] and resp["id"] == 9
    resp = request("127.0.0.1", port, {"id": 10, "n_samples": 40,
                                       "prompt": [[99]]})
    assert "[0, 32)" in resp["error"]
    assert request("127.0.0.1", port, {"op": "ping"})["ok"]


def test_kernel_route_on_cpu_uses_the_plain_version(run_dirs, rng_np):
    svc = GenerationService(run_dirs[1], device="cpu", prefer_kernel=True)
    prompt = rng_np.integers(0, 32, size=(2, svc.rf))
    got = svc.generate(svc.rf + 20, temperature=1.0, prompt=prompt,
                       seed=4)
    want = ars.plain_generate(svc.model, prompt, svc.rf + 20,
                              temperature=1.0, seed=4, fast=True)
    np.testing.assert_array_equal(got, want.numpy())
    # B=3 is not a kernel batch size: the cached sampler serves it
    three = svc.generate(svc.rf + 5, temperature=0.0,
                         prompt=rng_np.integers(0, 32, size=(3, svc.rf)))
    assert three.shape == (3, svc.rf + 5)


def test_speculative_and_missing_cuda_raise(run_dirs, monkeypatch):
    # speculation rides the kernel route only: a scan-sampler service
    # reports it off and never validates it
    svc = GenerationService(run_dirs[1], device="cpu", speculative=True)
    assert svc.info()["speculative"] == "off"
    assert svc.validate_speculative() is False
    assert svc.spec_validated is None
    codes, ratio = svc.generate_with_stats(svc.rf + 4, temperature=0.0)
    assert codes.shape == (1, svc.rf + 4) and ratio is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GenerationService(run_dirs[1], device="cuda")


def _fake_cuda_generate(monkeypatch, calls, fail_orders=()):
    """Record each cuda_generate call's route (None: standard kernel,
    else the speculative order) and fail the given orders."""
    real = ars.cuda_generate

    def fake(model, prompt, n_samples, temperature=0.0, seed=0,
             parity_sampling=True, fast=True, speculative=False,
             spec_order=3, **kw):
        calls.append(spec_order if speculative else None)
        if speculative and spec_order in fail_orders:
            raise RuntimeError(f"simulated order-{spec_order} failure")
        return real(model, prompt, n_samples, temperature=temperature,
                    seed=seed, parity_sampling=parity_sampling, fast=fast,
                    speculative=speculative, spec_order=spec_order, **kw)

    monkeypatch.setattr(ars, "cuda_generate", fake)


def test_speculative_validation_failure_disables_routing(run_dirs,
                                                         monkeypatch):
    """A failing speculative kernel never crashes the server: order 3
    fails, order 2 fails, speculation is off for the server's lifetime
    and the standard kernel serves every request."""
    calls = []
    _fake_cuda_generate(monkeypatch, calls, fail_orders=(2, 3))
    svc = GenerationService(run_dirs[1], device="cpu", prefer_kernel=True,
                            speculative=True)
    assert svc.validate_speculative() is False
    assert calls == [None, 3, 2]          # reference run, then o3, o2
    assert svc.speculative is False
    assert svc.spec_validated is False
    assert svc.info()["speculative"] == "off"
    n = svc.rf + 8
    codes = svc.generate(n, temperature=0.0)
    assert codes.shape == (1, n)
    assert calls[3:] == [None]            # no further spec attempts


def test_speculative_order3_failure_downgrades_to_order2(run_dirs,
                                                         monkeypatch):
    calls = []
    _fake_cuda_generate(monkeypatch, calls, fail_orders=(3,))
    svc = GenerationService(run_dirs[1], device="cpu", prefer_kernel=True,
                            speculative=True)
    assert svc.validate_speculative() is True
    assert calls == [None, 3, 2]          # ref, o3 fails, o2 bit-equal
    assert svc.speculative is True
    assert svc.spec_order == 2
    assert svc.spec_validated is True
    n = svc.rf + 8
    codes = svc.generate(n, temperature=0.0)
    assert codes.shape == (1, n)
    assert calls[3:] == [2]               # routed by o2, no o3 retry
    assert svc.last_spec_commit_ratio is not None
    assert 0.0 <= svc.last_spec_commit_ratio < 1.0


def test_speculative_staging_first_request_standard(run_dirs, monkeypatch):
    """Until validation passes, B=1 greedy requests are served by the
    standard kernel; the first one starts validation in the background
    and a later one rides the validated speculative kernel."""
    calls = []
    _fake_cuda_generate(monkeypatch, calls)
    svc = GenerationService(run_dirs[1], device="cpu", prefer_kernel=True,
                            speculative=True)
    assert svc.spec_validated is None
    assert svc.info()["speculative"] == "pending-validation"
    n = svc.rf + 8
    codes, ratio = svc.generate_with_stats(n, temperature=0.0)
    assert codes.shape == (1, n)
    assert ratio is None                  # served standard
    assert calls[0] is None
    deadline = time.monotonic() + 30
    while svc.spec_validated is None and time.monotonic() < deadline:
        time.sleep(0.05)
    assert svc.spec_validated is True
    codes2, ratio2 = svc.generate_with_stats(n, temperature=0.0)
    assert ratio2 is not None             # now rides speculative
    np.testing.assert_array_equal(codes2, codes)
    assert svc.info()["speculative"] == "active"


@pytest.mark.parametrize("fast", [False, True])
def test_speculative_greedy_request_equals_jax_server(run_dirs, jax_service,
                                                      fast):
    svc = GenerationService(run_dirs[1], device="cpu", prefer_kernel=True,
                            fast=fast)
    assert svc.validate_speculative() is True
    srv = GenerationServer(("127.0.0.1", 0), svc)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        n = svc.rf + 121
        resp = request("127.0.0.1", _port(srv),
                       {"id": 11, "n_samples": n, "temperature": 0.0})
        sampled = request("127.0.0.1", _port(srv),
                          {"id": 12, "n_samples": n, "temperature": 1.0})
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=10)
    assert "error" not in resp, resp
    codes = np.asarray(resp["codes"])
    np.testing.assert_array_equal(codes,
                                  jax_service.generate(n, temperature=0.0))
    hits, _ = simulate_spec_hits(codes[0], 32, svc.rf, order=3)
    assert resp["spec_commit_ratio"] == round(hits / (n - svc.rf), 4)
    assert "spec_commit_ratio" not in sampled    # standard kernel
