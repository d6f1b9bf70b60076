"""The port's checkpoints (train/checkpoint.py) on the CPU: a round trip of
params, optimizer state and step that training continues from exactly;
the legacy per-block parameter tree and saved leaves the model lacks,
which restore params and step and reset the optimizer state, as the JAX
package's CheckpointManager does (tests/test_train.py)."""

import json
import logging

import numpy as np
import pytest
import torch

from movenet_tpu.models.wavenet import block_param_view
from movenet_tpu.train.checkpoint import \
    migrate_legacy_block_params as j_migrate

from movenet_tpu_torch.config import ModelConfig, TrainingConfig
from movenet_tpu_torch.models.convert import flatten_tree, params_to_jax
from movenet_tpu_torch.models.wavenet import make_wavenet
from movenet_tpu_torch.train import (
    Batch,
    CheckpointManager,
    create_train_state,
    latest_step,
    make_train_step,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from movenet_tpu_torch.train.checkpoint import migrate_legacy_block_params

torch.set_num_threads(2)


def _trained(seed=0, steps=2, **mkw):
    kw = dict(layer_size=3, stack_size=1, input_channels=32,
              residual_channels=8, skip_channels=8, compute_dtype="float32",
              use_context=False)
    kw.update(mkw)
    cfg = TrainingConfig(model_config=ModelConfig(**kw), scheduler=None,
                         learning_rate=3e-3, optimizer="AdamW",
                         weight_decay=0.01)
    model = make_wavenet(cfg.model_config,
                         generator=torch.Generator().manual_seed(seed))
    state = create_train_state(model, cfg, device="cpu")
    step = make_train_step(model, cfg)
    codes = torch.from_numpy(np.random.default_rng(0).integers(
        0, 32, size=(2, 64)).astype(np.int32))
    for _ in range(steps):
        state, _ = step(state, Batch(codes=codes))
    return cfg, state, step, codes


def _params(state):
    return flatten_tree(params_to_jax(state.module.state_dict()), sep="/")


def _assert_params_equal(a, b):
    pa, pb = _params(a), _params(b)
    assert set(pa) == set(pb)
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_checkpoint_round_trip(tmp_path):
    cfg, state, step, codes = _trained()
    path = save_checkpoint(tmp_path / "run", 3, state, cfg)
    assert path.name == "3" and latest_step(tmp_path / "run") == 3
    assert json.loads((path / "state.json").read_text()) == {"step": 2}
    assert (tmp_path / "run" / "config.json").is_file()
    # no temporary directories are left behind
    assert sorted(p.name for p in path.parent.iterdir()) == ["3"]

    _, fresh, fresh_step, _ = _trained(seed=9, steps=0)
    restored = restore_checkpoint(tmp_path / "run", fresh)
    assert restored.step == 2
    _assert_params_equal(restored, state)
    want = state.optimizer.state_dict()
    got = restored.optimizer.state_dict()
    assert got["param_groups"] == want["param_groups"]
    for i, s in want["state"].items():
        for k, v in s.items():
            assert torch.equal(got["state"][i][k], v), (i, k)
    # training continues identically from the restored state
    a, ma = step(state, Batch(codes=codes))
    b, mb = fresh_step(restored, Batch(codes=codes))
    assert float(ma["loss"]) == float(mb["loss"]) and a.step == b.step == 3
    _assert_params_equal(a, b)
    # a later save of the same index replaces it whole
    save_checkpoint(tmp_path / "run", 3, a)
    assert CheckpointManager(tmp_path / "run").restore(fresh).step == 3


def test_legacy_checkpoint_migration(tmp_path, caplog):
    cfg, state, _, _ = _trained(use_context=True, global_classes=2)
    params = params_to_jax(state.module.state_dict())
    legacy = {k: v for k, v in params.items() if not k.startswith("blocks_")}
    for i in range(params["blocks_w_cur"].shape[0]):
        legacy[f"block_{i}"] = block_param_view(params, i)
    run = tmp_path / "legacy_run"
    ckpt = save_params(run, 7, legacy)
    (ckpt / "state.json").write_text(json.dumps({"step": 2}))
    torch.save(state.optimizer.state_dict(), ckpt / "optimizer.pt")

    _, fresh, _, _ = _trained(seed=9, steps=0, use_context=True,
                              global_classes=2)
    fresh.optimizer.state[next(fresh.module.parameters())]["junk"] = 1
    with caplog.at_level(logging.WARNING):
        restored = CheckpointManager(run).restore(fresh)
    assert "legacy per-block" in caplog.text and "RESETTING" in caplog.text
    assert restored.step == 2
    _assert_params_equal(restored, state)
    assert len(restored.optimizer.state) == 0
    # the converter is the JAX package's, leaf for leaf
    got = flatten_tree(migrate_legacy_block_params(legacy), sep="/")
    want = flatten_tree(j_migrate(legacy), sep="/")
    assert set(got) == set(want) and "block_0/w_cur" not in got
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))


def test_checkpoint_with_extra_ctx_leaves_restores(tmp_path, caplog):
    cfg, state, _, _ = _trained()
    params = params_to_jax(state.module.state_dict())
    assert "blocks_ctx_kernel" not in params
    n, r = params["blocks_w_cur"].shape[:2]
    params["blocks_ctx_kernel"] = np.ones((n, r, 2 * r), np.float32)
    params["blocks_ctx_bias"] = np.zeros((n, 2 * r), np.float32)
    ckpt = save_params(tmp_path / "run", 4, params)
    (ckpt / "state.json").write_text(json.dumps({"step": 2}))
    torch.save(state.optimizer.state_dict(), ckpt / "optimizer.pt")
    _, fresh, _, _ = _trained(seed=9, steps=1)
    assert len(fresh.optimizer.state) > 0
    with caplog.at_level(logging.WARNING):
        restored = CheckpointManager(tmp_path / "run").restore(fresh)
    assert "blocks_ctx_bias, blocks_ctx_kernel" in caplog.text
    assert restored.step == 2 and len(restored.optimizer.state) == 0
    _assert_params_equal(restored, state)
    # a checkpoint that lacks leaves of the model does not restore
    del params["blocks_ctx_kernel"], params["blocks_ctx_bias"]
    del params["head2"]
    save_params(tmp_path / "run", 5, params)
    with pytest.raises(ValueError, match="head2"):
        CheckpointManager(tmp_path / "run").restore(fresh)
