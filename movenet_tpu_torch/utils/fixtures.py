"""Tiny overfit-training fixtures: a trained, predictable WaveNet.

The counterpart of ``movenet_tpu.utils.fixtures``: overfit a small model
on a short waveform with Adam on the plain logsumexp NLL of
``WaveNet.train_logits``, in plain torch autograd.  It runs on the
device it is given, from an explicit ``torch.Generator``, so that a
hit-rich model for the speculative sampler can be made on the card
without loading anything.  It does not give the JAX fixture's weights
(other random initial weights, other summation order); the CPU tests
carry the JAX-trained fixture across with ``load_jax_params`` instead.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def train_overfit(wave: np.ndarray, c: int = 32, layer: int = 3,
                  stack: int = 2, r: int = 16, s: int = 16,
                  steps: int = 150, lr: float = 5e-3, device="cpu",
                  generator: torch.Generator = None):
    """Overfit a small WaveNet on ``wave``; returns (model in eval mode on
    ``device``, mu-law codes of ``wave`` as numpy int32).  ``generator``
    (a CPU ``torch.Generator``) draws the initial weights; seed 0 when
    None."""
    from movenet_tpu_torch.config import ModelConfig
    from movenet_tpu_torch.models.wavenet import make_wavenet
    from movenet_tpu_torch.ops.mulaw import mu_law_encode

    cfg = ModelConfig(layer_size=layer, stack_size=stack,
                      input_channels=c, residual_channels=r,
                      skip_channels=s, compute_dtype="float32")
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = make_wavenet(cfg, generator=generator).to(device)
    rf = model.receptive_fields
    codes = mu_law_encode(torch.from_numpy(np.asarray(wave)), c)
    batch = codes[None].repeat(2, 1).to(device)
    targets = batch[:, rf:].long()
    opt = torch.optim.Adam(model.parameters(), lr=lr)
    model.train()
    for _ in range(steps):
        logits = model.train_logits(batch)
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, targets[..., None])[..., 0]
        loss = nll.mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    return model.eval(), codes.numpy()


def sine_wave() -> np.ndarray:
    """The canonical 400-sample sine fixture the suite trains on."""
    return np.sin(np.arange(0, 60, 0.15))


# the breakdancing training config of the JAX package's bench
# (bench.py _breakdancing_setup): full width, bf16, fused blocks
BREAKDANCING = dict(layer_size=3, stack_size=3, input_channels=64,
                    residual_channels=64, skip_channels=64,
                    compute_dtype="bfloat16", max_audio_frames=160_000,
                    max_video_frames=160)


# the flagship widths at the same clip format (chip_smoke's flagship
# trainer CLI: layer 10 x stack 3, C=256, R=S=64, video)
FLAGSHIP_TRAIN = dict(BREAKDANCING, layer_size=10, input_channels=256)

# the breakdancing config at R = S = 128 (scripts/probe_r128_mfu.py: the
# JAX package's tensor-core-filling geometry), trained through the wide
# save kernels
PROBE_R128 = dict(BREAKDANCING, residual_channels=128, skip_channels=128)


def random_batch(mc, rows: int, use_video: bool = True, seed: int = 0,
                 device="cuda"):
    """A Batch of ``rows`` random clips at ``mc``'s format (a
    ModelConfig): ``max_audio_frames`` codes below ``input_channels`` and,
    with ``use_video``, ``max_video_frames`` frames of 64x64, from
    ``seed``, on ``device``."""
    from movenet_tpu_torch.train import Batch

    rng = np.random.default_rng(seed)
    codes = torch.from_numpy(rng.integers(
        0, mc.input_channels, size=(rows, mc.max_audio_frames))).int()
    video = torch.from_numpy(rng.standard_normal(
        (rows, mc.max_video_frames, 64, 64, 1)).astype(np.float32)) \
        if use_video else None
    return Batch(codes=codes, video=video).to(device)


EXPERIMENTS = Path(__file__).resolve().parents[2] / "experiments" / "torch"


def script_flags(name: str) -> list:
    """The trainer flags of ``experiments/torch/<name>.sh``, without the
    dataset and "$@"."""
    import shlex

    text = (EXPERIMENTS / f"{name}.sh").read_text()
    if "movenet_tpu_torch.train.cli" not in text:
        raise ValueError(f"{name}.sh does not call the port's trainer CLI")
    body = text[text.index(".train.cli"):].split("\n", 1)[1]
    flags = [f for f in shlex.split(body.replace("\\\n", " "))
             if f != "$@"]
    i = flags.index("--dataset")
    return flags[:i] + flags[i + 2:]


def experiment(name: str, device="cuda", extra=()):
    """(config, model) of ``experiments/torch/<name>.sh``'s flags (and
    ``extra``) as the trainer builds them: the context convs only with
    video, the weights from the config's seed, the model on ``device``."""
    from movenet_tpu_torch.config import arg_parser, config_from_args
    from movenet_tpu_torch.models.wavenet import make_wavenet

    cfg = config_from_args(arg_parser().parse_args(
        ["--dataset", "-", *script_flags(name), *extra]))
    mc = cfg.model_config
    mc.use_context = mc.use_context and cfg.use_video
    model = make_wavenet(
        mc, generator=torch.Generator().manual_seed(cfg.seed))
    return cfg, model.to(device)


def breakdancing(seed: int = 0, device="cuda", widths=None):
    """(config, model, batch) of the breakdancing train step: layer 3 x
    stack 3, C=R=S=64, bf16, ``fused_blocks``, AdamW lr 3e-4 without a
    schedule; B=2 clips of T=160000 codes with video (2, 160, 64, 64, 1).
    ``widths`` (a ModelConfig dict such as FLAGSHIP_TRAIN) replaces the
    model's.  Weights and data are random from ``seed``; model and batch
    are on ``device``."""
    from movenet_tpu_torch.config import ModelConfig, TrainingConfig
    from movenet_tpu_torch.models.wavenet import make_wavenet

    mc = ModelConfig(**(widths or BREAKDANCING))
    cfg = TrainingConfig(model_config=mc, optimizer="AdamW",
                         learning_rate=3e-4, scheduler=None, batch_size=2,
                         fused_blocks=True, weight_decay=0.0)
    model = make_wavenet(mc, generator=torch.Generator().manual_seed(seed))
    return cfg, model.to(device), random_batch(mc, 2, seed=seed,
                                               device=device)
