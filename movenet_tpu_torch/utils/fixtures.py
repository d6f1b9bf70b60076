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
