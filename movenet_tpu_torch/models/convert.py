"""Parameters between the JAX package's flax tree and the port's modules.

A flax parameter tree is a nested dict of arrays (``head1/kernel``,
``video_encoder/frame_proj/bias``, ``blocks_w_cur`` ...).  The port's
``state_dict`` uses the same names joined by dots, with the same shapes
and the same (in, out) layout, so the conversion only renames and the
round trip is exact.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from movenet_tpu_torch.models.wavenet import WaveNet

# submodules that flax creates only when they are called, so a tree may
# lack them (no video at init, no labels at init)
_OPTIONAL_MODULES = ("video_encoder", "global_embed")


def flatten_tree(tree: Mapping, sep: str = ".") -> Dict[str, np.ndarray]:
    """Nested dict of arrays -> {path joined by ``sep``: array}."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update({f"{k}{sep}{name}": leaf
                        for name, leaf in flatten_tree(v, sep).items()})
        else:
            out[k] = np.asarray(v)
    return out


def unflatten_tree(flat: Mapping, sep: str = ".") -> dict:
    """{path joined by ``sep``: leaf} -> nested dict."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *path, leaf = name.split(sep)
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """flax params (or ``{"params": ...}`` variables) -> state_dict."""
    if "params" in tree and isinstance(tree["params"], Mapping):
        tree = tree["params"]
    return {k: torch.from_numpy(np.array(v))
            for k, v in flatten_tree(tree).items()}


def params_to_jax(state_dict: Mapping[str, torch.Tensor]) -> dict:
    """state_dict -> nested flax params tree of numpy arrays."""
    return unflatten_tree({k: v.detach().cpu().numpy()
                           for k, v in state_dict.items()})


def load_jax_params(model: WaveNet, tree: Mapping) -> WaveNet:
    """Load a flax tree into ``model`` in place.

    A submodule the tree lacks entirely (``video_encoder``,
    ``global_embed``) is removed from the model, as it has no weights;
    every other name must match exactly."""
    sd = params_from_jax(tree)
    for name in _OPTIONAL_MODULES:
        if getattr(model, name) is not None and \
                not any(k.startswith(name + ".") for k in sd):
            setattr(model, name, None)
    model.load_state_dict(sd, strict=True)
    return model
