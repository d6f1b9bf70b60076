"""W_fg's gradient of the port's bf16 replay backward against the JAX
package's replay (``fused_stack(..., strategy="replay")`` in interpret
mode, as tests/test_torch_replay.py runs it).

JAX's replay backward (``_bwd_kernel_padded`` with save_h=False) replays
the residual stream in float32 and feeds W_fg's gradient [h | h(t-d) |
ctx] with float32 operands, h(t-d) on the first d rows of each of its time
tiles from its ring snapshot in the compute dtype; its save strategy feeds
hsave's bf16(h).  The port's plain replay backward follows the replay
(``ops/stack_kernel._save_bwd``'s ``tap_round``).  At the narrow pairs
(16, 16), (64, 64), (64, 8) and the wide (128, 128), (128, 8), on a
3-layer cut of the probe's dilations (1, 2, 4) at B = 2, with the flat
ctx (T = 1280, JAX's tile 256) and with the video projection triple (T =
1600, tile 1600): the port's dW_fg lies within ``BAR`` of its largest
magnitude of JAX's replay, and farther than ``BAR`` from JAX's save.  On
these inputs the port reads 6.5e-5 to 3.9e-4 of scale from JAX's replay
and 1.4e-3 to 2.3e-3 from JAX's save (JAX's two strategies 1.4e-3 to
2.3e-3 apart); every other gradient of the port's replay is its save
strategy's bit for bit (tests/test_torch_replay.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movenet_tpu.ops.pallas import stack_kernel as jsk

from movenet_tpu_torch.ops import stack_kernel as sk

torch.set_num_threads(2)
B, DIL = 2, (1, 2, 4)
T_FLAT, T_PROJ = 1280, 1600
CAST = {"x", "ctx", "xc"}           # the activations, in bf16


def _inputs(r, s, ctx_kind, seed=0):
    """Seeded numpy inputs of the 3-layer trunk: x, the ctx (flat, or the
    triple xc, wup, bup), the weights and dskip."""
    rng = np.random.default_rng(seed)
    n, t = len(DIL), T_PROJ if ctx_kind == "proj" else T_FLAT
    f, win = np.float32, 3 * r
    a = dict(
        x=(rng.standard_normal((B, t, r)) * 0.5).astype(f),
        b_fg=(rng.standard_normal((n * B, 2 * r)) * 0.1).astype(f),
        w_fg=(rng.standard_normal((n, win, 2 * r)) / np.sqrt(win)).astype(f),
        w_out=(rng.standard_normal((n, r, r + s)) / np.sqrt(r)).astype(f),
        b_out=(rng.standard_normal((n, r + s)) * 0.1).astype(f),
        dskip=(rng.standard_normal((B, t, s)) * 0.1).astype(f))
    if ctx_kind == "flat":
        a["ctx"] = (rng.standard_normal((B, t, r)) * 0.5).astype(f)
    else:
        a["xc"] = (rng.standard_normal((B, t // 10, r)) * 0.5).astype(f)
        a["wup"] = (rng.standard_normal((r, 10 * r)) / np.sqrt(r)).astype(f)
        a["bup"] = (rng.standard_normal((10 * r,)) * 0.1).astype(f)
    return a


def _names(a):
    return ["x"] + [k for k in ("ctx", "xc", "wup", "bup") if k in a] \
        + ["b_fg", "w_fg", "w_out", "b_out"]


def _ctx(d):
    return (d["xc"], d["wup"], d["bup"]) if "xc" in d else d.get("ctx")


def _jax_dw_fg(a, strategy):
    names = _names(a)
    args = [jnp.asarray(a[n], jnp.bfloat16 if n in CAST else jnp.float32)
            for n in names]

    def op(*xs):
        d = dict(zip(names, xs))
        return jsk.fused_stack(d["x"], _ctx(d), d["b_fg"], d["w_fg"],
                               d["w_out"], d["b_out"], DIL, True, strategy)

    _, vjp = jax.vjp(op, *args)
    grads = vjp(jnp.asarray(a["dskip"], jnp.bfloat16))
    return np.asarray(grads[names.index("w_fg")], np.float32)


def _torch_dw_fg(a):
    bf = torch.bfloat16
    ts = {n: torch.tensor(a[n], dtype=bf if n in CAST else torch.float32,
                          requires_grad=True) for n in _names(a)}
    skip = sk.fused_stack(ts["x"], _ctx(ts), ts["b_fg"], ts["w_fg"],
                          ts["w_out"], ts["b_out"], DIL, strategy="replay")
    skip.backward(torch.tensor(a["dskip"], dtype=bf))
    return ts["w_fg"].grad.float().numpy()


# of dW_fg's largest magnitude
BAR = 7e-4


@pytest.mark.parametrize("ctx_kind", ["flat", "proj"])
@pytest.mark.parametrize("r,s", [(16, 16), (64, 64), (64, 8), (128, 128),
                                 (128, 8)])
def test_bf16_replay_dw_fg_is_jax_replays(r, s, ctx_kind):
    a = _inputs(r, s, ctx_kind)
    want = _jax_dw_fg(a, "replay")
    save = _jax_dw_fg(a, "save")
    got = _torch_dw_fg(a)
    scale = float(np.max(np.abs(want)))
    err = float(np.max(np.abs(got - want))) / scale
    off = float(np.max(np.abs(got - save))) / scale
    assert err <= BAR, f"dW_fg {err:.3e} of scale from JAX's replay"
    assert off > BAR, f"dW_fg only {off:.3e} of scale from JAX's save"
    assert abs(float(np.mean(got - want))) <= 1e-4 * scale
