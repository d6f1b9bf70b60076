"""How the save forward's outputs depend on the summation order of its
products, on the CPU, from the order models in ``ops/stack_kernel.py``.

    python -m movenet_tpu_torch.utils.fwd_order [--shapes
        breakdancing,exp03,exp04] [--seeds 0,1,2] [--rows 2048]

The save layer kernel (``csrc/stack_kernel.cu``) sums fg on the tensor
cores and keeps the plain version's bits: an fg element whose tf or sg
lies within ``MMA_TIE_UNITS`` float32 units of |a|_2 |w|_2 (the operand
row's and the W_fg column's L2 norms) of a bf16 rounding tie is summed
again as the plain version's fmaf chain, and the residual's out is that
chain.  For each shape (``time_stack_bwd.SHAPES``' widths, dilations and
video; ``--rows`` steps a batch row; x, ctx and the weights
drawn from a seed at ``time_stack_bwd``'s scales) and seed this prints:

* the share of tf and of sg elements that the kernel's margin flags, over
  every layer (on the chain order's layer inputs);
* the largest gap between the tensor-core order's and the chain's fg, in
  float32 units (2^-24) of |a|_2 |w|_2 (the margin's unit) and of
  sum_i |a_i w_i| (a rigorous bound on either order's error is about K
  of these units, K the row length);
* escapes: the hsave and tfsg values in which the kernel's model (the
  re-sums and the residual chain) differs from the plain version in the
  chain's order;
* the distance of two forwards from one summed in float64 (the same
  bf16 roundings, every sum and the gate in float64): the chain (the
  plain version on the card, and the kernel with its re-sums) and the
  tensor-core order alone (``exact_ties=False``): each output's largest
  and mean difference over its scale, and its share of bf16 values equal
  to the float64 forward's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from movenet_tpu_torch.ops import stack_kernel as sk
from movenet_tpu_torch.utils.time_stack_bwd import SHAPES


def inputs(name: str, seed: int, rows: int):
    """(x, ctx, b_fg, w_fg, w_out, b_out, dilations): bf16 x and ctx of
    scale 0.5 (the embedding table's and the video triple's), the
    weights at time_stack_bwd's scales."""
    b, r, s, dil, _ = SHAPES[name]
    n, win = len(dil), 3 * r
    rng = np.random.default_rng(seed)

    def rn(*shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32))

    return (rn(b, rows, r, scale=0.5).to(torch.bfloat16),
            rn(b, rows, r, scale=0.5).to(torch.bfloat16),
            rn(n * b, 2 * r, scale=0.1), rn(n, win, 2 * r, scale=win ** -0.5),
            rn(n, r, r + s, scale=r ** -0.5), rn(n, r + s, scale=0.1), dil)


def tie_stats(x, ctx, b_fg, w_fg, dil, w_out, b_out) -> dict:
    """The kernel margin's flagged shares of tf and sg and the largest gap
    between the two orders' fg, over the layers of the chain-order
    forward."""
    f32, bf = torch.float32, torch.bfloat16
    batch, _, r = x.shape
    bfg = b_fg.reshape(len(dil), batch, 1, 2 * r)
    unit = 2.0 ** -24
    h, ctxf = x.float(), ctx.float()
    flags_t = flags_s = total = 0
    gap_l2 = gap_l1 = 0.0
    for l, d in enumerate(dil):
        hr = h.to(bf).to(f32)
        a = torch.cat([hr, sk._shift(hr, d), ctxf], dim=-1)
        w = w_fg[l].to(bf).to(f32)
        fm = sk.mma_order_matmul(a, w)
        fc = sk.chain_matmul(a, w)
        gap = (fm - fc).abs()
        l2 = a.norm(dim=-1, keepdim=True) * w.norm(dim=0)
        l1 = a.abs() @ w.abs()
        gap_l2 = max(gap_l2, float((gap / (unit * l2)).max()))
        gap_l1 = max(gap_l1, float((gap / (unit * l1)).max()))
        fm = fm + bfg[l]
        t, s = torch.tanh(fm[..., :r]), torch.sigmoid(fm[..., r:])
        tie = sk.MMA_TIE_UNITS * unit
        tt = (1 - t * t) * tie * l2[..., :r] + 4 * tie * t.abs()
        ts = s * (1 - s) * tie * l2[..., r:] + 4 * tie * s
        flags_t += int(sk._near_bf16_tie(t, tt).sum())
        flags_s += int(sk._near_bf16_tie(s, ts).sum())
        total += t.numel()
        # the next layer's input as the plain version forms it
        fc = fc + bfg[l]
        v = torch.cat([torch.tanh(fc[..., :r]), torch.sigmoid(fc[..., r:])],
                      dim=-1).to(bf).to(f32)
        gated = (v[..., :r] * v[..., r:]).to(bf).to(f32)
        out = sk.chain_matmul(gated, w_out[l, :, :r].to(bf).to(f32))
        h = (out + b_out[l, :r]) + h
    return {"flag_tf": flags_t / total, "flag_sg": flags_s / total,
            "gap_l2": gap_l2, "gap_l1": gap_l1}


def distance(got, ref) -> str:
    """Each output's largest difference from ``ref`` over its scale, and
    its share of bf16 values equal to ``ref``'s."""
    out = []
    for name, u, v in zip(("skip", "hsave", "tfsg"), got, ref):
        u = u.to(torch.bfloat16).double()
        v = v.to(torch.bfloat16).double()
        scale = v.abs().max()
        err = float((u - v).abs().max() / scale)
        mean = float((u - v).abs().mean() / scale)
        out.append(f"{name} {err:.3e}, mean {mean:.3e} "
                   f"({float((u == v).double().mean()):.6f} equal)")
    return ", ".join(out)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--seeds", default="0,1,2")
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--threads", type=int, default=4)
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    bf = torch.bfloat16
    with torch.no_grad():
        for name in args.shapes.split(","):
            for seed in map(int, args.seeds.split(",")):
                x, ctx, b_fg, w_fg, w_out, b_out, dil = inputs(
                    name, seed, args.rows)
                w = (b_fg, w_fg, w_out, b_out)
                st = tie_stats(x, ctx, b_fg, w_fg, dil, w_out, b_out)
                chain = sk._save_fwd(x.float(), ctx, *w, dil, bf, False,
                                     matmul=sk.chain_matmul)
                kept = sk.stack_fwd_x_mma_order(x, ctx, *w, dil)
                mma = sk.stack_fwd_x_mma_order(x, ctx, *w, dil,
                                               exact_ties=False)
                f64 = sk._save_fwd(x.double(), ctx, *w, dil, bf, False,
                                   acc=torch.float64)
                esc = [int((u != v).sum()) for u, v in
                       zip(kept[1:], chain[1:])]
                print(f"{name} seed {seed} ({x.shape[0]} x {x.shape[1]} "
                      f"rows, {len(dil)} layers): flagged tf "
                      f"{st['flag_tf']:.4%}, sg {st['flag_sg']:.4%}; "
                      f"largest gap between the orders "
                      f"{st['gap_l2']:.3f} units of |a|_2|w|_2 (margin "
                      f"{sk.MMA_TIE_UNITS}), {st['gap_l1']:.3f} units of "
                      f"sum|a w|; escapes hsave {esc[0]}, tfsg {esc[1]}",
                      flush=True)
                print(f"  from float64: chain {distance(chain, f64)}",
                      flush=True)
                print(f"  from float64: tensor cores {distance(mma, f64)}",
                      flush=True)


if __name__ == "__main__":
    main()
