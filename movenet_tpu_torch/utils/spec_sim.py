"""Exact offline replay of the speculative sampler's hit counter.

The counterpart of ``movenet_tpu.utils.spec_sim``, line for line in
numpy.  The speculative kernel's codes equal the standard kernel's for
any guess sequence (a guess commits only when the real chain's code
equals it), so its hits are a function of the code stream alone: the
guess tables, hits and iteration count replay from the codes without
running the kernel.  The tests and ``chip_smoke.py`` hold every hit
count of ``ops/cuda/ar_sampler.ar_sampler_spec`` against this replay.

Prompt seeding with duplicate transitions is last-write-wins, as numpy
fancy assignment is; the port's wrapper seeds its tables the same way,
on the host.
"""

from __future__ import annotations

import numpy as np


def simulate_spec_hits(tokens: np.ndarray, c_in: int, rf: int,
                       order: int = 3, depth: int = 1,
                       adaptive: bool = True):
    """Replay the spec kernel's guess/commit process over ``tokens``.

    tokens: (n,) int array, the whole sequence including the rf-length
    prompt (what ``cuda_generate`` returns for one stream).
    Returns (hits, iterations): hits counts committed speculative
    samples (the kernel's hit counter); iterations is the number of
    dependent-chain rounds, so (n - rf) / iterations is the
    steps-per-iteration multiplier.
    """
    if order not in (2, 3):
        raise ValueError(f"order must be 2 or 3, got {order}")
    if depth not in (1, 2):
        raise ValueError(f"depth must be 1 or 2, got {depth}")
    x = np.asarray(tokens, np.int64).ravel()
    n = x.size
    if n <= rf:
        raise ValueError(f"need tokens past the prompt (n={n}, rf={rf})")

    t2 = np.full(c_in, -1, np.int64)
    t2[x[:rf - 1]] = x[1:rf]              # last-write-wins
    t3 = None
    if order == 3:
        t3 = np.full((c_in, c_in), -1, np.int64)
        t3[x[:rf - 2], x[1:rf - 1]] = x[2:rf]

    def guess1(prev, cur):
        if order == 3 and t3[prev, cur] >= 0:
            return t3[prev, cur]
        return t2[cur]

    def guess2(cur, g1):
        # g1 == -1 never reaches a hit2 check, so the value is
        # irrelevant then
        if g1 < 0:
            return -1
        if order == 3 and t3[cur, g1] >= 0:
            return t3[cur, g1]
        return t2[g1]

    hits = 0
    iters = 0
    t = rf                                 # emitting x[t] this round
    while t < n:
        iters += 1
        prev, cur = x[t - 1], x[t]
        nxt = x[t + 1] if t + 1 < n else -2   # real code at t+1
        g1 = guess1(prev, cur)
        hit1 = (t + 1 < n) and (g1 == nxt)
        hit2 = False
        if depth == 2 and hit1:
            nxt_s = x[t + 2] if t + 2 < n else -2
            g2 = guess2(cur, g1)
            hit2 = (t + 2 < n) and (g2 == nxt_s)
        if adaptive:
            if t + 1 < n:
                t2[cur] = nxt
                if order == 3:
                    t3[prev, cur] = nxt
            if hit1 and t + 2 < n:
                t2[g1] = x[t + 2]
                if order == 3:
                    t3[cur, g1] = x[t + 2]
            if hit2 and t + 3 < n:
                t2[x[t + 2]] = x[t + 3]
                if order == 3:
                    t3[g1, x[t + 2]] = x[t + 3]
        adv = 1 + int(hit1) + int(hit2)
        hits += adv - 1
        t += adv
    return hits, iters
