"""The port's hit replay (movenet_tpu_torch/utils/spec_sim.py) against the
JAX package's (movenet_tpu/utils/spec_sim.py) on seeded random code
streams, at every (order, depth, adaptive) combination."""

import numpy as np
import pytest

from movenet_tpu.utils.spec_sim import simulate_spec_hits as j_sim

from movenet_tpu_torch.utils.spec_sim import simulate_spec_hits

COMBOS = [(o, d, a) for o in (2, 3) for d in (1, 2) for a in (True, False)]


def _stream(seed: int, n: int, c: int, period: int) -> np.ndarray:
    """A quasi-periodic stream (so guesses hit) with random faults."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, c, size=period)
    x = np.tile(base, n // period + 1)[:n]
    faults = rng.random(n) < 0.1
    x[faults] = rng.integers(0, c, size=int(faults.sum()))
    return x


@pytest.mark.parametrize("order,depth,adaptive", COMBOS)
def test_replay_equals_jax(order, depth, adaptive):
    for seed, (n, c, rf, period) in enumerate(
            [(300, 8, 16, 5), (301, 32, 16, 12), (257, 4, 31, 3)]):
        x = _stream(seed, n, c, period)
        got = simulate_spec_hits(x, c, rf, order, depth, adaptive)
        assert got == j_sim(x, c, rf, order, depth, adaptive)
        hits, iters = got
        assert hits + iters == n - rf


def test_replay_of_a_constant_stream():
    # after the prompt every guess holds: depth 2 commits two per round
    x = np.zeros(40, np.int64)
    assert simulate_spec_hits(x, 4, 10, order=3, depth=2) \
        == j_sim(x, 4, 10, order=3, depth=2) == (20, 10)


def test_input_errors_match_jax():
    bad = [dict(order=4), dict(depth=3)]
    for kw in bad:
        for fn in (simulate_spec_hits, j_sim):
            with pytest.raises(ValueError, match=next(iter(kw))):
                fn(np.zeros(10, np.int64), 8, 4, **kw)
    for fn in (simulate_spec_hits, j_sim):
        with pytest.raises(ValueError, match="past the prompt"):
            fn(np.zeros(4, np.int64), 8, 4)
