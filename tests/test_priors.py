"""Unit parity: device (jnp) prior building blocks vs host (numpy).

The device priors were rewritten from associative scans + dynamic
gathers to the O(n^2) adjacent-flagged-pair matrix form
(priors._adjacent_flagged_pairs) so they fuse; these tests pin the
semantics against the host reference implementations on randomized
signals, including masked (thin-layer-dropped) nodes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pysurfinv_tpu.inversion import priors as P


@pytest.mark.parametrize("seed", range(20))
def test_extrema_oscillation_matches_host(seed):
    rng = np.random.default_rng(seed)
    n = 40
    v = np.cumsum(rng.normal(0, 0.05, n)) + 4.0
    limit = float(rng.uniform(0.02, 0.2))
    host = P.local_extrema_oscillation(v, limit)
    dev = bool(P.jnp_local_extrema_oscillation(
        jnp.asarray(v), jnp.ones(n, bool), limit))
    assert dev == host


@pytest.mark.parametrize("seed", range(20))
def test_group_jumps_matches_bruteforce(seed):
    """keep-masked jump check == explicit compacted-grid loop."""
    rng = np.random.default_rng(100 + seed)
    n = 30
    vs = 2.0 + np.cumsum(rng.normal(0.02, 0.1, n))
    grp = np.sort(rng.integers(0, 4, n))
    keep = rng.random(n) > 0.25
    dev = bool(P.jnp_group_jumps_positive(
        jnp.asarray(vs), jnp.asarray(grp), keep=jnp.asarray(keep)))
    # brute force on the compacted grid
    ks = np.where(keep)[0]
    ok = True
    for a, b in zip(ks[:-1], ks[1:]):
        if grp[a] != grp[b] and vs[b] < vs[a]:
            ok = False
    assert dev == ok


def test_adjacent_pairs_structure():
    flag = jnp.asarray(np.array([0, 1, 0, 1, 1, 0, 1], bool))
    pair = np.asarray(P._adjacent_flagged_pairs(flag))
    expect = np.zeros((7, 7), bool)
    expect[1, 3] = expect[3, 4] = expect[4, 6] = True
    np.testing.assert_array_equal(pair, expect)


@pytest.mark.parametrize("seed", range(10))
def test_cwt_oscillation_matches_host(seed):
    rng = np.random.default_rng(200 + seed)
    n = 60
    z = np.linspace(10.0, 200.0, n)
    v = 4.3 + 0.3 * np.sin(z / rng.uniform(20, 90)) \
        + np.cumsum(rng.normal(0, 0.01, n))
    host = P.cwt_oscillation(v, z, limit=0.3)
    dev = bool(P.jnp_cwt_oscillation(
        jnp.asarray(v), jnp.asarray(z), jnp.ones(n, bool), limit=0.3))
    assert dev == host


@pytest.mark.parametrize("seed,n,H", [
    # fine dz -> host width 30//dz > 32: the old static max_width=32 cap
    # regime; n > 320 was where the cap truncated
    (0, 400, 100.0), (1, 400, 100.0), (2, 350, 60.0), (3, 330, 40.0),
    # coarse sanity alongside
    (4, 340, 150.0),
])
def test_cwt_oscillation_fine_dz_matches_host(seed, n, H):
    """Fine mantle grids (width = 30//dz >> 32, n > 320) must still be
    bit-compatible with the host prior: the kernel length is now the
    static signal length, never a fixed cap."""
    rng = np.random.default_rng(300 + seed)
    z = np.linspace(10.0, 10.0 + H, n)
    dz = z[1] - z[0]
    assert 30.0 // dz > 32  # genuinely in the old-cap overflow regime
    v = 4.3 + 0.25 * np.sin(z / rng.uniform(5, 40)) \
        + np.cumsum(rng.normal(0, 0.008, n))
    host = P.cwt_oscillation(v, z, limit=0.3)
    dev = bool(P.jnp_cwt_oscillation(
        jnp.asarray(v), jnp.asarray(z), jnp.ones(n, bool), limit=0.3))
    assert dev == host
