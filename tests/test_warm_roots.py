"""Cross-step warm-started bracketing (surf_forward_batch c_warm).

The MCMC samplers carry the last evaluated proposal's roots and seed
the next step's brackets from them (one fused sweep for all periods,
replacing the cold first-period scan and the sequential period chain).
Contract: for ANY c_warm — exact roots, drifted roots, or zeros — the
solver returns the same fundamental roots as the cold path to Illinois
tolerance, because lanes whose warm window misses fall back to the full
cold bracketing chain (ops/dispersion.py rescue pass).
"""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def solved(eus_model):
    import jax.numpy as jnp
    from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward_batch

    m = eus_model
    B = 4
    rng = np.random.default_rng(3)
    tile = lambda x: np.tile(np.asarray(x)[None], (B, 1))
    h = tile(m["h"])
    vs = tile(m["vs"]) * (1 + 0.002 * rng.standard_normal((B, len(m["vs"]))))
    vp = tile(m["vp"])
    rho = tile(m["rho"])
    qsi = tile(m["qsinv"])
    nlay = np.full(B, m["nlay"], np.int32)
    periods = np.asarray(m["periods"], float)[:6]
    cfg = SurfConfig(nmodes=1, compute_group=False,
                     backend="pallas_interpret")
    args = tuple(map(jnp.asarray, (h, vp, vs, rho, qsi)))
    kw = dict(wave="rayleigh", cfg=cfg)
    c0, _, ok0 = surf_forward_batch(*args, jnp.asarray(periods),
                                    jnp.asarray(nlay), **kw)
    assert np.asarray(ok0).all()
    return args, periods, nlay, kw, np.asarray(c0)


@pytest.mark.parametrize("mode", ["exact", "drift", "cold_zero", "mixed"])
def test_warm_matches_cold(solved, mode):
    import jax.numpy as jnp
    from pysurfinv_tpu.ops.dispersion import surf_forward_batch

    args, periods, nlay, kw, c0 = solved
    roots = c0[:, :, 0]
    if mode == "exact":
        warm = roots
    elif mode == "drift":
        rng = np.random.default_rng(5)
        warm = roots + rng.uniform(-0.03, 0.03, roots.shape)
    elif mode == "cold_zero":
        warm = np.zeros_like(roots)  # row-0 / failed-forward seeds
    else:  # some lanes warm, some cold -> exercises the merge
        warm = roots.copy()
        warm[::2] = 0.0
        warm[1, 1::2] = 0.0
    c1, _, ok1 = surf_forward_batch(*args, jnp.asarray(periods),
                                    jnp.asarray(nlay),
                                    c_warm=jnp.asarray(warm), **kw)
    assert np.asarray(ok1).all()
    d = np.abs(np.asarray(c1)[:, :, 0] - roots)
    assert d.max() < 5e-5, f"{mode}: max root deviation {d.max():.2e}"


@pytest.mark.slow
def test_mcmc_solver_cfg_accuracy_vs_oracle():
    """Regression gate for the shipped fast sampler solver config.

    ``parallel.grid.mcmc_solver_cfg()`` (coarse=8, nbisect=11,
    [-12,+20]·dc warm windows) was validated against a wide-window
    40-iteration oracle in A/B ladders, but that evidence was once
    prose only.  This test turns it
    into a committed gate: CPU f64, a randomized Cascadia-like batch
    walked through warm-started pseudo-MCMC steps exactly as the
    sampler drives the solver (``c_warm`` = previous evaluated roots,
    zeros = cold), compared per step against a cold wide-window oracle.
    Budget: q99 |Δc| <= 2e-4 km/s (2.5x the measured headroom, ~50x
    inside the 0.1% parity budget), max <= 2e-3, ok-masks identical.
    Fails if someone bumps coarse/nbisect/window past the parity
    budget.
    """
    import jax.numpy as jnp

    from bench import build_batch
    from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward_batch
    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg

    B, K = 48, 4
    rng = np.random.default_rng(11)
    batch, nlay = build_batch(B, rng)      # (B, 5, L) f64 Cascadia-like
    periods = jnp.asarray(np.array(
        [10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40, 50,
         60, 70, 80], float))
    NL = jnp.full((B,), nlay, jnp.int32)

    fast = mcmc_solver_cfg()
    oracle = SurfConfig(nmodes=1, compute_group=False, nbisect=40)

    def solve(b, cfg, warm=None):
        c, _, ok = surf_forward_batch(
            jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]),
            jnp.asarray(b[:, 2]), jnp.asarray(b[:, 3]),
            jnp.asarray(b[:, 4]), periods, NL, wave="rayleigh", cfg=cfg,
            c_warm=warm)
        return np.asarray(c)[:, :, 0], np.asarray(ok)[:, :, 0]

    deltas = []
    warm = jnp.zeros((B, len(periods)))    # step 0 = cold, as the sampler
    cur = batch
    for step in range(K):
        c_fast, ok_fast = solve(cur, fast, warm=warm)
        c_ref, ok_ref = solve(cur, oracle)
        assert (ok_fast == ok_ref).all(), f"ok-mask drift at step {step}"
        assert ok_fast.all()
        deltas.append(np.abs(c_fast - c_ref).ravel())
        warm = jnp.asarray(c_fast)
        # next pseudo-proposal: multiplicative Vs jitter at the real
        # per-step drift scale (measured root drift [-6.9,+7.2]·dc)
        cur = cur.copy()
        jit = 1.0 + 0.004 * rng.standard_normal((B, cur.shape[2]))
        live = cur[:, 0] > 0
        cur[:, 2] *= np.where(live, jit, 1.0)
        cur[:, 1] *= np.where(live, jit, 1.0)
    d = np.concatenate(deltas)
    q99 = np.quantile(d, 0.99)
    assert q99 <= 2e-4, f"q99 |dc| {q99:.2e} exceeds the parity budget"
    assert d.max() <= 2e-3, f"max |dc| {d.max():.2e}"


@pytest.mark.slow
def test_mcmc_newton_refinement_accuracy():
    """Interpret-mode gate for the shipped newton_sep refinement.

    ``mcmc_solver_cfg()`` ships ``newton_sep=3`` (round 3: +11-24%
    grid throughput), which only the PALLAS path honours — the XLA
    path (and hence the f64 gate above) silently keeps Illinois.  This
    leg drives the actual Newton refinement through the Pallas
    interpreter on a small warm-started batch and pins its root error
    against a wide-window oracle.  Budget from the on-chip measurement
    (2048 lanes x 18 periods x 4 steps, f32: med 4.8e-7, q99 8.2e-4,
    max 5.8e-3 — see mcmc_solver_cfg's docstring): q99 <= 1.5e-3,
    max <= 8e-3, ok-mask equality.  Interpret mode runs f64 here, so a
    breach means the ALGORITHM regressed, not the dtype.
    """
    import jax.numpy as jnp

    from bench import build_batch
    from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward_batch
    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg

    B, K = 8, 3
    rng = np.random.default_rng(5)
    batch, nlay = build_batch(B, rng)
    periods = jnp.asarray(np.array([10, 14, 18, 24, 30, 40, 60, 80],
                                   float))
    NL = jnp.full((B,), nlay, jnp.int32)
    newt = mcmc_solver_cfg()._replace(backend="pallas_interpret")
    assert newt.newton_sep >= 3  # the shipped config under test
    oracle = SurfConfig(nmodes=1, compute_group=False, nbisect=40)

    def solve(b, cfg, warm=None):
        c, _, ok = surf_forward_batch(
            jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]),
            jnp.asarray(b[:, 2]), jnp.asarray(b[:, 3]),
            jnp.asarray(b[:, 4]), periods, NL, wave="rayleigh",
            cfg=cfg, c_warm=warm)
        return np.asarray(c)[:, :, 0], np.asarray(ok)[:, :, 0]

    cur = batch
    warm = jnp.zeros((B, len(periods)))
    ds = []
    for _ in range(K):
        cn, okn = solve(cur, newt, warm=warm)
        co, oko = solve(cur, oracle)
        assert (okn == oko).all() and okn.all()
        ds.append(np.abs(cn - co).ravel())
        warm = jnp.asarray(cn)
        cur = cur.copy()
        jit = 1.0 + 0.004 * rng.standard_normal((B, cur.shape[2]))
        live = cur[:, 0] > 0
        cur[:, 2] *= np.where(live, jit, 1.0)
        cur[:, 1] *= np.where(live, jit, 1.0)
    d = np.concatenate(ds)
    assert np.quantile(d, 0.99) <= 1.5e-3, d.max()
    assert d.max() <= 8e-3, d.max()
