"""Compiled model + vmapped MCMC end-to-end on the Cascadia fixture.

The observation fixture is the reference's example point
(``/root/reference/point.py:400-410``).
"""

import numpy as np
import pytest

SETTING = {
    "OceanWater": {"H": 2},
    "OceanSedimentCascadia": {"H": [1, "rel_pos", 100, 0.1]},
    "OceanCrust": {"H": 7, "Vs": [3.25, 3.94]},
    "OceanMantleHybrid": {
        "BottomDepth": 200, "Conversion": "Ritzwoller",
        "ThermAge": [4, "rel_pos", 200, 0.4],
        "Vs": [[0, "abs", 0.4, 0.01], [0, "abs", 0.4, 0.01],
               [0, "abs", 0.4, 0.01], [0, "abs", 0.2, 0.01]],
    },
    "Info": {"modelType": "CascadiaOcean", "period": 10,
             "refLayer": True, "lithoAgeQ": True},
}
LOCAL = {"topo": -2.567706, "lithoAge": 0.6, "sedthk": 0.019,
         "mantleInitParmVs": [-0.3426920324186606, -0.1863907997418917,
                              -0.1882828662382096, -0.05648363217566826]}
PERIODS = [10, 12, 14, 16, 18, 20, 22, 24, 26, 28, 30, 32, 36, 40, 50, 60,
           70, 80]
VELS = [3.5724066175576223, 3.6222019289297043, 3.6520621581430763,
        3.6588731735179367, 3.673255450218663, 3.683443600610537,
        3.6844591498161896, 3.689993791502759, 3.6935745493241487,
        3.696092260762209, 3.707185398688356, 3.7148258328900985,
        3.7209668755498257, 3.7486729577980427, 3.7706463827824748,
        3.82144353111797, 3.8603954933518914, 3.9030011211762767]
UNCERS = [0.006550350458769691, 0.005, 0.005, 0.005, 0.005, 0.005, 0.005,
          0.005, 0.005, 0.005, 0.005, 0.005499996722895128,
          0.00751713560920708, 0.007910350806141024, 0.007711019920661203,
          0.010152973423528881, 0.01062776863809981, 0.015829560954127662]


@pytest.fixture(scope="module")
def point():
    from pysurfinv_tpu.inversion.point import PointCascadia
    return PointCascadia(SETTING, LOCAL, periods=PERIODS, vels=VELS,
                         uncers=UNCERS)


@pytest.fixture(scope="module")
def cm(point):
    from pysurfinv_tpu.inversion.compiled import CompiledModel
    return CompiledModel(point.initMod)


def test_compiled_forward_matches_host(point, cm):
    """The frozen-structure jit path reproduces the host object path."""
    import jax.numpy as jnp
    host = point.initMod.forward(periods=PERIODS)
    assert host is not None
    dev = np.asarray(cm.forward(cm.spec.theta0,
                                jnp.asarray(np.array(PERIODS, float))))
    assert np.all(dev > 0)
    assert np.abs(dev - host).max() < 2e-4  # same physics, same grids


def test_traced_profile_full_precision(point, cm):
    """The jit-traced profile build keeps its B-spline products at
    HIGHEST precision (a GPU would otherwise run f32 products in TF32,
    ~1e-3 relative — the size of the parity budget in Vs) and matches
    the host object's profile: the same layer grid, and Vs within the
    compiled model's known mantle-top interpolation offset (< 1%)."""
    import re

    import jax
    fn = jax.jit(lambda th: cm.build_profile(th)[:5])
    txt = fn.lower(cm.spec.theta0).as_text()
    dots = re.findall(r"stablehlo\.dot_general.*", txt)
    assert dots and all("HIGHEST, HIGHEST" in d for d in dots), dots
    h, vp, vs, rho, qsinv = map(np.asarray, fn(cm.spec.theta0))
    hh, vsh, *_ = point.initMod.seisPropLayers(refLayer=cm._use_ref)
    keep = h > 0
    np.testing.assert_allclose(h[keep], hh, rtol=1e-12)
    np.testing.assert_allclose(vs[keep], vsh, rtol=1e-2)


def test_compiled_profile_finite(cm):
    h, vp, vs, rho, qsinv, nlay = [np.asarray(x) if not isinstance(x, int)
                                   else x
                                   for x in cm.build_profile(cm.spec.theta0)]
    assert np.isfinite(h).all() and np.isfinite(vs).all()
    assert (h >= 0).all()
    assert nlay <= cm.L


def test_isgood_compiled_vs_host(point, cm):
    """Device prior agrees with the host prior on random draws."""
    import jax
    rng = np.random.default_rng(1)
    spec = cm.spec
    vmin, vmax = np.asarray(spec.vmin), np.asarray(spec.vmax)
    agree, n = 0, 12
    for i in range(n):
        theta = vmin + rng.random(len(vmin)) * (vmax - vmin)
        dev = bool(jax.jit(cm.isgood)(theta))
        mod = point.initMod.copy()
        mod._loadMC(theta)
        host = bool(mod.isgood())
        agree += int(dev == host)
    assert agree >= n - 1  # boundary cases may differ by float details


def test_vs_only_build_bitwise(cm):
    """The prior fast path (vs_only build) is bitwise exact on (z, vs).

    ``CompiledModel.isgood`` skips every layer's ``_calOthers`` (the
    hybrid mantle's second HSCM + Ruan anelasticity pass dominates a
    full build); the priors read only (z, vs), which the fast path
    computes with exactly the same code.  Guard that contract here so
    a future layer whose ``_calVs`` starts reading the others-context
    cannot silently change prior decisions.
    """
    import jax
    rng = np.random.default_rng(7)
    spec = cm.spec
    vmin, vmax = np.asarray(spec.vmin), np.asarray(spec.vmax)
    full = jax.jit(lambda t: cm.build_grids(t)[:2])
    fast = jax.jit(lambda t: cm.build_grids(t, vs_only=True)[:2])
    for _ in range(6):
        theta = vmin + rng.random(len(vmin)) * (vmax - vmin)
        zf, vf = [np.asarray(x) for x in full(theta)]
        zq, vq = [np.asarray(x) for x in fast(theta)]
        np.testing.assert_array_equal(zf, zq)
        np.testing.assert_array_equal(vf, vq)


def test_mcinv_mp_end_to_end(point, tmp_path):
    """Tiny vmapped inversion -> reference npz format -> PostPoint."""
    from pysurfinv_tpu.inversion.point import PostPoint
    outdir = str(tmp_path / "mc")
    point.MCinvMP(outdir=outdir, pid="229.8_47.0", runN=48, chainL=16,
                  seed=1, verbose=False)
    pp = PostPoint(f"{outdir}/229.8_47.0.npz")
    assert pp.N == 48
    assert np.isfinite(pp.misfits).all()
    assert pp.accFinal.sum() >= 1
    assert np.isfinite(pp.minMod.misfit)
    # chain rows carry theta in _brownians order
    assert pp.MCparas.shape[1] == len(point.initMod._brownians())

    # posterior plot surface incl. the layered plotVsProfile variant
    # (reference point.py:196-205, added round 2)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    ax = pp.plotVsProfile()
    assert len(ax.lines) >= 3  # initial + ensemble/avg/min overlays
    pp.plotVsProfileGrid()
    pp.plotDisp(ensemble=False)
    plt.close("all")


def test_propose_batched_equals_vmapped(point, cm):
    """Tail-compacted proposals are bit-identical to vmap(_propose).

    Compaction only changes which buffer row a lane occupies; its key
    chain, draw sequence and first-success round are untouched — so
    the sampled chains are exactly the uncompacted ones, just faster.
    """
    import jax
    import jax.numpy as jnp
    from pysurfinv_tpu.inversion.mcmc import (ChainConfig, _propose,
                                              _propose_batched)

    N = 96
    cfg = ChainConfig(chain_len=8)
    keys = jax.random.split(jax.random.PRNGKey(11), N)
    rng = np.random.default_rng(4)
    spec = cm.spec
    th = (np.asarray(spec.theta0)[None]
          + 0.05 * rng.standard_normal((N, len(spec.theta0)))
          * np.asarray(spec.step)[None])
    th = jnp.asarray(np.clip(th, np.asarray(spec.vmin),
                             np.asarray(spec.vmax)))
    bcast = lambda x: jnp.broadcast_to(x, (N,) + x.shape)  # noqa: E731
    spec_b = jax.tree.map(bcast, spec)
    psi_b = bcast(cm.psi0)
    isgood = lambda t, p: cm.isgood(t, p)  # noqa: E731

    ref_c, ref_f = jax.jit(jax.vmap(
        lambda k, t, s, c: _propose(k, t, s, c, isgood, cfg)))(
        keys, th, spec_b, psi_b)
    # min_stage small so the 96-lane test exercises two compactions
    fast_c, fast_f = jax.jit(
        lambda k, t, s, c: _propose_batched(k, t, s, c, isgood, cfg,
                                            min_stage=6))(
        keys, th, spec_b, psi_b)
    np.testing.assert_array_equal(np.asarray(ref_f), np.asarray(fast_f))
    np.testing.assert_array_equal(np.asarray(ref_c), np.asarray(fast_c))

    # the pyramid ratio only reshapes the compaction schedule — any
    # value must reproduce the same lanes bit for bit (the env knob is
    # read at trace time, so set it before tracing)
    import os
    os.environ["PYSURFINV_PROPOSE_RATIO"] = "2"
    try:
        r2_c, r2_f = jax.jit(
            lambda k, t, s, c: _propose_batched(k, t, s, c, isgood, cfg,
                                                min_stage=6))(
            keys, th, spec_b, psi_b)
    finally:
        del os.environ["PYSURFINV_PROPOSE_RATIO"]
    np.testing.assert_array_equal(np.asarray(ref_f), np.asarray(r2_f))
    np.testing.assert_array_equal(np.asarray(ref_c), np.asarray(r2_c))

    # wide rounds (W > 2 routes the key-chain walk through lax.scan
    # instead of the unrolled Python loop — the fresh-process tracing
    # fix): still bit-identical to the sequential reference
    os.environ["PYSURFINV_PROPOSE_FLAT"] = "512"
    try:
        w_c, w_f = jax.jit(
            lambda k, t, s, c: _propose_batched(k, t, s, c, isgood, cfg,
                                                min_stage=6))(
            keys, th, spec_b, psi_b)
    finally:
        os.environ["PYSURFINV_PROPOSE_FLAT"] = "8"
    np.testing.assert_array_equal(np.asarray(ref_f), np.asarray(w_f))
    np.testing.assert_array_equal(np.asarray(ref_c), np.asarray(w_c))


def test_host_mcinv_oracle(point, tmp_path):
    """The host-sequential Metropolis oracle writes a valid chain npz
    (restart rows flagged accepted, finite misfits)."""
    out = str(tmp_path / "host")
    point.MCinv(outdir=out, pid="h", runN=6, chainL=3, seed=0,
                verbose=False)
    tr = np.load(f"{out}/h.npz", allow_pickle=True)["mcTrack"]
    assert tr.shape[0] == 6
    assert tr[0, 2] == 1 and tr[3, 2] == 1  # chain restarts
    assert set(np.unique(tr[:, 2])) <= {0.0, 1.0}
    assert np.isfinite(tr).all()
    assert tr.shape[1] == 3 + len(point.initMod._brownians())


def test_priori_mode(point, tmp_path):
    outdir = str(tmp_path / "mcp")
    point.MCinvMP(outdir=outdir, pid="p", runN=32, chainL=16, seed=2,
                  priori=True, verbose=False)
    import numpy as np
    tr = np.load(f"{outdir}_priori/p.npz", allow_pickle=True)["mcTrack"]
    assert tr.shape[0] == 32
    assert (tr[:, 2] == 1).all()  # priori rows always "accepted"


def test_priori_distribution_qc(point, tmp_path):
    """Posterior + priori chains -> PostPoint prior-vs-posterior
    histogram QC (point.py:230-248) runs end-to-end."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from pysurfinv_tpu.inversion.point import PostPointCascadia

    post_dir = str(tmp_path / "mc")
    pri_dir = str(tmp_path / "mc_priori")
    point.MCinvMP(outdir=post_dir, pid="p", runN=48, chainL=16, seed=5,
                  verbose=False)
    point.MCinvMP(outdir=pri_dir, pid="p", runN=48, chainL=16, seed=6,
                  priori=True, verbose=False)
    post = PostPointCascadia(f"{post_dir}/p.npz", f"{pri_dir}/p.npz")
    assert post.MCparas_pri is not None
    assert post.MCparas_pri.shape == (48, post.MCparas.shape[1])
    plt.close("all")
    post._check_distribution(zdeps=[20.0, 60.0])
    assert len(plt.get_fignums()) == 2  # one histogram per depth
    plt.close("all")
