"""MALA sampler: mechanics + posterior parity vs the host oracle.

The gradient-informed sampler (``inversion.mala``) targets the SAME
posterior as the reference's random-walk Metropolis — same soft-capped
chi^2 likelihood, same bounds+isgood prior (as an MH indicator instead
of a retry loop) — through a fundamentally different proposal.  So:

1. mechanics tests: finite chains, MH-valid acceptance behaviour,
   gradient pulls downhill (a pure-drift step reduces chi^2 from a
   perturbed start), reference npz format;
2. posterior parity (slow): the ``inversion.parity`` comparator
   between MALA chains and the HOST ORACLE chains — excluding the
   proposal-mechanics statistics (acceptance rate, converged-row
   fraction), which legitimately differ between proposal families;
   the posterior location/shape statistics (theta means/stds, Vs(z)
   quantiles over thresholded true-chain rows) must agree.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # solver+vjp compiles dominate

RUN_N = int(os.environ.get("PYSURFINV_PARITY_RUNN", 900))
CHAIN_L = int(os.environ.get("PYSURFINV_PARITY_CHAINL", 300))
SEEDS = (0, 1)
Z_DEPS = [5.0, 15.0, 30.0, 60.0, 100.0]
TAU = 0.5


def _point():
    from examples.invert_point import (localInfo, periods, setting,
                                       uncers, vels)
    from pysurfinv_tpu.inversion.point import PointCascadia
    return PointCascadia(setting, localInfo, periods=periods,
                         vels=vels, uncers=uncers)


def test_mala_mechanics(tmp_path):
    from pysurfinv_tpu.inversion.mala import mala_point

    pt = _point()
    path = mala_point(pt, outdir=str(tmp_path), pid="m", runN=64,
                      chainL=32, seed=3, tau=TAU)
    d = np.load(path, allow_pickle=True)
    tr = d["mcTrack"]
    assert tr.shape[0] == 64
    assert np.isfinite(tr).all()
    # row 0 of each chain is the forced-accept start row
    assert tr[0, 2] == 1 and tr[32, 2] == 1
    acc = tr[:, 2].mean()
    assert 0.05 < acc <= 1.0, f"degenerate acceptance {acc}"
    # misfit must move: a frozen chain means the proposal or gradient
    # is broken
    assert np.unique(np.round(tr[:, 0], 6)).size > 5
    # npz format round-trips through the posterior reader
    from pysurfinv_tpu.inversion.point import PostPoint
    pp = PostPoint(path)
    assert np.isfinite(pp.misfits).any()


def test_mala_gradient_pulls_downhill():
    """A pure-drift half-step (no noise) from a prior-perturbed start
    must reduce chi^2 — the sign/scale contract of the implicit-diff
    gradient path."""
    import jax
    import jax.numpy as jnp

    from pysurfinv_tpu.inversion.compiled import CompiledModel
    from pysurfinv_tpu.inversion.mala import (MalaConfig,
                                              make_mala_sampler)
    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg
    from pysurfinv_tpu.utils import host_eager

    pt = _point()
    with host_eager():
        cm = CompiledModel(pt.initMod)
        spec1 = cm.spec_of(pt.initMod)
        psi1 = cm.psi_of(pt.initMod)
    T, c_obs, unc, m_obs = pt._obs_arrays()
    N = 4
    rep = lambda x: jnp.repeat(jnp.asarray(x)[None], N, 0)  # noqa
    ctx = (rep(psi1), rep(T), rep(c_obs), rep(unc), rep(m_obs))
    from pysurfinv_tpu.inversion.compiled import BrownianSpec
    spec = BrownianSpec(*[rep(f) for f in spec1])

    scfg = mcmc_solver_cfg()
    mcfg = MalaConfig(tau=TAU, chain_len=4)
    init_fn, run_fn = make_mala_sampler(cm, type(pt), scfg, "rayleigh",
                                        mcfg)

    # perturbed starts: theta0 plus ~1 step of noise, clipped inside
    key = jax.random.PRNGKey(0)
    xi = jax.random.normal(key, spec.theta0.shape)
    th = jnp.clip(spec.theta0 + spec.step * xi,
                  spec.vmin + 1e-9, spec.vmax - 1e-9)

    # evaluate chi and gradient directly through the sampler internals
    from pysurfinv_tpu.inversion.mala import _grad_chi_lane
    from pysurfinv_tpu.ops.dispersion import surf_forward_batch

    h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(th, ctx[0])
    c, _, okk = surf_forward_batch(h, vp, vs, rho, qsi, ctx[1], nlay,
                                   wave="rayleigh", cfg=scfg)
    cP = jnp.where(okk[:, :, 0], c[:, :, 0], 0.0)
    mfc = type(pt)._misfit_from_c
    chi0 = jax.vmap(lambda cp, t, oc, u, mk: mfc(
        cp, t, oc, u, mk, valid=mk)[1])(cP, *ctx[1:])
    g = jax.vmap(_grad_chi_lane(cm, type(pt), scfg, "rayleigh"))(
        th, ctx[0], ctx[1], cP, ctx[2], ctx[3], ctx[4])
    assert np.isfinite(np.asarray(g)).all()

    # drift-only step with a SMALL tau (well inside the linear regime)
    tau2 = 0.2 ** 2
    th1 = jnp.clip(th - 0.25 * tau2 * (spec.step ** 2) * g,
                   spec.vmin, spec.vmax)
    h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(th1, ctx[0])
    c, _, okk = surf_forward_batch(h, vp, vs, rho, qsi, ctx[1], nlay,
                                   wave="rayleigh", cfg=scfg)
    cP1 = jnp.where(okk[:, :, 0], c[:, :, 0], 0.0)
    chi1 = jax.vmap(lambda cp, t, oc, u, mk: mfc(
        cp, t, oc, u, mk, valid=mk)[1])(cP1, *ctx[1:])
    chi0, chi1 = np.asarray(chi0), np.asarray(chi1)
    assert (chi1 <= chi0 + 1e-6).all(), (chi0, chi1)
    assert (chi1 < chi0 - 1e-3).any()      # strictly downhill somewhere


@pytest.mark.skipif(os.environ.get("PYSURFINV_MALA_PARITY") != "1",
                    reason="~30-60 min on a 1-CPU host (host oracle + "
                    "per-step vjp); opt in with PYSURFINV_MALA_PARITY=1."
                    "  Recorded standalone verdict: "
                    "docs/POSTERIOR_PARITY.md (round 4)")
def test_mala_posterior_parity_vs_host_oracle():
    """Comparator gate, proposal-mechanics statistics excluded."""
    from pysurfinv_tpu.inversion.mala import mala_point
    from pysurfinv_tpu.inversion.parity import (chain_statistics,
                                                compare_posteriors,
                                                fast_host_prior,
                                                glob_npz,
                                                pooled_threshold)

    pt = _point()
    cache = os.environ.get("PYSURFINV_PARITY_CACHE") == "1"
    out = (os.path.join(tempfile.gettempdir(),
                        f"parity_mala_{RUN_N}_{CHAIN_L}")
           if cache else tempfile.mkdtemp(prefix="parity_mala_"))
    host_dir = os.path.join(out, "host")
    mala_dir = os.path.join(out, "mala")
    prior = None
    try:
        for s in SEEDS:
            if not (cache and os.path.exists(
                    os.path.join(host_dir, f"host_s{s}.npz"))):
                prior = prior or fast_host_prior(pt.initMod)
                pt.MCinv(outdir=host_dir, pid=f"host_s{s}", runN=RUN_N,
                         chainL=CHAIN_L, seed=s, isgood=prior)
            if not (cache and os.path.exists(
                    os.path.join(mala_dir, f"mala_s{s}.npz"))):
                # init_all: MALA's capped drift cannot descend from a
                # uniform draw within CHAIN_L steps (the measured
                # mixing limitation);
                # initMod starts isolate posterior CORRECTNESS — the
                # statistics below are threshold-filtered true-chain
                # rows, insensitive to the start point once converged
                mala_point(pt, outdir=mala_dir, pid=f"mala_s{s}",
                           runN=RUN_N, chainL=CHAIN_L, seed=s, tau=TAU,
                           init_all=True)

        hf, mf = glob_npz(host_dir), glob_npz(mala_dir)
        thres = pooled_threshold([hf, mf])
        sh, _ = chain_statistics(hf, zdeps=Z_DEPS, thres=thres,
                                 vs_model=pt.initMod)
        sm, _ = chain_statistics(mf, zdeps=Z_DEPS, thres=thres,
                                 vs_model=pt.initMod)
        assert np.nanmean(sh["converged"]) >= 0.5
        assert np.nanmean(sm["converged"]) >= 0.5
        # acceptance rate and converged-row fraction are properties of
        # the PROPOSAL (mixing speed), not of the posterior; different
        # proposal families legitimately differ there.  Posterior
        # location/shape statistics must agree.
        drop = ("acceptance", "converged")
        sh2 = {k: v for k, v in sh.items() if k not in drop}
        sm2 = {k: v for k, v in sm.items() if k not in drop}
        res = compare_posteriors(sh2, sm2, seed=7)
        assert res["p_value"] >= 0.05, (
            f"MALA posterior drift: worst {res['worst']} "
            f"|z|={res['max_abs_z']:.2f} p={res['p_value']:.4f}")
    finally:
        if not cache:
            shutil.rmtree(out, ignore_errors=True)
