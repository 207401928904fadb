"""Statistical posterior parity: device batched sampler vs host oracle.

THE flagship claim of this rebuild:
the batched device sampler reproduces the host-sequential oracle's
*posterior* — not just its per-step algebra.  The two samplers differ
by design in proposal RNG (jax.random truncated normals vs
random.gauss reject-until-in-bounds), prior application order, and
solver configuration (warm-started coarse-bracket fast config vs the
default), so this can only be validated statistically.

Harness: ``pysurfinv_tpu.inversion.parity`` — both samplers restart
every ``chainL`` steps from an independent uniform draw, so each chain
is an i.i.d. replicate; acceptance rate, per-theta posterior mean/std
and Vs(z) posterior quantiles are computed per chain and the two
replicate samples are compared with a permutation test on the max
|Welch z| across all statistics (exact at any replicate count,
family-wise by construction).

Workload here is CPU-budgeted (minutes, not the full 24k x 4 seeds) —
it has the power to catch structural drift (wrong proposal scale,
mis-applied prior, acceptance-rule bias, solver-config root errors
reaching the likelihood).  The full-power version is
``scripts/posterior_parity.py`` (same statistics, hours of chains);
its measured verdict is recorded in docs/POSTERIOR_PARITY.md.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest

pytestmark = pytest.mark.slow

RUN_N = int(os.environ.get("PYSURFINV_PARITY_RUNN", 900))
CHAIN_L = int(os.environ.get("PYSURFINV_PARITY_CHAINL", 300))
SEEDS = (0, 1)   # 2 seeds x 3 chains = 6 replicates per side
Z_DEPS = [5.0, 15.0, 30.0, 60.0, 100.0]


@pytest.fixture(scope="module")
def parity_runs():
    from examples.invert_point import (localInfo, periods, setting,
                                       uncers, vels)
    from pysurfinv_tpu.inversion.parity import fast_host_prior
    from pysurfinv_tpu.inversion.point import PointCascadia

    point = PointCascadia(setting, localInfo, periods=periods,
                          vels=vels, uncers=uncers)
    # dev iteration knob: PYSURFINV_PARITY_CACHE=1 reuses the (fully
    # deterministic) sampler outputs from a fixed tmp dir across runs —
    # NEVER set in CI: stale chains would mask the very drift this test
    # exists to catch.
    cache = os.environ.get("PYSURFINV_PARITY_CACHE") == "1"
    out = (os.path.join(tempfile.gettempdir(),
                        f"parity_cache_{RUN_N}_{CHAIN_L}")
           if cache else tempfile.mkdtemp(prefix="parity_"))
    host_dir = os.path.join(out, "host")
    dev_dir = os.path.join(out, "device")
    # host oracle: host-exact proposal/misfit/Metropolis semantics with
    # the compiled prior injected (bit-compatible with the host prior
    # by tests/test_priors.py; ~50x faster, making the oracle runnable
    # in-suite)
    prior = None
    for s in SEEDS:
        if not (cache and os.path.exists(
                os.path.join(host_dir, f"host_s{s}.npz"))):
            prior = prior or fast_host_prior(point.initMod)
            point.MCinv(outdir=host_dir, pid=f"host_s{s}", runN=RUN_N,
                        chainL=CHAIN_L, seed=s, isgood=prior)
        if not (cache and os.path.exists(
                os.path.join(dev_dir, f"dev_s{s}.npz"))):
            point.MCinvMP(outdir=dev_dir, pid=f"dev_s{s}", runN=RUN_N,
                          chainL=CHAIN_L, seed=s, verbose=False)
    yield point, host_dir, dev_dir
    if not cache:
        shutil.rmtree(out, ignore_errors=True)


def test_device_sampler_reproduces_host_posterior(parity_runs):
    from pysurfinv_tpu.inversion.parity import (chain_statistics,
                                                compare_posteriors,
                                                glob_npz,
                                                pooled_threshold)

    point, host_dir, dev_dir = parity_runs
    hf, df = glob_npz(host_dir), glob_npz(dev_dir)
    thres = pooled_threshold([hf, df])
    sh, _ = chain_statistics(hf, zdeps=Z_DEPS, thres=thres,
                             vs_model=point.initMod)
    sd, _ = chain_statistics(df, zdeps=Z_DEPS, thres=thres,
                             vs_model=point.initMod)

    # sanity floor (not a parity statement): most chains on both sides
    # must reach the posterior, or every posterior statistic is NaN and
    # the comparison below passes vacuously.  An occasional chain that
    # has not descended below the misfit threshold within chainL steps
    # is a legitimate burn-in outcome (observed ~1 in 6 at chainL=250);
    # systematic convergence differences ARE parity-relevant and enter
    # the permutation test through the ``converged`` statistic.
    assert np.nanmean(sh["converged"]) >= 0.5
    assert np.nanmean(sd["converged"]) >= 0.5

    res = compare_posteriors(sh, sd, seed=7)
    # p < 0.05: the posteriors are distinguishable at this power ->
    # the device sampler has drifted from the oracle.  The threshold is
    # calibrated against the power check below: a 2.0-sigma coherent
    # drift measures p=0.046, 2.5-sigma p=0.033 on this data, while
    # the genuine-parity measurement is p=0.57 — an order of magnitude
    # of margin each way.  The test is DETERMINISTIC (fixed sampler
    # seeds + exact permutation enumeration); if a deliberate sampler
    # change re-rolls the chains and this marginally trips, re-run at
    # PYSURFINV_PARITY_RUNN=24000 (or scripts/posterior_parity.py) to
    # adjudicate with real power before touching the threshold.
    assert res["p_value"] >= 0.05, (
        f"posterior drift: worst statistic {res['worst']} "
        f"|z|={res['max_abs_z']:.2f}, p={res['p_value']:.4f}, "
        f"host acc={np.nanmean(sh['acceptance']):.3f} "
        f"device acc={np.nanmean(sd['acceptance']):.3f}")


def test_comparator_detects_injected_drift(parity_runs):
    """Power check: the permutation test must FLAG a corrupted sampler.

    Take the device chains and inject a posterior shift of 2.5 chain-
    level sigma into every theta mean (the scale of a mis-set proposal
    step or a biased acceptance rule); the comparator must reject.
    Guards against the parity test passing vacuously for lack of power.
    (Measured on this data: 1.5 sigma p=0.17, 2.0 sigma p=0.046,
    2.5 sigma p=0.033 — the theta-mean statistics are correlated
    ACROSS chains, a hot chain shifts many means together, which
    inflates the permutation null of every aggregate; 2-2.5 sigma is
    the calibrated detectable scale at 6v6 replicates, hence the 0.05
    gate in the parity test above.)
    """
    from pysurfinv_tpu.inversion.parity import (chain_statistics,
                                                compare_posteriors,
                                                glob_npz,
                                                pooled_threshold)

    point, host_dir, dev_dir = parity_runs
    hf, df = glob_npz(host_dir), glob_npz(dev_dir)
    thres = pooled_threshold([hf, df])
    sh, _ = chain_statistics(hf, zdeps=None, thres=thres)
    sd, _ = chain_statistics(df, zdeps=None, thres=thres)
    drifted = dict(sd)
    for k in drifted:
        if k.endswith("_mean"):
            sig = np.nanstd(np.concatenate([sh[k], sd[k]]))
            drifted[k] = drifted[k] + 2.5 * (sig + 1e-12)
    res = compare_posteriors(sh, drifted, seed=7)
    assert res["p_value"] < 0.05, res
