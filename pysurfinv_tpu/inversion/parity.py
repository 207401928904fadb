"""Statistical cross-validation: device sampler vs host oracle posterior.

The single deepest claim of this rebuild is that the batched device
sampler (``parallel.grid.invert_grid`` / ``Point.MCinvMP``) samples the
SAME posterior as the host-sequential oracle (``Point.MCinv``, the
reference-exact reimplementation of ``/root/reference/point.py:32-89``).
The two samplers deliberately differ in proposal RNG (``jax.random``
truncated normals vs ``random.gauss`` reject-until-in-bounds), solver
configuration (warm-started coarse brackets vs the default config), and
dtype on chip — so nothing short of a statistical comparison of the
*posteriors* validates the claim.

Design
------
Both samplers restart every ``chainL`` steps from an independent uniform
draw (reference ``point.py:47-55``), so each chain segment is an i.i.d.
replicate of the identical chain law.  Every posterior statistic is
therefore computed PER CHAIN, and the two samplers are compared as two
samples of chain-level replicates with a permutation test on the max
absolute Welch z-score across statistics — exact at any replicate count,
no normality assumption.

Statistics per chain (the reference's own posterior conventions):
  * acceptance rate over all proposal rows;
  * fraction of rows below the misfit acceptance threshold
    ``max(2*minMisfit, minMisfit + 0.5)`` (point.py:307-309), with the
    threshold computed from the POOLED min misfit of both runs so both
    sides are filtered identically;
  * posterior mean and std of every theta component over the
    true-Markov-chain rows (rejected rows inherit the last accepted
    state, point.py:152-157) passing the threshold;
  * posterior quantiles (0.1/0.5/0.9) of Vs(z) at selected depths over
    the same rows, evaluated through the compiled model.

Host-oracle speed note: ``Point.MCinv`` accepts an ``isgood=``
injection.  :func:`fast_host_prior` wraps the compiled model's traced
prior, which is parity-tested against the host layer objects'
``isgood`` (tests/test_priors.py) — this keeps the oracle's proposal
semantics (BrownianVar ``move``/``reset`` streams) and misfit host-exact
while cutting the prior-rebuild cost ~50x, making >=1e4-step oracle
runs tractable on one CPU.
"""

from __future__ import annotations

import glob
import os

import numpy as np


def fast_host_prior(model):
    """Host ``isgood``-compatible wrapper over the compiled prior.

    Returns ``f(model) -> bool`` evaluating ``CompiledModel.isgood`` on
    the model's current Brownian vector — bit-compatible with the host
    prior by tests/test_priors.py, ~3 ms instead of ~150 ms per call.
    """
    import jax
    import jax.numpy as jnp

    from pysurfinv_tpu.inversion.compiled import CompiledModel

    cm = CompiledModel(model)
    fn = jax.jit(cm.isgood)
    psi = jnp.asarray(cm.psi0)

    def good(m):
        th = np.asarray(m._brownians(), dtype=float)
        return bool(fn(jnp.asarray(th), psi))

    return good


def _true_chain(track, chainL):
    """(nchain, chainL, ncol) with rejected rows inheriting the last
    accepted parameters within each chain (point.py:152-157)."""
    N, ncol = track.shape
    nch = N // chainL
    t = track[: nch * chainL].reshape(nch, chainL, ncol).copy()
    acc = t[:, :, 2] > 0.5
    # vectorised last-accepted fill: index of the most recent accepted
    # row at or before each step (row 0 is always accepted)
    idx = np.arange(chainL)[None, :] * acc
    idx = np.maximum.accumulate(idx, axis=1)
    rows = np.take_along_axis(t[:, :, 3:], idx[:, :, None], axis=1)
    t[:, :, 3:] = rows
    return t


def chain_statistics(files, zdeps=None, thres=None, vs_model=None):
    """Per-chain replicate statistics over one sampler's npz files.

    Args:
      files:    npz chain files (each ``mcTrack`` + ``invMeta.chainL``).
      zdeps:    depths (km) for Vs posterior quantiles; None skips them.
      thres:    misfit acceptance threshold; None = reference convention
                from these files alone.  For cross-run comparisons pass
                the pooled value (see :func:`pooled_threshold`).
      vs_model: a Model1D whose CompiledModel evaluates Vs(z) for theta
                rows (required when zdeps is given).

    Returns ``(stats, thres)``: dict of arrays keyed by statistic name
    (leading axis = chain replicates pooled over files) and the
    threshold used.  Chains with < 10 threshold-passing rows contribute
    NaN to posterior statistics (and are counted by the ``converged``
    statistic, compared like any other).
    """
    chains = []
    for f in sorted(files):
        d = np.load(f, allow_pickle=True)
        chainL = int(d["invMeta"][()]["chainL"])
        chains.extend(_true_chain(d["mcTrack"], chainL))
    if thres is None:
        mmin = min(float(np.nanmin(c[:, 0][c[:, 0] > 0])) for c in chains)
        thres = max(2 * mmin, mmin + 0.5)

    cm = None
    if zdeps is not None:
        from pysurfinv_tpu.inversion.compiled import CompiledModel
        cm = CompiledModel(vs_model)

    out = {"acceptance": [], "converged": []}
    k = chains[0].shape[1] - 3
    for i in range(k):
        out[f"theta{i}_mean"] = []
        out[f"theta{i}_std"] = []
    if zdeps is not None:
        for z in zdeps:
            for q in (0.1, 0.5, 0.9):
                out[f"vs_z{z:g}_q{q:g}"] = []

    for ch in chains:
        out["acceptance"].append(ch[:, 2].mean())
        sel = ch[:, 0] < thres
        out["converged"].append(float(sel.sum() >= 10))
        if sel.sum() < 10:
            for key in out:
                if key.startswith(("theta", "vs_")):
                    out[key].append(np.nan)
            continue
        th = ch[sel, 3:]
        mu, sd = th.mean(axis=0), th.std(axis=0)
        for i in range(k):
            out[f"theta{i}_mean"].append(mu[i])
            out[f"theta{i}_std"].append(sd[i])
        if zdeps is not None:
            vs = _vs_profiles(cm, th, np.asarray(zdeps, float))
            qs = np.quantile(vs, (0.1, 0.5, 0.9), axis=0)  # (3, nz)
            for iz, z in enumerate(zdeps):
                for iq, q in enumerate((0.1, 0.5, 0.9)):
                    out[f"vs_z{z:g}_q{q:g}"].append(qs[iq, iz])
    return {k2: np.asarray(v, float) for k2, v in out.items()}, thres


def _vs_profiles(cm, thetas, zdeps, chunk=4096):
    """Vs(zdeps) rows for a theta stack via the compiled grid builder."""
    import jax
    import jax.numpy as jnp

    n = cm._n_nodes_main
    zj = jnp.asarray(zdeps)

    @jax.jit
    def vals(ths):
        def one(t):
            z, vs, *_ = cm.build_grids(t, vs_only=True)
            return jnp.interp(zj, z[:n], vs[:n])
        return jax.vmap(one)(ths)

    outs = []
    for i in range(0, len(thetas), chunk):
        outs.append(np.asarray(vals(jnp.asarray(thetas[i:i + chunk]))))
    return np.concatenate(outs, axis=0)


def pooled_threshold(file_groups):
    """Reference-convention threshold from the pooled min misfit of all
    runs, so every group is filtered identically."""
    mmin = np.inf
    for files in file_groups:
        for f in files:
            t = np.load(f, allow_pickle=True)["mcTrack"]
            m = t[:, 0][t[:, 0] > 0]
            if len(m):
                mmin = min(mmin, float(np.nanmin(m)))
    return max(2 * mmin, mmin + 0.5)


def _welch_z(a, b):
    a, b = a[np.isfinite(a)], b[np.isfinite(b)]
    if len(a) < 2 or len(b) < 2:
        return 0.0
    se = np.sqrt(a.var(ddof=1) / len(a) + b.var(ddof=1) / len(b))
    if se == 0:
        return 0.0 if a.mean() == b.mean() else np.inf
    return (a.mean() - b.mean()) / se


def _aggregates(pz):
    """(max |z|, rms z, |mean z|) of a finite z-score vector."""
    pz = pz[np.isfinite(pz)]
    if not len(pz):
        return 0.0, 0.0, 0.0
    return (float(np.abs(pz).max()), float(np.sqrt(np.mean(pz**2))),
            float(abs(np.mean(pz))))


def compare_posteriors(stats_a, stats_b, n_perm=4000, seed=0):
    """Permutation test on three complementary aggregate z statistics.

    Pools the chain replicates of both samplers, relabels the sides
    over every distinct split (exact enumeration when there are fewer
    than ~20k splits, else ``n_perm`` random permutations), and locates
    three observed aggregates in their permutation distributions —
    exact under exchangeability (chains are i.i.d. within each
    sampler), valid at any replicate count, family-wise by
    construction:

      * max |Welch z| — sensitive to ONE badly drifted statistic
        (e.g. acceptance rate off);
      * rms z — a small systematic shift spread over MANY statistics;
      * |mean z| (signed) — a COHERENT shift (e.g. a biased proposal
        step moving every posterior mean the same way), the most
        sensitive aggregate when drift is directional.

    ``p_value`` is the Bonferroni combination min(1, 3 min(p)) — a
    valid (conservative) familywise p for "the posteriors differ".

    Returns dict with per-statistic z-scores, the aggregates and their
    p-values, the combined ``p_value``, and the worst statistic.
    """
    from itertools import combinations
    from math import comb

    keys = [k for k in stats_a if k in stats_b]
    zs = {k: float(_welch_z(stats_a[k], stats_b[k])) for k in keys}
    worst = max(zs, key=lambda k: abs(zs[k]))
    obs = _aggregates(np.array([zs[k] for k in keys]))

    na = len(next(iter(stats_a.values())))
    pooled = {k: np.concatenate([stats_a[k], stats_b[k]]) for k in keys}
    ntot = na + len(next(iter(stats_b.values())))

    if comb(ntot, na) <= 20000:
        splits = [np.array(c) for c in combinations(range(ntot), na)]
    else:
        rng = np.random.default_rng(seed)
        splits = [np.sort(rng.permutation(ntot)[:na])
                  for _ in range(n_perm)]
    all_idx = np.arange(ntot)
    counts = np.zeros(3, int)
    for ia in splits:
        ib = np.setdiff1d(all_idx, ia, assume_unique=True)
        pz = np.array([_welch_z(pooled[k][ia], pooled[k][ib])
                       for k in keys])
        agg = _aggregates(pz)
        for j in range(3):
            counts[j] += agg[j] >= obs[j]
    n_spl = len(splits)
    # exact enumeration includes the identity split, so the +1/(n+1)
    # guard is only needed for the sampled branch
    exact = comb(ntot, na) <= 20000
    ps = [(c / n_spl) if exact else (c + 1) / (n_spl + 1)
          for c in counts]
    return {"z": zs, "max_abs_z": obs[0], "rms_z": obs[1],
            "mean_abs_z": obs[2], "worst": worst,
            "p_max": ps[0], "p_rms": ps[1], "p_mean": ps[2],
            "p_value": min(1.0, 3.0 * min(ps)),
            "n_a": na, "n_b": ntot - na, "exact": exact}


def glob_npz(outdir):
    return sorted(glob.glob(os.path.join(outdir, "*.npz")))
