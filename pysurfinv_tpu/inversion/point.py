"""Single-point MCMC inversion drivers and posterior analysis.

Capability spec from ``/root/reference/point.py``: the Point observation
container + Metropolis MCMC (host, reference-exact), the multiprocess
variant re-imagined as vmapped on-device chains (``MCinvMP``), and
PostPoint posterior statistics over the npz chain format.
"""

from __future__ import annotations

import os
import random
import time

import numpy as np

from pysurfinv_tpu.models.model1d import MCinv as MCinvModel, buildModel1D


# Failure classes of compiling a custom (non-catalog) model family:
# structure freezing raises ValueError/KeyError/AttributeError, tracing a
# host-only layer raises TypeError (jax tracer errors subclass it) or
# NotImplementedError (abstract layer slots).  The posterior-plot
# fallbacks catch exactly these — nothing else.
_NONCOMPILABLE_ERRORS = (TypeError, ValueError, KeyError, AttributeError,
                         NotImplementedError)


def _soft_cap(chiSqr):
    """chi^2 soft cap above 50 (point.py:29)."""
    return chiSqr if chiSqr < 50 else np.sqrt(chiSqr * 50.0)


class Point:
    """Observed dispersion + a starting model (point.py:8-14)."""

    def __init__(self, setting=None, localInfo=None, modelTypeCustom=None,
                 layerClassCustom=None, periods=(), vels=(), uncers=()):
        self.initMod = buildModel1D(setting, localInfo or {},
                                    modelTypeCustom=modelTypeCustom,
                                    layerClassCustom=layerClassCustom or {})
        self.obs = {"T": periods, "c": vels, "uncer": uncers}
        self.pid = "test"

    # ---- misfit (point.py:15-31) ---------------------------------------
    def misfit(self, model=None):
        model = self.initMod if model is None else model
        T = self.obs["T"]
        cP = model.forward(periods=T)
        if cP is None:
            return 88888, 88888, 0
        cO = self.obs["c"]
        if not np.ma.isMaskedArray(cO):
            cO = np.ma.masked_array(cO)
        uncer = self.obs["uncer"]
        N = cO.count()
        chiSqr = (((cO - cP) / uncer) ** 2).sum()
        misfit = np.sqrt(chiSqr / N)
        chiSqr = _soft_cap(chiSqr)
        return misfit, chiSqr, np.exp(-0.5 * chiSqr)

    # ---- host-sequential oracle MCMC (semantics of point.py:32-89) ------
    def MCinv(self, outdir="MCtest", pid=None, runN=50000, chainL=1000,
              init=True, seed=None, verbose=False, priori=False,
              isgood=None):
        """Sequential Metropolis sampler on host model objects.

        Kept as the cross-validation oracle for the compiled device
        chains: one ``runN``-step run, restarted from a fresh uniform
        draw every ``chainL`` steps (the first segment starts from
        ``initMod``), recording a row for EVERY proposal with the
        accept flag in column 2 — the npz chain format.  The Metropolis
        rule, restart policy, and RNG call order follow the reference
        (``point.py:32-89``) so archived chains reproduce.

        ``isgood`` (extension; the reference MCinv has none): inject a
        prior predicate used for perturb AND segment-restart resets.
        With the default (None) every call is reference-exact
        (``reset()`` uses the model's own ``isgood()``, models.py:206).
        With an injected prior the reset path consults the injected
        predicate too, so archived reference chains reproduce ONLY if
        the prior is bit-compatible with ``model.isgood()`` (the parity
        harness's ``fast_host_prior`` is — tests/test_priors.py);
        otherwise the RNG stream diverges at the first restart.
        """
        prior_ok = isgood if isgood is not None else (lambda m: m.isgood())
        random.seed(seed)
        pid = pid if pid is not None else self.pid
        t_start = time.time()
        rows = [0] * runN
        current = proposal = None
        cur_chi = None
        for step in range(runN):
            if step % chainL == 0:
                if init:   # first segment only: start from initMod
                    init, current = False, self.initMod.copy()
                    if not prior_ok(current):
                        current = current.perturb(prior_ok)
                else:      # later segments: uniform re-draw
                    current = self.initMod.reset(prior_ok)
                    if verbose is True:
                        print(f"{step + 1}/{runN} Time cost:"
                              f"{time.time() - t_start:.2f} ")
                cur_misfit, cur_chi, cur_L = self.misfit(current)
                current._dump(step, rows, [cur_misfit, cur_L, 1])
                continue
            proposal = current.perturb(prior_ok)
            if priori:
                proposal._dump(step, rows, [0, 1, 1])
                current = proposal
                continue
            new_misfit, new_chi, new_L = self.misfit(proposal)
            # Metropolis on the soft-capped chi^2; the uniform draw is
            # only consumed on non-improving proposals (short-circuit),
            # preserving the reference's RNG stream
            take = (new_chi < cur_chi
                    or random.random() > 1 - np.exp(-(new_chi - cur_chi)
                                                    / 2))
            proposal._dump(step, rows, [new_misfit, new_L, int(take)])
            if take:
                current = proposal
                cur_chi = new_chi
        self._save_npz(outdir, pid, np.array(rows), chainL)
        return proposal

    # ---- vmapped on-device MCMC (replaces mp.Pool, point.py:90-125) -----
    def MCinvMP(self, outdir="MCtest", pid=None, runN=50000, chainL=1000,
                nprocess=None, seed=42, priori=False, isgood=None,
                verbose=True, wave="rayleigh", sampler="batched",
                segment=100):
        """All runN//chainL chain segments as vmapped lanes on one chip.

        ``nprocess`` is accepted for API compatibility and ignored — the
        parallelism unit is a vmap lane, not a process.

        ``sampler``: "batched" (default) inverts the loop order so every
        Metropolis step solves all chains' forwards in one
        ``surf_forward_batch`` call (fused kernels on a GPU) —
        implemented by delegating to ``parallel.grid.invert_grid`` with
        this single point, so MCinvMP shares the sharded grid driver's
        traced-program cache (repeated calls skip ~20-30 s of host
        retracing per call), pipelined segment fetches, fault retry and
        warm-started roots — one code path, one set of semantics.  On a
        multi-chip mesh the chain lanes shard across ALL devices (lane-
        granularity padding in invert_grid), so a single point scales
        to a pod without replication waste.
        "legacy" keeps the per-chain vmapped kernel.  Both target the
        same stationary distribution; RNG streams differ between the
        two samplers (the batched lane keys are identical to
        ``invert_grid`` with the same seed, by construction).

        ``segment``: run the batched sampler in jitted segments of this
        many steps (bitwise identical to the monolithic scan — see
        make_segmented_sampler) so each device execution stays short;
        infrastructures with an execution watchdog kill multi-minute
        single executions.  None = monolithic.
        """
        import jax

        if priori and outdir.split("_")[-1] != "priori":
            outdir = "_".join((outdir, "priori"))
        pid = self.pid if pid is None else pid
        if verbose:
            print(f"Running MC inversion: {pid}")
        timeStamp = time.time()

        if sampler == "batched":
            from pysurfinv_tpu.parallel.grid import invert_grid
            invert_grid([self], [(0.0, 0.0)], outdir=outdir, runN=runN,
                        chainL=chainL, seed=seed, priori=priori,
                        wave=wave, segment=segment, verbose=False,
                        pids=[pid])
        else:
            import jax.numpy as jnp
            from pysurfinv_tpu.inversion.compiled import CompiledModel
            from pysurfinv_tpu.inversion.mcmc import (ChainConfig,
                                                      make_chain_kernel,
                                                      run_chains)
            cm = CompiledModel(self.initMod)
            periods = jnp.asarray(np.asarray(self.obs["T"], dtype=float))
            cfg = ChainConfig(chain_len=chainL, priori=priori)
            n_chains = runN // chainL
            key = jax.random.PRNGKey(seed)
            chi_sqr = self._compiled_chi_sqr(cm, periods, wave)
            kernel = make_chain_kernel(lambda th, psi: cm.isgood(th, psi),
                                       chi_sqr, cfg)
            tracks = run_chains(kernel, key, cm.spec, cm.psi0, n_chains)
            mcTrack = np.asarray(tracks).reshape(runN, -1)
            self._save_npz(outdir, pid, mcTrack, chainL)
        if verbose:
            print(f"Time cost:{time.time() - timeStamp:.2f} ")

    # ---- traced misfit, the single source of truth for device paths ----
    @staticmethod
    def _misfit_from_c(cP, T, obs_c, uncer, obs_m, valid=None):
        """Traced per-lane misfit from predicted phase velocities.

        Pure jnp function of one lane's arrays — vmappable over chains
        and grid points — implementing point.py:15-31 (plain chi^2, soft
        cap, 88888 sentinel).  Subclasses override THIS (not
        `_misfit_kernel`) so both `MCinvMP` and the sharded
        `invert_grid` automatically sample with the subclass likelihood.

        Args:
          cP:    (P,) predicted phase velocities (0 where solver failed).
          T:     (P,) periods (used by band-split subclasses).
          obs_c: (P,) observed velocities, 0 where masked.
          uncer: (P,) observation uncertainties.
          obs_m: (P,) bool — True where an observation exists.
          valid: optional (P,) bool restricting the failed-forward check
                 (models.py:29 `any(c < 0.01)`) to real, unpadded
                 periods; None checks every entry of ``cP``.
        """
        import jax.numpy as jnp

        ok = (jnp.all(cP >= 0.01) if valid is None
              else jnp.all(jnp.where(valid, cP >= 0.01, True)))
        N = jnp.maximum(jnp.sum(obs_m), 1)
        chi = jnp.sum(jnp.where(obs_m, ((obs_c - cP) / uncer) ** 2, 0.0))
        misfit = jnp.sqrt(chi / N)
        chi = jnp.where(chi < 50, chi, jnp.sqrt(chi * 50.0))
        L = jnp.exp(-0.5 * chi)
        return (jnp.where(ok, misfit, 88888.0),
                jnp.where(ok, chi, 88888.0),
                jnp.where(ok, L, 0.0))

    def _obs_arrays(self):
        """(T, obs_c, uncer, obs_m) as jnp arrays for `_misfit_from_c`."""
        import jax.numpy as jnp

        T = np.asarray(self.obs["T"], dtype=float)
        cO = np.ma.masked_array(np.asarray(self.obs["c"], dtype=float))
        mask = ~np.ma.getmaskarray(cO) & np.ones(len(T), bool)
        return (jnp.asarray(T),
                jnp.asarray(np.where(mask, cO.filled(0.0), 0.0)),
                jnp.asarray(np.asarray(self.obs["uncer"], dtype=float)),
                jnp.asarray(mask))

    def _misfit_kernel(self):
        """Pure (cP (P,)) -> (misfit, chiSqr, L), single lane, vmappable
        — this point's observations bound into `_misfit_from_c`."""
        T, obs_c, uncer, obs_m = self._obs_arrays()
        cls = type(self)
        return lambda cP: cls._misfit_from_c(cP, T, obs_c, uncer, obs_m)

    def _compiled_chi_sqr(self, cm, periods, wave):
        mk = self._misfit_kernel()

        def chi_sqr(theta, psi):
            return mk(cm.forward(theta, periods, psi=psi, wave=wave))

        return chi_sqr

    def _save_npz(self, outdir, pid, mcTrack, chainL):
        from pysurfinv_tpu.utils import savez_fast
        os.makedirs(outdir, exist_ok=True)
        savez_fast(
            f"{outdir}/{pid}.npz", mcTrack=mcTrack,
            setting=dict(self.initMod.toYML()), obs=self.obs,
            invMeta={"pid": pid, "chainL": chainL})

    def copy(self):
        from copy import deepcopy
        return deepcopy(self)


class PointCascadia(Point):
    """Band-split misfit: mean chi^2 of T <= 40 s and T > 40 s averaged
    (point.py:336-366)."""

    def misfit(self, model=None):
        model = self.initMod if model is None else model
        T = np.array(self.obs["T"])
        cP = model.forward(periods=T)
        if cP is None:
            return 88888, 88888, 0
        cO = self.obs["c"]
        if not np.ma.isMaskedArray(cO):
            cO = np.ma.masked_array(cO)
        uncer = self.obs["uncer"]
        N = cO.count()
        bias = (cO - cP) / uncer
        b1, b2 = bias[T <= 40], bias[T > 40]
        if not np.all(b1.mask) and not np.all(b2.mask):
            chiSqr = ((b1**2).mean() + (b2**2).mean()) / 2 * N
        elif np.all(b1.mask):
            chiSqr = (b2**2).mean() * N
        elif np.all(b2.mask):
            chiSqr = (b1**2).mean() * N
        else:
            raise ValueError("All observations are masked???")
        misfit = np.sqrt(chiSqr / N)
        chiSqr = _soft_cap(chiSqr)
        return misfit, chiSqr, np.exp(-0.5 * chiSqr)

    @staticmethod
    def _misfit_from_c(cP, T, obs_c, uncer, obs_m, valid=None):
        """Band-split traced misfit (point.py:336-366): chi^2 is the
        average of the T <= 40 s and T > 40 s mean-square biases, scaled
        back to N observations.  Fully traced (band counts computed
        in-graph) so one compiled program serves lanes whose period
        lists differ — the sharded-grid case."""
        import jax.numpy as jnp

        ok = (jnp.all(cP >= 0.01) if valid is None
              else jnp.all(jnp.where(valid, cP >= 0.01, True)))
        lo = obs_m & (T <= 40)
        hi = obs_m & (T > 40)
        n_lo, n_hi = jnp.sum(lo), jnp.sum(hi)
        N = jnp.maximum(n_lo + n_hi, 1)
        b2 = jnp.where(obs_m, ((obs_c - cP) / uncer) ** 2, 0.0)
        m_lo = jnp.sum(jnp.where(lo, b2, 0.0)) / jnp.maximum(n_lo, 1)
        m_hi = jnp.sum(jnp.where(hi, b2, 0.0)) / jnp.maximum(n_hi, 1)
        chi = jnp.where((n_lo > 0) & (n_hi > 0), (m_lo + m_hi) / 2 * N,
                        jnp.where(n_lo > 0, m_lo * N, m_hi * N))
        misfit = jnp.sqrt(chi / N)
        chi = jnp.where(chi < 50, chi, jnp.sqrt(chi * 50.0))
        L = jnp.exp(-0.5 * chi)
        return (jnp.where(ok, misfit, 88888.0),
                jnp.where(ok, chi, 88888.0),
                jnp.where(ok, L, 0.0))


class PostPoint(Point):
    """Posterior reconstruction from the npz chain format
    (point.py:134-332)."""

    def __init__(self, npzMC=None, npzPriori=None, modelTypeCustom=None,
                 layerClassCustom=None, trueMarkovChain=True):
        if npzMC is not None:
            tmp = np.load(npzMC, allow_pickle=True)
            self.MC = tmp["mcTrack"]
            setting, self.obs = tmp["setting"][()], tmp["obs"][()]
            self.invMeta = tmp["invMeta"][()]
            self.initMod = buildModel1D(setting,
                                        modelTypeCustom=modelTypeCustom,
                                        layerClassCustom=layerClassCustom
                                        or {})
            self.N = self.MC.shape[0]
            self.misfits = self.MC[:, 0]
            self.Ls = self.MC[:, 1]
            self.accepts = self.MC[:, 2]
            self.MCparas = self.MC[:, 3:]
            self.MCparas_pri = None

            if trueMarkovChain:
                # rejected rows inherit the last accepted parameters
                # (point.py:152-157)
                iAcc = 0
                for i in range(self.N):
                    if self.accepts[i]:
                        iAcc = i
                    else:
                        self.MCparas[i, :] = self.MCparas[iAcc, :]

            indMin = np.nanargmin(self.misfits)
            self.minMod = self.initMod.copy()
            self.minMod._loadMC(self.MCparas[indMin])
            self.minMod.L = self.Ls[indMin]
            self.minMod.misfit = self.misfits[indMin]

            self.thres = self._thres(self.minMod.misfit)
            self.accFinal = self.misfits < self.thres

            self.avgMod = self.initMod.copy()
            self.avgMod._loadMC(np.mean(self.MCparas[self.accFinal, :],
                                        axis=0))
            self.avgMod.misfit, _, self.avgMod.L = self.misfit(
                model=self.avgMod)

        if npzPriori is not None:
            tmp = np.load(npzPriori, allow_pickle=True)["mcTrack"]
            self.MCparas_pri = tmp[:, 3:]

    @staticmethod
    def _thres(minMisfit):
        """Acceptance threshold (point.py:307-309)."""
        return max(minMisfit * 2, minMisfit + 0.5)

    def _model_generator(self, indSteps=None, priori=False):
        mod = self.initMod.copy()
        if indSteps is None:
            indSteps = (np.where(self.accFinal)[0] if not priori
                        else range(len(self.misfits)))
        mcParas = self.MCparas if not priori else self.MCparas_pri
        for ind in indSteps:
            mod._loadMC(mcParas[ind, :])
            yield mod.copy()

    def _loadValues(self, indVars="all", zdeps=None, indSteps=None,
                    priori=False):
        if zdeps is not None:
            if indSteps is None:
                indSteps = (np.where(self.accFinal)[0] if not priori
                            else range(len(self.misfits)))
            mcParas = self.MCparas if not priori else self.MCparas_pri
            thetas = np.asarray(mcParas[np.asarray(list(indSteps), int)],
                                float)
            try:
                return self._batched_values(np.asarray(zdeps, float), thetas)
            except _NONCOMPILABLE_ERRORS as e:
                # Custom layer classes outside the compiled catalog are
                # legitimate here (the reference allows arbitrary
                # layerClassCustom); they fail structure freezing /
                # tracing with exactly these classes (jax's tracer
                # errors subclass TypeError).  Anything else — XLA
                # runtime faults, numeric errors — propagates: a
                # compiled-model regression must not hide behind the
                # slow host loop.
                import warnings
                warnings.warn(
                    "PostPoint batched evaluation failed "
                    f"({type(e).__name__}: {e}); using the slow host "
                    "loop. If this model family compiled before, this "
                    "is a regression.", RuntimeWarning, stacklevel=2)
                vals = [mod.value(zdeps) for mod in
                        self._model_generator(indSteps, priori=priori)]
                return np.array(vals).T
        indVars = (range(len(self.initMod._brownians()))
                   if indVars == "all" else indVars)
        mcParas = (self.MCparas[self.accFinal] if not priori
                   else self.MCparas_pri[self.accFinal])
        return np.array([mc[list(indVars)] for mc in mcParas]).T

    def _batched_values(self, zdeps, thetas, chunk=2048):
        """Vs(zdeps) for a stack of MC parameter vectors, vmapped.

        Replaces the reference's Pool(20).map over per-model rebuilds
        (point.py:319-326) with chunked ``vmap`` of the compiled model's
        grid builder + interpolation — a 24k-step chain evaluates in
        seconds instead of minutes.  Returns (len(zdeps), n_models).
        """
        import jax
        import jax.numpy as jnp

        from pysurfinv_tpu.inversion.compiled import CompiledModel

        if getattr(self, "_cm_post", None) is None:
            self._cm_post = CompiledModel(self.initMod)
        cm = self._cm_post
        zj = jnp.asarray(zdeps)

        n = cm._n_nodes_main  # value() interpolates refLayer=False grids

        @jax.jit
        def batch(th):
            def one(theta):
                z, vs, *_ = cm.build_grids(theta)
                return jnp.interp(zj, z[:n], vs[:n],
                                  left=jnp.nan, right=jnp.nan)
            return jax.vmap(one)(th)

        outs = [np.asarray(batch(jnp.asarray(thetas[i:i + chunk])))
                for i in range(0, len(thetas), chunk)]
        return np.concatenate(outs, axis=0).T

    # ---- plots (capabilities of point.py:177-304; own rendering) --------
    # Styling constants (grey lw=0.1 alpha=0.2 ensembles, the Vs xlim
    # windows, errorbar caps) are kept identical to the reference so
    # figures remain directly comparable with published ones.

    def _sample_accepted(self, k):
        """Up to k randomly drawn accepted-model indices (with
        replacement, like the reference's random.choices)."""
        pool = np.flatnonzero(self.accFinal)
        if len(pool) == 0:
            return np.array([], dtype=int)
        return np.asarray(random.choices(pool,
                                         k=min(k, int(len(pool)))))

    def _ensemble_models(self, k):
        for mod in self._model_generator(self._sample_accepted(k)):
            yield mod

    _SUMMARY_MODS = (("initMod", "Initial"), ("avgMod", "Avg"),
                     ("minMod", "Min"))

    def plotDisp(self, ax=None, ensemble=True):
        """Observed dispersion (error bars) vs initial/avg/min-misfit
        predictions, over a grey accepted-ensemble cloud."""
        import matplotlib.pyplot as plt
        T = np.asarray(self.obs["T"], dtype=float)
        if ax is None:
            ax = plt.figure().gca()
        if ensemble:
            cloud = np.array([m.forward(T)
                              for m in self._ensemble_models(500)])
            if len(cloud):
                ax.plot(T, cloud.T, color="grey", lw=0.1, alpha=0.2)
        ax.errorbar(T, self.obs["c"], self.obs["uncer"], ls="None",
                    color="k", capsize=3, capthick=2, elinewidth=2,
                    label="Observation")
        ax.plot(T, self.initMod.forward(T), label="Initial")
        ax.plot(T, self.avgMod.forward(T), label="Avg accepted")
        ax.plot(T, self.minMod.forward(T), label="Min misfit")
        ax.legend()
        ax.set_title("Dispersion")
        return ax.figure, ax

    def _plot_vs_ensemble(self, drawer, k, xlim, ax=None, cloud=None):
        """Shared scaffold for the Vs-profile plots: initial model,
        grey ensemble, then avg/min overlays.  ``cloud(ax, k) -> bool``
        may draw the whole ensemble in one batched call; the host
        per-model loop is the fallback."""
        import matplotlib.pyplot as plt
        ax = drawer(self.initMod, label="Initial", ax=ax)
        if cloud is None or not cloud(ax, k):
            for mod in self._ensemble_models(k):
                drawer(mod, ax=ax, color="grey", lw=0.1, alpha=0.2)
        drawer(self.avgMod, label="Avg", ax=ax)
        drawer(self.minMod, label="Min", ax=ax)
        ax.set_xlim(*xlim)
        ax.legend()
        plt.sca(ax)
        return ax

    def _grid_ensemble_cloud(self, ax, k):
        """Draw the k-member fine-grid ensemble as ONE LineCollection,
        with every (z(theta), vs(theta)) grid built by a single vmapped
        compiled-model call — seconds instead of the reference's
        minutes of per-model object rebuilds.  Returns False when the
        model family does not compile (host loop takes over)."""
        picks = self._sample_accepted(k)
        if len(picks) == 0:
            return True
        try:
            import jax
            import jax.numpy as jnp
            from matplotlib.collections import LineCollection
            from pysurfinv_tpu.inversion.compiled import CompiledModel

            if getattr(self, "_cm_post", None) is None:
                self._cm_post = CompiledModel(self.initMod)
            cm = self._cm_post
            n = cm._n_nodes_main

            @jax.jit
            def grids(ths):
                def one(t):
                    z, vs, *_ = cm.build_grids(t)
                    return z[:n], vs[:n]
                return jax.vmap(one)(ths)

            zs, vss = map(np.asarray, grids(
                jnp.asarray(np.asarray(self.MCparas[picks], float))))
        except _NONCOMPILABLE_ERRORS as e:  # same policy as _loadValues
            import warnings
            warnings.warn(
                f"batched ensemble drawing failed ({type(e).__name__}: "
                f"{e}); using the slow host loop.", RuntimeWarning,
                stacklevel=2)
            return False
        segs = [np.column_stack([v, z]) for z, v in zip(zs, vss)]
        ax.add_collection(LineCollection(segs, colors="grey",
                                         linewidths=0.1, alpha=0.2))
        return True

    def plotVsProfile(self, allAccepted=False):
        """Layered (staircase) Vs-profile ensemble (point.py:196-205)."""
        def layered(mod, ax=None, **kw):
            return mod.plotProfile(ax=ax, **kw)
        return self._plot_vs_ensemble(layered,
                                      self.N if allAccepted else 2000,
                                      xlim=(3.8, 4.8))

    def plotVsProfileGrid(self, allAccepted=False, ax=None):
        """Fine-grid Vs-profile ensemble (point.py:206-215); the grey
        cloud renders via one batched compiled-model call."""
        def gridded(mod, ax=None, **kw):
            return mod.plotProfileGrid(ax=ax, **kw)
        return self._plot_vs_ensemble(gridded,
                                      self.N if allAccepted else 2000,
                                      xlim=(3.0, 4.8), ax=ax,
                                      cloud=self._grid_ensemble_cloud)

    def plotVsProfileShaded(self):
        """Avg model with a +-1 sigma posterior band (point.py:216-228)."""
        import matplotlib.pyplot as plt
        zdeps = np.linspace(0, 200, 200)
        spread = self._loadValues(zdeps=zdeps).std(axis=1)
        center = self.avgMod.value(zdeps)
        ax = self.initMod.plotProfileGrid(label="Initial", alpha=0.2)
        ax.fill_betweenx(zdeps, center + spread, center - spread,
                         facecolor="grey", alpha=0.6)
        self.avgMod.plotProfileGrid(ax=ax, label="Avg")
        ax.set_xlim(3.0, 4.8)
        ax.legend()
        plt.sca(ax)
        return ax

    def _check_distribution(self, indVars="all", zdeps=None):
        import matplotlib.pyplot as plt
        accYs = self._loadValues(indVars, zdeps, priori=False)
        priYs = (self._loadValues(indVars, zdeps, priori=True)
                 if self.MCparas_pri is not None else None)
        indVars = (range(len(self.initMod._brownians()))
                   if indVars == "all" else indVars)
        titles = ([f"Parameter index {i}" for i in indVars]
                  if zdeps is None else [f"Hist of Vs at {z} km"
                                         for z in zdeps])
        for i, title in enumerate(titles):
            plt.figure()
            if priYs is not None:
                _, bin_edges = np.histogram(priYs[i], bins=30)
                plt.hist(accYs[i], bins=bin_edges,
                         weights=np.ones_like(accYs[i]) / len(accYs[i]),
                         fill=True, ec="k", rwidth=0.8)
                plt.hist(priYs[i], bins=bin_edges,
                         weights=np.ones_like(priYs[i]) / len(priYs[i]),
                         fill=False, ec="k", rwidth=1.0)
            else:
                plt.hist(accYs[i], bins=30)
            plt.title(title)

    def _check_convergency(self, indVars="all", zdeps=None):
        import matplotlib.pyplot as plt
        chainL = self.invMeta["chainL"]
        chainLTests = [int(l) for l in np.linspace(chainL / 10, chainL, 20)]

        def indChainLTest(chainLTest):
            N = len(self.misfits)
            ind = np.zeros(N, dtype=bool)
            i = 0
            while i < N:
                ind[i:i + chainLTest] = True
                i += chainL
            return ind

        indVars = (range(len(self.initMod._brownians()))
                   if indVars == "all" else indVars)
        nVars = len(list(indVars)) if zdeps is None else len(zdeps)
        yMean = np.zeros([nVars, len(chainLTests)])
        yStd = np.zeros([nVars, len(chainLTests)])
        for j, cl in enumerate(chainLTests):
            ind = indChainLTest(cl)
            thres = self._thres(self.misfits[ind].min())
            accInd = np.where((self.misfits < thres) * ind)[0]
            values = self._loadValues(indVars, zdeps, accInd)
            yMean[:, j] = values.mean(axis=1)
            yStd[:, j] = values.std(axis=1)
        plt.figure()
        for i in range(nVars):
            plt.plot(chainLTests, yMean[i])
        plt.title("Mean")
        plt.figure()
        for i in range(nVars):
            plt.plot(chainLTests, yStd[i])
        plt.title("Standard Deviation")

    def _check_history(self, yType="ksquare"):
        import matplotlib.pyplot as plt
        plt.figure()
        if yType == "ksquare":
            y = self.misfits**2 * len(self.obs["T"])
            thres = self.thres**2 * len(self.obs["T"])
        elif yType == "likelihood":
            y, thres = self.Ls, None
        elif yType == "misfit":
            y, thres = self.misfits, self.thres
        else:
            raise ValueError(f"Unsupported type of y: {yType}")
        plt.plot(y)
        ind = np.where(self.accepts.astype(bool))[0]
        plt.plot(ind, y[ind], "or")
        if thres:
            plt.plot([0, self.N], [thres, thres], "--g")


class PostPointCascadia(PostPoint):
    misfit = PointCascadia.misfit
