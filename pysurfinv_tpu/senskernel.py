"""Depth sensitivity kernels — the senskernel-1.0 package, in JAX.

Capability spec from ``/root/reference/senskernel.py`` and the Fortran
pipeline it shells out to (``senskernel-1.0/KERNELS.csh``: 3x
SURF_PERTURB -> 3x PHV_SENS_KERNEL -> GRV_SENS_KERNEL).  The whole
7-subprocess, file-based pipeline collapses to one differentiable JAX
call (ops/kernels.py):

  * phase kernels  — implicit differentiation replaces the eigenfunction
    algebra (PHV_SENS_KERNEL.f:168-182);
  * group kernels  — AD through the group-velocity formula replaces the
    dlnT finite difference over perturbed-period reruns
    (GRV_SENS_KERNEL.f:100-108);
  * multi-mode     — overtone roots from the warm-started mode search.

Outputs use the reference's normalization: per-depth kernel densities
``(dc/d par)(z) * par(z) / c`` on a regular dz grid — layer-integrated AD
kernels divided by layer thickness (the input, spherical-model thickness,
matching SensKernelPert's normalization convention).

``SensKernelPert`` is kept as the independent finite-difference
cross-check, exactly as the reference maintains both implementations
(SURVEY.md §4.3).
"""

from __future__ import annotations

import numpy as np


def _load_model(model):
    import pandas as pd
    if model is None:
        # default kernel model, as the reference defaults to its bundled
        # PREM table (senskernel.py:6-11) — ours is regenerated from the
        # published PREM polynomials (data/prem.py)
        from pysurfinv_tpu.data.prem import prem_model
        return prem_model()
    if isinstance(model, str):
        return pd.read_csv(model)
    return model.copy()


class sensModel:
    """Model wrapper with group-based Vp/Rho/Qs fill-in
    (senskernel.py:88-128)."""

    def __init__(self, df):
        self._df = df.copy()
        self.H = df["H"]
        self.Vs = df["Vs"]
        self.Grp = df.get("Grp", None)

    @property
    def Vp(self):
        return self._df.get("Vp", self._convert()[0])

    @property
    def Rho(self):
        return self._df.get("Rho", self._convert()[1])

    @property
    def Qs(self):
        return self._df.get("Qs", self._convert()[2])

    def _convert(self):
        if self.Grp is None:
            return None, None, None
        n = len(self.H)
        Vp, Rho, Qs = np.zeros(n), np.zeros(n), np.zeros(n)
        for i, grp in enumerate(self.Grp):
            if grp == "water":
                Vp[i], Rho[i], Qs[i] = 1.475, 1.027, 10000
            elif grp == "sediment":
                Vp[i] = self.Vs[i] * 1.23 + 1.28
                Rho[i] = 0.541 + 0.3601 * Vp[i]
                Qs[i] = 80
            elif grp == "crust":
                Vp[i] = self.Vs[i] * 1.8
                Rho[i] = 0.541 + 0.3601 * Vp[i]
                Qs[i] = 350
            elif grp == "mantle":
                Vp[i] = self.Vs[i] * 1.76
                Rho[i] = 3.4268 + (self.Vs[i] - 4.5) / 4.5
                Qs[i] = 150
        return Vp, Rho, Qs

    def copy(self):
        from copy import deepcopy
        return deepcopy(self)


def _padded(model):
    from pysurfinv_tpu.models.model1d import padded_profile
    h = np.asarray(model.H, float)
    vs = np.asarray(model.Vs, float)
    vp = np.asarray(model.Vp, float)
    rho = np.asarray(model.Rho, float)
    qs = np.asarray(model.Qs, float)
    return padded_profile(h, vs, vp, rho, qs)


class SensKernel:
    """Analytic (AD) phase + group kernels on a regular depth grid.

    Mirrors the reference class (senskernel.py:8-86): ``kernel_phv`` /
    ``kernel_grv`` have shape (endmode+1, nCol, nPeriods, nDepths) with
    columns (Vs, Vp, Rho) for Rayleigh and (Vs, Rho) for Love, each
    normalized as (dc/dpar) * par / c per km of depth.

    ``method``: "ad" (default) spreads the implicit-diff AD layer
    kernels uniformly over each layer — exact layer integrals, layer-
    constant densities.  "eigen" instead computes the reference's
    pointwise variational densities from eigenfunctions
    (:func:`~pysurfinv_tpu.ops.kernels.kernel_densities`, the
    PHV/GRV_SENS_KERNEL product, golden-validated to ~1% —
    tests/test_kernel_density_golden.py); use it when comparing
    against reference kernel files sample-by-sample.
    """

    def __init__(self, model=None, wtype="R", Tmin=20, Tmax=100, Tstep=10,
                 endmode=0, dz=2, method="ad"):
        import jax.numpy as jnp
        from pysurfinv_tpu.ops.dispersion import SurfConfig
        from pysurfinv_tpu.ops.kernels import (kernel_densities,
                                               sensitivity_kernels)

        self.model = _load_model(model)
        if wtype == "R":
            self.xtype = ["Vs", "Vp", "Rho"]
            wave = "rayleigh"
        elif wtype == "L":
            self.xtype = ["Vs", "Rho"]
            wave = "love"
        else:
            raise ValueError("Wrong surface wave type!")
        nCol = len(self.xtype)
        self.wtype = wtype
        self.zdeps = np.arange(0, self.model["H"].sum(), dz)
        self.periods = range(Tmin, Tmax + Tstep // 2, Tstep)
        nper = len(self.periods)
        M = endmode + 1
        self.kernel_phv = np.full((M, nCol, nper, len(self.zdeps)), np.nan)
        self.kernel_grv = np.full((M, nCol, nper, len(self.zdeps)), np.nan)

        sm = sensModel(self.model)
        H, VP, VS, RHO, QSI, nlay = _padded(sm)
        if method == "eigen":
            out = kernel_densities(
                jnp.asarray(H), jnp.asarray(VP), jnp.asarray(VS),
                jnp.asarray(RHO), jnp.asarray(QSI),
                jnp.asarray(np.array(list(self.periods), float)), nlay,
                wave=wave, cfg=SurfConfig(nmodes=M), dz=dz,
                nz=len(self.zdeps), group=True)
            self.result = out
            self.c = np.asarray(out["c"]).reshape(nper, M)
            self.u = np.asarray(out["u"]).reshape(nper, M)
            cols = {"Vs": "vs", "Vp": "vp", "Rho": "rho"}
            for icol, name in enumerate(self.xtype):
                kk = "K" + cols[name]
                gk = "G" + cols[name]
                for m in range(M):
                    self.kernel_phv[m, icol] = np.asarray(out[kk])[:, m]
                    self.kernel_grv[m, icol] = np.asarray(out[gk])[:, m]
            return
        res = sensitivity_kernels(
            jnp.asarray(H), jnp.asarray(VP), jnp.asarray(VS),
            jnp.asarray(RHO), jnp.asarray(QSI),
            jnp.asarray(np.array(list(self.periods), float)), nlay,
            wave=wave, cfg=SurfConfig(nmodes=M), group=True)
        self.result = res

        def grab(a, ip, m):
            a = np.asarray(a)
            return a[ip] if M == 1 else a[ip, m]

        h_in = H[:nlay]
        vs_in, vp_in, rho_in = VS[:nlay], VP[:nlay], RHO[:nlay]
        # depth -> input layer index
        tops = np.concatenate([[0.0], np.cumsum(h_in)])
        iz = np.clip(np.searchsorted(tops, self.zdeps, side="right") - 1,
                     0, nlay - 1)
        h_of_z = np.where(h_in[iz] > 0, h_in[iz], 1.0)

        c = np.asarray(res.c).reshape(nper, M)
        u = np.asarray(res.u).reshape(nper, M)
        self.c, self.u = c, u
        for m in range(M):
            for ip in range(nper):
                cc = c[ip, m] if c[ip, m] > 0 else np.nan
                rows_p = {"Vs": grab(res.dc_dvs, ip, m),
                          "Vp": grab(res.dc_dvp, ip, m),
                          "Rho": grab(res.dc_drho, ip, m)}
                rows_g = {"Vs": grab(res.du_dvs, ip, m),
                          "Vp": grab(res.du_dvp, ip, m),
                          "Rho": grab(res.du_drho, ip, m)}
                pars = {"Vs": vs_in, "Vp": vp_in, "Rho": rho_in}
                for icol, name in enumerate(self.xtype):
                    kd = rows_p[name][:nlay][iz] / h_of_z
                    self.kernel_phv[m, icol, ip] = \
                        kd * np.asarray(pars[name])[iz] / cc
                    kdg = rows_g[name][:nlay][iz] / h_of_z
                    uu = u[ip, m] if u[ip, m] > 0 else np.nan
                    self.kernel_grv[m, icol, ip] = \
                        kdg * np.asarray(pars[name])[iz] / uu

    def plot(self, mode=0, per=None, ytype="phv", xtype="Vs"):
        import matplotlib.pyplot as plt
        kernel = {"phv": self.kernel_phv, "grv": self.kernel_grv}[ytype]
        ix = self.xtype.index(xtype)
        plt.subplots(1, 1, figsize=[6, 8])
        for ip, per in enumerate(self.periods):
            plt.plot(kernel[mode, ix, ip, :], self.zdeps, label=f"{per}s")
        plt.gca().invert_yaxis()
        plt.legend()


class SensKernelPert:
    """Finite-difference kernels through the forward solver — the
    independent cross-check (senskernel.py:129-206)."""

    def __init__(self, model=None, wtype="R", Tmin=20, Tmax=100, Tstep=10,
                 dz=2):
        self.df = _load_model(model)
        self.model = sensModel(self.df)
        self.wtype = wtype
        self.periods = range(Tmin, Tmax + Tstep // 2, Tstep)

        self.kernel = {}
        n = len(self.model.H)
        self.kernel["Vs"] = np.zeros((len(self.periods), n))
        for i in range(n):
            vL = self._forward(self._perturb(i, pert=0.999))
            vH = self._forward(self._perturb(i, pert=1.001))
            self.kernel["Vs"][:, i] = (vH - vL) / 0.2 / self.model.H[i]

        if "Vp" in self.df.keys():
            self.kernel["Vp"] = np.zeros((len(self.periods), n))
            for i in range(n):
                vL = self._forward(self._perturb(i, pert=0.999, xtype="Vp"))
                vH = self._forward(self._perturb(i, pert=1.001, xtype="Vp"))
                self.kernel["Vp"][:, i] = (vH - vL) / 0.2 / self.model.H[i]

    def _perturb(self, ilayer, pert=1.0, xtype="Vs"):
        model = self.model.copy()
        if xtype == "Vs":
            model.Vs[ilayer] *= pert
        else:
            model._df[xtype][ilayer] *= pert
        return model

    def _forward(self, model=None):
        import jax.numpy as jnp
        from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward

        model = self.model if model is None else model
        wave = {"R": "rayleigh", "L": "love"}[self.wtype]
        H, VP, VS, RHO, QSI, nlay = _padded(model)
        c, u, ok = surf_forward(
            jnp.asarray(H), jnp.asarray(VP), jnp.asarray(VS),
            jnp.asarray(RHO), jnp.asarray(QSI),
            jnp.asarray(np.array(list(self.periods), float)), nlay,
            wave=wave, cfg=SurfConfig())
        c = np.asarray(c[:, 0])
        return None if np.any(c < 0.01) else c

    def plot(self, per=None, ytype="phv", xtype="Vs"):
        import matplotlib.pyplot as plt
        plt.subplots(1, 1, figsize=[6, 8])
        zdeps = self.model.H.cumsum() - self.model.H / 2
        for ip, per in enumerate(self.periods):
            plt.plot(self.kernel[xtype][ip, :], zdeps, label=f"{per}s")
        plt.gca().invert_yaxis()
        plt.legend()
