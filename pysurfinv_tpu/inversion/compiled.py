"""Compile a Model1D into pure JAX functions of (theta, psi).

The reference rebuilds Python layer objects for every MCMC proposal
(``/root/reference/models.py:192-219`` + ``layers.py:64-79``), costing as
much as the physics.  Here a model's *structure* (layer types, fine-grid
sizes, group layout, which parameters are stochastic) is frozen once,
and everything value-dependent becomes pure functions of two vectors:

  * ``theta`` — the stochastic (Brownian) parameters, in the reference's
    ``_brownians`` order (models.py:240-253);
  * ``psi``   — the fixed numeric constants that differ between grid
    points (water depth, sediment thickness, lithospheric age, topo, ...
    injected by ``_loadLocalInfo``) — so ONE compiled program serves an
    entire geographic grid, vmapped over points and sharded over chips.

Exposed functions::

    build_profile(theta, psi) -> padded (h, vp, vs, rho, qsinv) stack
    isgood(theta, psi)        -> bool (vectorised prior mask)
    forward(theta, periods, psi) -> c(P,) fundamental-mode curve

Frozen-structure deviations from the reference (documented, statistical
impact negligible):
  * per-layer fine-grid counts are locked to the initial model's values
    (the reference adapts them to the current H, layers.py:161-173);
  * layers never vanish mid-chain (the reference drops layers whose
    current H < 0.01, models.py:80);
  * the hybrid layer's melt-onset spline merge uses a Hermite bridge
    (see models/layers.py).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pysurfinv_tpu.models.brownian import BrownianVar
from pysurfinv_tpu.models.layers import OceanMantleHybrid
from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward

# parm keys that select static structure and must never become traced
_STATIC_KEYS = {"deg", "Conversion"}
# info keys whose numeric values vary per grid point
_INFO_KEYS = ("topo", "lithoAge")


class BrownianSpec(NamedTuple):
    """Flattened stochastic-parameter metadata (device arrays)."""

    theta0: jnp.ndarray
    vmin: jnp.ndarray
    vmax: jnp.ndarray
    step: jnp.ndarray


def _walk_brownians(layers):
    """Yield (layer_idx, key, list_idx_or_None, var) in _brownians order
    (models.py:240-253)."""
    for li, layer in enumerate(layers):
        for k, v in layer.parm.items():
            if type(v) is list:
                for i, e in enumerate(v):
                    if isinstance(e, BrownianVar):
                        yield li, k, i, e
            elif isinstance(v, BrownianVar):
                yield li, k, None, v


def _is_plain_number(v):
    return isinstance(v, (int, float)) and not isinstance(v, bool) \
        and not isinstance(v, BrownianVar)


def _walk_consts(layers):
    """Yield (layer_idx, key, list_idx_or_None, value) for fixed numeric
    parameters (the per-grid-point constants)."""
    for li, layer in enumerate(layers):
        for k, v in layer.parm.items():
            if k in _STATIC_KEYS:
                continue
            if type(v) is list:
                for i, e in enumerate(v):
                    if _is_plain_number(e):
                        yield li, k, i, e
            elif _is_plain_number(v):
                yield li, k, None, v


class CompiledModel:
    """Freeze a Model1D's structure; expose (theta, psi)-pure functions."""

    def __init__(self, model, pad_align=8):
        # the structure freeze below walks every layer's host-eager
        # build: thousands of tiny eager ops, each a kernel launch on
        # an accelerator, so pin them to the host CPU
        from ..utils import host_eager
        with host_eager():
            self._init(model, pad_align)

    def _init(self, model, pad_align):
        self.model = model.copy()
        self.info = dict(model.info)
        layers = self.model.layers
        self._slots = list(_walk_brownians(layers))
        self._const_slots = list(_walk_consts(layers))
        self.spec = self.spec_of(self.model)
        self.psi0 = self.psi_of(self.model)
        self.ntheta = len(self._slots)

        # ---- freeze structure off the initial model --------------------
        self._use_ref = bool(self.info.get("refLayer", False))
        self._layers = list(layers) + (
            [self.model._refLayer] if self._use_ref else [])
        self._n_main = len(layers)
        # the reference layer's constants are global (H=300, slope), not
        # per-point; keep them out of psi by only walking main layers.

        # fine-grid sizes + static group layout from one host build
        self._nfine = []
        grp_nodes, name_nodes = [], []
        hctx = _HostCtx(self.info)
        for layer in self._layers:
            nf = self._static_nfine(layer, hctx)
            self._nfine.append(nf)
            out = layer.seisPropGrids(layersAbove=hctx.layersAbove(),
                                      modelInfo=self.info, nFine=nf)
            hctx.push(layer, [np.asarray(x) for x in out])
            npts = len(np.asarray(out[0]))
            grp_nodes += [layer.prop["Group"]] * npts
            name_nodes += [layer.prop["LayerName"]] * npts
        self.grp_nodes = np.array(grp_nodes)
        self.name_nodes = np.array(name_nodes)
        self._node_counts = [nf + 1 for nf in self._nfine]
        # isgood uses refLayer=False grids (models.py:575)
        self._n_nodes_main = int(sum(self._node_counts[: self._n_main]))
        self._n_nodes = int(sum(self._node_counts))

        # padded layer-stack length for the solver
        n_rows = self._n_nodes - 1  # midpoints across the full stack
        self.L = int(-(-n_rows // pad_align) * pad_align)

        self._grp_ids_main = _codes(self.grp_nodes[: self._n_nodes_main])
        # node -> main-layer index + layer node spans, for the traced
        # thin-layer (h < 0.01) drop that mirrors seisPropGrids'
        # hLowerLimit compaction (models.py:80)
        starts = np.concatenate(
            [[0], np.cumsum(self._node_counts[: self._n_main])])[:-1]
        self._node_starts_main = starts.astype(np.int32)
        self._node_ends_main = (
            starts + np.array(self._node_counts[: self._n_main]) - 1
        ).astype(np.int32)
        self._layer_of_node_main = np.repeat(
            np.arange(self._n_main, dtype=np.int32),
            self._node_counts[: self._n_main])
        self._cfg = SurfConfig()

    # ---- per-point parameter extraction --------------------------------
    def spec_of(self, model) -> BrownianSpec:
        """BrownianSpec of a same-structure model (per-point bounds)."""
        bs = [s[3] for s in _walk_brownians(model.layers)]
        if hasattr(self, "_slots") and len(bs) != len(self._slots):
            raise ValueError("model structure mismatch (theta size)")
        # numpy (not device) arrays: spec extraction runs per grid
        # point on the host and the values feed jit through device_put
        dt = np.float64 if jax.config.jax_enable_x64 else np.float32
        return BrownianSpec(
            theta0=np.array([float(b) for b in bs], dt),
            vmin=np.array([b.vmin for b in bs], dt),
            vmax=np.array([b.vmax for b in bs], dt),
            step=np.array([b.step for b in bs], dt))

    def psi_of(self, model):
        """Fixed-constant vector of a same-structure model."""
        cs = [s[3] for s in _walk_consts(model.layers)]
        if hasattr(self, "_const_slots") and len(cs) != len(self._const_slots):
            raise ValueError("model structure mismatch (psi size)")
        info = model.info or {}
        extra = [float(info.get(k, 0) or 0) for k in _INFO_KEYS]
        dt = np.float64 if jax.config.jax_enable_x64 else np.float32
        return np.array([float(c) for c in cs] + extra, dt)

    @staticmethod
    def _static_nfine(layer, hctx):
        try:
            return layer._nFineLayers(layersAbove=hctx.layersAbove(),
                                      modelInfo=hctx.info)
        except (NotImplementedError, AttributeError, TypeError):
            return 1

    # ------------------------------------------------------------------
    def _substitute(self, theta, psi):
        """Layer parms with Brownians -> theta[i] and consts -> psi[j]."""
        parms = [dict(l.parm) for l in self._layers]
        for p in parms:
            for k, v in list(p.items()):
                if type(v) is list:
                    p[k] = list(v)
        for j, (li, k, ei, _) in enumerate(self._const_slots):
            if ei is None:
                parms[li][k] = psi[j]
            else:
                parms[li][k][ei] = psi[j]
        for i, (li, k, ei, _) in enumerate(self._slots):
            if ei is None:
                parms[li][k] = theta[i]
            else:
                parms[li][k][ei] = theta[i]
        return parms

    def _info_traced(self, psi):
        info = dict(self.info)
        nc = len(self._const_slots)
        for ix, k in enumerate(_INFO_KEYS):
            if k in info and info[k] is not None:
                info[k] = psi[nc + ix]
        return info

    def build_grids(self, theta, psi=None, vs_only=False):
        """(theta, psi) -> concatenated node grids (z, vs, vp, rho, qs, qp).

        ``vs_only=True`` skips every layer's ``_calOthers`` (vp/rho/qs/qp
        come back as zeros) — the prior fast path: no ``_calVs`` reads
        anything but the z/vs context (checked across the layer catalog),
        so z and vs are bitwise identical to the full build.
        """
        psi = self.psi0 if psi is None else psi
        parms = self._substitute(theta, psi)
        info = self._info_traced(psi)
        dtype = theta.dtype
        z_parts, parts = [], {k: [] for k in ("vs", "vp", "rho", "qs", "qp")}
        nc = len(self._const_slots)
        topo = (psi[nc + _INFO_KEYS.index("topo")]
                if self.info.get("topo") is not None else 0.0)
        z_last = -jnp.maximum(jnp.asarray(topo, dtype), 0.0)
        last = {k: jnp.zeros((), dtype) for k in parts}
        crustH = jnp.zeros((), dtype)
        for layer, parm, nf in zip(self._layers, parms, self._nfine):
            lay = layer.copy()
            lay.parm = parm
            layersAbove = [jnp.array([z_last])] + \
                [jnp.array([last[k]]) for k in ("vs", "vp", "rho", "qs", "qp")] \
                + [None, None]
            kwargs = dict(layersAbove=layersAbove, modelInfo=info, nFine=nf,
                          vs_only=vs_only)
            if isinstance(lay, OceanMantleHybrid):
                kwargs["crustH"] = crustH
            z1, vs1, vp1, rho1, qs1, qp1 = lay.seisPropGrids(**kwargs)
            z_abs = jnp.asarray(z1, dtype) + z_last
            z_parts.append(z_abs)
            for k, arr in zip(("vs", "vp", "rho", "qs", "qp"),
                              (vs1, vp1, rho1, qs1, qp1)):
                arr = jnp.asarray(arr, dtype) * jnp.ones_like(z_abs)
                parts[k].append(arr)
                last[k] = arr[-1]
            if layer.prop["Group"] == "crust":
                crustH = crustH + (z_abs[-1] - z_last)
            z_last = z_abs[-1]
        z = jnp.concatenate(z_parts)
        out = {k: jnp.concatenate(v) for k, v in parts.items()}
        return z, out["vs"], out["vp"], out["rho"], out["qs"], out["qp"]

    def build_profile(self, theta, psi=None):
        """(theta, psi) -> padded (h, vp, vs, rho, qsinv, nlay) stack.

        Midpoint averaging as in models.py:93-102; interface rows (h = 0)
        are exact identities in the secular recursion, so no compaction
        is needed.
        """
        z, vs, vp, rho, qs, qp = self.build_grids(theta, psi)
        h = jnp.diff(z)
        mid = lambda x: 0.5 * (x[1:] + x[:-1])  # noqa: E731
        vs, vp, rho, qs = mid(vs), mid(vp), mid(rho), mid(qs)
        # thin rows -> identity (reference drops h <= 0.01, models.py:102)
        thin = h <= 0.01
        h = jnp.where(thin, 0.0, h)
        pad = self.L - h.shape[0]
        hs = lambda x: jnp.concatenate(  # noqa: E731
            [x, jnp.full(pad, x[-1], x.dtype)])
        h_p = jnp.concatenate([h, jnp.zeros(pad, h.dtype)])
        qsinv = 1.0 / qs
        nlay = h.shape[0]  # static: halfspace is the last real row
        return h_p, hs(vp), hs(vs), hs(rho), hs(qsinv), nlay

    def build_profile_batch(self, thetas, psis=None):
        """vmapped :meth:`build_profile` for a (N, ntheta) stack.

        Returns (h, vp, vs, rho, qsinv) of shape (N, L) plus an (N,)
        int32 nlay vector — the layout ``surf_forward_batch`` consumes,
        which routes through the fused secular kernels on a GPU.
        """
        import jax

        N = thetas.shape[0]
        psis = (jnp.broadcast_to(self.psi0, (N,) + self.psi0.shape)
                if psis is None else psis)
        h, vp, vs, rho, qsi = jax.vmap(
            lambda th, ps: self.build_profile(th, ps)[:5])(thetas, psis)
        nlay = jnp.full((N,), self._n_nodes - 1, jnp.int32)
        return h, vp, vs, rho, qsi, nlay

    # ------------------------------------------------------------------
    def isgood(self, theta, psi=None):
        """Vectorised prior (CascadiaOcean.isgood, models.py:571-677)."""
        from pysurfinv_tpu.inversion import priors as P

        n = self._n_nodes_main
        # vs-only build: the priors below read nothing but (z, vs), so
        # _calOthers (notably the hybrid layer's second HSCM + Ruan Qs
        # pass) is skipped.  Measured runtime-NEUTRAL on chip (A/B
        # base vs PYSURFINV_ISGOOD_FULL=1: 44.4-45.6k solves/s both
        # ways — XLA already dead-code-eliminates the unused outputs
        # inside the jitted retry loop); the value is a smaller traced
        # graph and compiled program for the sampler (the remote
        # compile service rejects very large programs, and isgood is
        # traced inside every proposal retry round).
        vs_only = os.environ.get("PYSURFINV_ISGOOD_FULL") != "1"
        z, vs, *_ = self.build_grids(theta, psi, vs_only=vs_only)
        z, vs = z[:n], vs[:n]
        grp = jnp.asarray(self._grp_ids_main)
        sed = jnp.asarray(self.grp_nodes[:n] == "sediment")
        crust = jnp.asarray(self.grp_nodes[:n] == "crust")
        mantle = jnp.asarray(self.grp_nodes[:n] == "mantle")

        # traced thin-layer drop: the host path checks the compacted
        # grid (layers with current H < 0.01 removed, models.py:80);
        # nodes of dropped layers must not participate in any prior
        h_layer = (z[jnp.asarray(self._node_ends_main)]
                   - z[jnp.asarray(self._node_starts_main)])
        keep = (h_layer > 0.01)[jnp.asarray(self._layer_of_node_main)]

        checks = [
            jnp.all(jnp.where(sed & keep, vs >= 0.2, True)),
            P.jnp_group_jumps_positive(vs, grp, keep=keep),
            # non-strict: see models/model1d.py monoNonDecrease rationale
            P.jnp_mono_increase(vs, sed & keep, eps=-1e-12),
            P.jnp_mono_increase(vs, crust & keep, eps=-1e-12),
            (vs[-1] - vs[-2]) / jnp.maximum(z[-1] - z[-2], 1e-9) > 0,
        ]
        model_type = type(self.model).__name__
        if model_type in ("CascadiaPrism", "CascadiaContinent"):
            checks.append(jnp.all(vs < 4.9))
        if "Ocean" in model_type:
            vsM = jnp.where(mantle, vs, 0.0)
            nM = jnp.sum(mantle)
            meanM = jnp.sum(vsM) / jnp.maximum(nM, 1)
            checks.append(P.jnp_local_extrema_oscillation(
                vs, mantle, 0.1 * meanM))
            checks.append(P.jnp_no_local_max(vs, mantle))
            # slope prior + CWT oscillation on the mantle sub-grid
            i0 = int(np.argmax(self.grp_nodes[:n] == "mantle"))
            zM, vM = z[i0:n], vs[i0:n]
            slope = jnp.diff(vM) / jnp.maximum(jnp.diff(zM), 1e-9)
            checks.append(slope.min() >= slope[0] * 1.5)
            checks.append(P.jnp_cwt_oscillation(
                vM, zM, jnp.ones(vM.shape[0], bool), limit=0.3))
        ok = checks[0]
        for c in checks[1:]:
            ok = ok & c
        return ok

    # ------------------------------------------------------------------
    def forward(self, theta, periods, psi=None, wave="rayleigh", cfg=None):
        """(theta, psi) -> fundamental-mode phase velocities (0 = failed)."""
        cfg = cfg or self._cfg
        h, vp, vs, rho, qsinv, nlay = self.build_profile(theta, psi)
        c, u, ok = surf_forward(h, vp, vs, rho, qsinv, periods, nlay,
                                wave=wave, cfg=cfg._replace(nmodes=1))
        return jnp.where(ok[:, 0], c[:, 0], 0.0)


class _HostCtx:
    """Accumulates layersAbove context for the host structure pass."""

    def __init__(self, info):
        self.info = info
        self.z = [-max(info.get("topo", 0) or 0, 0)]
        self.cols = {k: [0.0] for k in ("vs", "vp", "rho", "qs", "qp")}
        self.grp, self.names = [], []

    def layersAbove(self):
        return [np.array(self.z)] + \
            [np.array(self.cols[k]) for k in ("vs", "vp", "rho", "qs", "qp")] \
            + [list(self.grp), list(self.names)]

    def push(self, layer, out):
        z1 = np.asarray(out[0], dtype=float) + self.z[-1]
        self.z += list(z1)
        for k, arr in zip(("vs", "vp", "rho", "qs", "qp"), out[1:]):
            self.cols[k] += list(np.asarray(arr, dtype=float)
                                 * np.ones_like(z1))
        self.grp += [layer.prop["Group"]] * len(z1)
        self.names += [layer.prop["LayerName"]] * len(z1)


def _codes(strings):
    """Consecutive-run integer codes so boundaries = value changes."""
    codes = np.zeros(len(strings), dtype=np.int32)
    c = 0
    for i in range(1, len(strings)):
        if strings[i] != strings[i - 1]:
            c += 1
        codes[i] = c
    return codes
