"""Density-level kernel parity vs TEST1 — the tight (<2%) gate.

tests/test_kernel_golden.py compares our AD *layer-integral* kernels
against layer integrals of the golden densities; the residual there is
the AD-vs-eigenfunction formulation gap plus the golden's own sampling
error, and its gates sit at 8-35% (documented per column).  This module
closes that gap by comparing the SAME formulation instead:
:func:`~pysurfinv_tpu.ops.kernels.kernel_densities` rebuilds the
reference's variational density product (``PHV_SENS_KERNEL.f:168-182``,
``GRV_SENS_KERNEL.f:100-108``) from OUR eigenfunctions, so the
comparison against the golden ``test.phv.*``/``test.grv.*`` tables is
point-by-point at the golden's own 2-km grid with ~1% ceilings.

Exclusions, with evidence:
  * depths > 200 km (the golden generator's spherical-lookup-at-
    flattened-depth mismatch, see test_kernel_golden.py:96);
  * R mode 1 T=20 s (R1/R2 osculation: golden root is ~9e-4 off our
    secular root — test_eigen.py:112);
  * the group Rho column (the reference's demonstrated dlnT sign bug,
    test_kernel_golden.test_grv_rho_sign_bug_demonstrated — our
    implementation uses the sign-correct identity).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pysurfinv_tpu.ops.dispersion import SurfConfig
from pysurfinv_tpu.ops.kernels import kernel_densities

pytestmark = pytest.mark.slow  # two eigen+integral programs per wave

COLS = {"R": ("Kvs", "Kvp", "Krho"), "L": ("Kvs", "Krho")}
DEPTH_CAP = 200.0

# Ceilings in units of the golden column's max |value|, measured:
# phase densities land at ~2e-3 (mode 0) / ~5e-3 (mode 1, injected
# roots); group densities add the dlnT finite difference of two
# independent solves on top (~2x).
PHV_TOL = {0: 0.01, 1: 0.02}
GRV_TOL = 0.02


def _args(m):
    return (jnp.array(m["h"]), jnp.array(m["vp"]), jnp.array(m["vs"]),
            jnp.array(m["rho"]), jnp.array(m["qsinv"]))


@pytest.fixture(scope="module", params=["R", "L"])
def dens(request, eus_model, golden):
    wt = request.param
    m = eus_model
    wave = "rayleigh" if wt == "R" else "love"
    periods = jnp.asarray(np.asarray(m["periods"], float))
    cg = np.full((len(m["periods"]), 2), -1.0)
    for mm in (0, 1):
        for ip, T in enumerate(int(t) for t in m["periods"]):
            k = f"eig_{wt}_{mm}_{T}_hdr"
            if k in golden.files:
                cg[ip, mm] = golden[k][1]
    out = kernel_densities(*_args(m), periods, m["nlay"], wave=wave,
                           cfg=SurfConfig(nmodes=2), dz=2.0, nz=500,
                           group=True, c_given=jnp.asarray(cg))
    return wt, out


def _check(golden, wt, out, kind, mode, tol):
    names = {"phv": COLS[wt], "grv": tuple("G" + c[1:] for c in COLS[wt]
                                           if c != "Krho")}
    checked = 0
    for ip, T in enumerate((10, 20, 30, 40, 50, 60, 70, 80, 90, 100)):
        if wt == "R" and mode == 1 and T == 20:
            continue  # osculation (see module docstring)
        key = f"k{kind}_{wt}_{mode}_{T}"
        if key not in golden.files:
            continue
        arr = golden[key]
        zg = arr[:, 0]
        sel = (zg <= DEPTH_CAP) & (zg > 0)   # z=0 row: header quirk
        ii = np.round(zg[sel] / 2.0).astype(int)
        for icol, name in enumerate(names[kind]):
            ref = arr[sel, 1 + icol]
            ours = np.asarray(out[name])[ip, mode][ii]
            err = np.abs(ours - ref).max() / np.abs(arr[:, 1 + icol]).max()
            assert err < tol, f"{wt} {kind} m{mode} T={T} {name}: {err:.2e}"
            checked += 1
    return checked


@pytest.mark.parametrize("mode", [0, 1])
def test_phase_densities_vs_test1(dens, golden, mode):
    wt, out = dens
    n = _check(golden, wt, out, "phv", mode, PHV_TOL[mode])
    assert n >= 8 * len(COLS[wt])


def test_group_densities_vs_test1(dens, golden):
    """Fundamental mode (the golden's dlnT difference degrades near
    overtone osculation); Vs (+Vp for R) only — Rho excluded for the
    reference's sign bug."""
    wt, out = dens
    n = _check(golden, wt, out, "grv", 0, GRV_TOL)
    assert n >= 8


def test_senskernel_eigen_method():
    """SensKernel(method='eigen') exposes the density product through
    the reference-shaped wrapper API."""
    import pandas as pd

    from pysurfinv_tpu.senskernel import SensKernel

    df = pd.DataFrame({
        "H": [3.0, 10.0, 20.0, 0.0], "Vp": [5.0, 6.1, 8.1, 8.2],
        "Vs": [2.9, 3.6, 4.6, 4.7], "Rho": [2.6, 2.9, 3.3, 3.35],
        "Qs": [80.0, 350.0, 150.0, 150.0]})
    sk = SensKernel(model=df, wtype="R", Tmin=10, Tmax=30, Tstep=10,
                    endmode=0, dz=2, method="eigen")
    assert sk.kernel_phv.shape[:2] == (1, 3)
    assert np.isfinite(sk.kernel_phv).all()
    assert np.isfinite(sk.kernel_grv).all()
    assert (sk.c > 0).all() and (sk.u > 0).all()
    # Vs phase density integrates to ~the normalized total sensitivity:
    # sum_z K dz ~ O(0.3-1) for a fundamental-mode crustal model
    tot = (sk.kernel_phv[0, 0] * 2.0).sum(axis=-1)
    assert (tot > 0.1).all() and (tot < 2.0).all()
