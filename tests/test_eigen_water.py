"""Liquid-top (ocean) Rayleigh eigenfunctions + energy integrals.

The reference's REIGEN handles a surface
water column analytically — cosh/sinh acoustic field matched at the
water/solid interface (``fast_surf_src/surfa.f:876-911``), closed trig
energy-integral contributions (``surfa.f:1028-1050``), and an
interface-started output table (``SURF_PERTURB/surfa.f:1375-1379``).
The rebuild covers the same physics with its generic machinery (an
embedded 4x4 acoustic system + impedance coupling, `ops/eigen.py`),
so the validation is three-way:

1. **Structural invariants** on a simple water-over-crust model:
   free-surface pressure = 0, unit uz at the interface, interface
   ellipticity == the independent DLTAR mup=2 liquid-branch value,
   integral-path group velocity == implicit-diff group velocity,
   Lagrangian ~ 0 at the root (impossible if the water energy terms
   were missing: they are O(10-80%) of I0 here).

2. **Verbatim-convention golden**: the reference's closed trig forms
   (``surfa.f:1028-1050`` sumi0..3 + the ``tzz`` impedance,
   re-derived symbol-for-symbol below with complex arithmetic) must
   equal our Boole-quadrature water partials ``I*_wat`` and the
   solid-top stress ratio.  No runnable Fortran exists in this image,
   so the formulas themselves are the golden.

3. **The flagship ocean fixture** (Cascadia point model, water +
   sediment + crust + thermal mantle): the full eigen/energy/regular
   product path runs and cross-validates (slow tier).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_ellipticity
from pysurfinv_tpu.ops.eigen import (eigenfunctions,
                                     eigenfunctions_regular,
                                     energy_integrals)

L = 8
D1, A1, RHO1 = 2.0, 1.475, 1.027
H = jnp.array([D1, 6.0, 20.0, 0, 0, 0, 0, 0])
VS = jnp.array([0.0, 3.2, 3.9, 4.6, 4.6, 4.6, 4.6, 4.6])
VP = jnp.array([A1, 5.8, 6.9, 8.1, 8.1, 8.1, 8.1, 8.1])
RHO = jnp.array([RHO1, 2.6, 2.9, 3.3, 3.3, 3.3, 3.3, 3.3])
QSI = jnp.zeros(L)
NLAY = 4
PERIODS = jnp.array([5.0, 10.0, 20.0, 40.0])
# atten/flat off: the verbatim trig formulas below are then evaluated
# in exactly the input domain (no period-dependent rescale to mirror)
CFG = SurfConfig(nmodes=1, atten=False, flat=False)
ARGS = (H, VP, VS, RHO, QSI, PERIODS, NLAY)


def _verbatim_water_column(c, t, a1, rho1, d1):
    """surfa.f:876-911 + 1028-1050, symbol for symbol.

    The reference evaluates the water column's energy-integral
    contributions and its interface impedance in closed form via
    complex trig (csin/ccos of ``cra = wvno*csqrt((c/a1)^2 - 1)``
    cover the oscillatory c > a1 and evanescent c < a1 regimes in one
    expression).  Convention: fields normalised to unit vertical
    displacement at the water/solid interface — the same convention
    the rebuild's profiles use.
    """
    wvno = 2.0 * np.pi / (c * t)
    omegsq = (2.0 * np.pi / t) ** 2
    xlamb = rho1 * a1 * a1                      # mu = 0
    ra = c / a1
    cra = wvno * np.sqrt(complex(ra * ra - 1.0))
    if abs(cra) <= 1.0e-35:                     # surfa.f:1031 degenerate
        return dict(sumi0=rho1 * d1, sumi1=0.0, sumi2=0.0, sumi3=0.0,
                    tzz=0.0)
    sin2ra = (np.sin(2.0 * cra * d1) / (4.0 * cra)).real
    cosra = (np.cos(cra * d1)).real
    cos2rm = 1.0 / (cosra * cosra)
    fac1 = (0.5 * d1 + sin2ra) * cos2rm
    fac3 = wvno * (0.5 * d1 - sin2ra) * cos2rm
    rab1 = (cra * cra).real
    fac2 = wvno * fac3 / rab1
    fac4 = rab1 * fac3 / wvno
    tzz = -rho1 * omegsq * (np.sin(cra * d1) / cra).real / cosra
    return dict(sumi0=rho1 * (fac1 + fac2), sumi1=xlamb * fac2,
                sumi2=xlamb * fac3, sumi3=xlamb * fac4, tzz=tzz)


@pytest.fixture(scope="module")
def eig():
    return eigenfunctions(*ARGS, wave="rayleigh", cfg=CFG)


@pytest.fixture(scope="module")
def ints():
    return energy_integrals(*ARGS, wave="rayleigh", cfg=CFG)


def test_water_rayleigh_structure(eig):
    """Acceptance (a): free-surface pressure condition + interface
    normalisation + slaved horizontal displacement."""
    assert np.asarray(eig["valid"]).all()
    uz = np.asarray(eig["uz"])[:, 0]
    ur = np.asarray(eig["ur"])[:, 0]
    szz = np.asarray(eig["szz"])[:, 0]
    szr = np.asarray(eig["szr"])[:, 0]
    # reference convention: unit uz at the water/solid interface
    np.testing.assert_allclose(uz[:, 1], 1.0, atol=1e-12)
    # free surface of the water: zero pressure, zero slaved ur
    np.testing.assert_allclose(szz[:, 0], 0.0, atol=1e-12)
    np.testing.assert_allclose(ur[:, 0], 0.0, atol=1e-12)
    # no shear anywhere in the fluid, ~none at the solid top
    np.testing.assert_allclose(szr[:, 0], 0.0, atol=1e-12)
    resid = np.abs(szr[:, 1]) / np.abs(szr).max(axis=1)
    assert resid.max() < 1e-6
    # water column amplifies: |uz| at the sea surface exceeds the
    # interface value (cos(cra z)/cos(cra d) > 1 below the first zero)
    assert (np.abs(uz[:, 0]) > 1.0).all()


def test_water_interface_ellipticity_matches_dltar(eig):
    """|ur/uz| at the interface == the DLTAR mup=2 ellipticity, whose
    liquid branch (surfa.f:216-251) is a fully independent
    formulation — the reference stores exactly this ``ratio`` as its
    surface-row ampur (SURF_PERTURB surfa.f:1377)."""
    ell, c, ok = surf_ellipticity(*ARGS, cfg=CFG)
    assert np.asarray(ok).all()
    ur = np.asarray(eig["ur"])[:, 0, 1]
    uz = np.asarray(eig["uz"])[:, 0, 1]
    ratio = np.abs(ur / uz)
    ell = np.abs(np.asarray(ell)[:, 0])
    np.testing.assert_allclose(ratio, ell, rtol=1e-6)


def test_water_integrals_match_verbatim_trig(eig, ints):
    """Acceptance (c): our Boole-quadrature water partials == the
    reference's closed trig forms, and the solid-top stress ratio ==
    the verbatim tzz impedance."""
    c = np.asarray(ints["c"])[:, 0]
    uz = np.asarray(eig["uz"])[:, 0]
    szz = np.asarray(eig["szz"])[:, 0]
    for ip, t in enumerate(np.asarray(PERIODS)):
        ref = _verbatim_water_column(c[ip], t, A1, RHO1, D1)
        ours = {k: float(np.asarray(ints[k])[ip, 0])
                for k in ("I0_wat", "I1_wat", "I2_wat", "I3_wat")}
        for k_ref, k_our in (("sumi0", "I0_wat"), ("sumi1", "I1_wat"),
                             ("sumi2", "I2_wat"), ("sumi3", "I3_wat")):
            assert abs(ours[k_our] - ref[k_ref]) <= 1e-7 * max(
                abs(ref[k_ref]), 1e-6), (
                f"T={t}: {k_our} {ours[k_our]:.9g} vs verbatim "
                f"{ref[k_ref]:.9g}")
        # impedance: szz/uz of the combined solid solution at the
        # interface (tzz is pair-invariant across the A&R/reference
        # sign conventions)
        tzz_ours = szz[ip, 1] / uz[ip, 1]
        assert abs(tzz_ours - ref["tzz"]) <= 1e-5 * max(
            abs(ref["tzz"]), 1e-3), (
            f"T={t}: tzz {tzz_ours:.9g} vs verbatim {ref['tzz']:.9g}")


def test_water_group_velocity_consistent(ints):
    """Acceptance (b): the integral-path group velocity (with the
    water contribution) matches implicit differentiation to the
    solid-stack tolerance (test_eigen.py:220), and the Lagrangian
    vanishes at the root.  Both fail by O(10%) if the water terms are
    dropped (I0_wat/I0 reaches ~0.8 at T=5 s here)."""
    u_imp = np.asarray(ints["u"])[:, 0]
    u_int = np.asarray(ints["u_int"])[:, 0]
    assert (np.abs(u_int - u_imp) / u_imp).max() < 1e-4
    om2I0 = ((2 * np.pi / np.asarray(PERIODS)) ** 2
             * np.asarray(ints["I0"])[:, 0])
    fl = np.abs(np.asarray(ints["flagr"])[:, 0])
    assert (fl / om2I0).max() < 1e-4
    # the water term is material in this fixture
    frac = np.asarray(ints["I0_wat"])[:, 0] / np.asarray(ints["I0"])[:, 0]
    assert frac.max() > 0.5 and frac.min() > 0.005


def test_water_regular_grid_fields():
    """-s dz sampling through the water column: the acoustic field
    inside the water matches the closed cosh/sinh form, displacement
    and normal stress are continuous across the interface, and the
    ``in_water`` flag delimits the column (the reference prints zeros
    there — surfa.f:1400 skips depths above dept1(1))."""
    out = eigenfunctions_regular(*ARGS, wave="rayleigh", cfg=CFG,
                                 dz=0.25, nz=160)
    z = np.asarray(out["z"])
    inw = np.asarray(out["in_water"])
    np.testing.assert_array_equal(inw, z < D1 - 1e-9)
    c = np.asarray(out["c"])[:, 0]
    v2 = np.asarray(out["v2"])   # vertical displacement (P, 1, nz)
    dv2 = np.asarray(out["dv2"])
    for ip, t in enumerate(np.asarray(PERIODS)):
        wvno = 2 * np.pi / (c[ip] * t)
        cra = wvno * np.sqrt(complex((c[ip] / A1) ** 2 - 1.0))
        # closed form normalised to uz(interface) = 1 (surfa.f:876-911)
        uz_ref = (np.cos(cra * z[inw])).real / (np.cos(cra * D1)).real
        np.testing.assert_allclose(v2[ip, 0, inw], uz_ref, rtol=1e-8)
        # continuity of the VERTICAL displacement across the interface
        # (only uz, szz, szr are continuous at a fluid/solid boundary;
        # ur — and hence duz/dz, which depends on ur on the solid
        # side — genuinely jump there)
        i_up = np.searchsorted(z, D1) - 1
        dz_loc = z[i_up + 1] - z[i_up]
        jump = abs(v2[ip, 0, i_up + 1] - v2[ip, 0, i_up])
        scale = max(np.abs(dv2[ip, 0, i_up]), np.abs(dv2[ip, 0, i_up + 1]))
        assert jump < 3 * dz_loc * max(scale, 0.1), (t, jump, scale)


def test_water_love_rows_zero():
    """No SH motion in the fluid: Love rows inside water are zero and
    the solid top (interface) is traction-free and unit-normalised."""
    out = eigenfunctions(*ARGS, wave="love", cfg=CFG)
    assert np.asarray(out["valid"]).all()
    ut = np.asarray(out["ut"])[:, 0]
    szt = np.asarray(out["szt"])[:, 0]
    np.testing.assert_allclose(ut[:, 0], 0.0, atol=1e-15)
    np.testing.assert_allclose(szt[:, 0], 0.0, atol=1e-15)
    np.testing.assert_allclose(ut[:, 1], 1.0, atol=1e-12)
    resid = np.abs(szt[:, 1]) / np.abs(szt).max(axis=1)
    assert resid.max() < 1e-4
    li = energy_integrals(*ARGS, wave="love", cfg=CFG)
    u_imp = np.asarray(li["u"])[:, 0]
    u_int = np.asarray(li["u_int"])[:, 0]
    assert (np.abs(u_int - u_imp) / u_imp).max() < 1e-4


@pytest.mark.slow  # full Cascadia structure: large-L expm programs
def test_cascadia_ocean_fixture_eigen_path():
    """The flagship ocean model:
    eigenfunctions, eigenfunctions_regular and energy_integrals all
    work on the water-topped Cascadia point model."""
    from examples.invert_point import (localInfo, periods, setting,
                                       uncers, vels)
    from pysurfinv_tpu.inversion.compiled import CompiledModel
    from pysurfinv_tpu.inversion.point import PointCascadia

    pt = PointCascadia(setting, localInfo, periods=periods, vels=vels,
                       uncers=uncers)
    cm = CompiledModel(pt.initMod)
    h, vp, vs, rho, qsinv, nlay = cm.build_profile(cm.spec.theta0)
    pers = jnp.asarray(np.array([10.0, 20.0, 40.0, 60.0]))
    cfg = SurfConfig(nmodes=1)
    args = (h, vp, vs, rho, qsinv, pers, nlay)

    eo = eigenfunctions(*args, wave="rayleigh", cfg=cfg)
    assert np.asarray(eo["valid"]).all()
    uz = np.asarray(eo["uz"])[:, 0]
    nw = int(np.sum(np.cumprod(np.asarray(vs) <= 1e-8)))
    assert nw >= 1                        # genuinely water-topped
    np.testing.assert_allclose(uz[:, nw], 1.0, atol=1e-10)
    assert np.isfinite(uz).all()
    szz = np.asarray(eo["szz"])[:, 0]
    np.testing.assert_allclose(szz[:, 0], 0.0, atol=1e-10)

    ei = energy_integrals(*args, wave="rayleigh", cfg=cfg)
    u_imp = np.asarray(ei["u"])[:, 0]
    u_int = np.asarray(ei["u_int"])[:, 0]
    assert (np.abs(u_int - u_imp) / u_imp).max() < 1e-4
    assert (np.asarray(ei["I0_wat"])[:, 0] > 0).all()
    om2I0 = (2 * np.pi / np.asarray(pers)) ** 2 * np.asarray(ei["I0"])[:, 0]
    fl = np.abs(np.asarray(ei["flagr"])[:, 0])
    assert (fl / om2I0).max() < 1e-4

    ro = eigenfunctions_regular(*args, wave="rayleigh", cfg=cfg,
                                dz=2.0, nz=120)
    assert np.asarray(ro["valid"]).all()
    for kk in ("v1", "v2", "dv1", "dv2"):
        assert np.isfinite(np.asarray(ro[kk])).all(), kk
    assert np.asarray(ro["in_water"]).sum() >= 1
