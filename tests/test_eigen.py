"""Eigenfunction + ellipticity capability checks (SURF_PERTURB parity).

Two validation layers:

1. **TEST1 golden parity** — the reference's main outfiles ``test.R``
   and ``test.L`` carry, per (mode, period), flattening-corrected
   eigenfunction depth tables at dz = 2 km plus energy-integral
   headers (written by ``calcul_deep.f:254-393``; parsed by
   ``tests/golden/make_golden.py``).  ``eigenfunctions_regular``
   must reproduce the V1/V2 (Rayleigh) and V (Love) profiles.

2. **Structural invariants** that fail loudly if the dispersion root,
   the propagators, or the boundary conditions are wrong:
   free-surface traction ~ 0 at the root; Rayleigh surface ur/uz ==
   the DLTAR mup=2 ellipticity (two unrelated formulations); a uniform
   halfspace's ellipticity is period-independent at the textbook
   Poisson-solid value.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_ellipticity
from pysurfinv_tpu.ops.eigen import eigenfunctions


def _args(m):
    return (jnp.array(m["h"]), jnp.array(m["vp"]), jnp.array(m["vs"]),
            jnp.array(m["rho"]), jnp.array(m["qsinv"]))


@pytest.fixture(scope="module")
def rayleigh_eig(eus_model):
    m = eus_model
    return eigenfunctions(*_args(m), jnp.array(m["periods"]), m["nlay"],
                          wave="rayleigh", cfg=SurfConfig(nmodes=1))


@pytest.fixture(scope="module")
def love_eig(eus_model):
    m = eus_model
    return eigenfunctions(*_args(m), jnp.array(m["periods"]), m["nlay"],
                          wave="love", cfg=SurfConfig(nmodes=1))


def test_love_surface_traction_vanishes(love_eig):
    """szt(0) ~ 0 at the root — the dispersion condition reached via
    expm propagators instead of the Haskell recursion."""
    szt = np.asarray(love_eig["szt"])[:, 0, :]   # (P, L)
    ut = np.asarray(love_eig["ut"])[:, 0, :]
    assert np.asarray(love_eig["valid"]).all()
    resid = np.abs(szt[:, 0]) / np.abs(szt).max(axis=1)
    assert resid.max() < 1e-4
    # unit surface displacement, decaying with depth on average
    assert np.allclose(ut[:, 0], 1.0)
    assert (np.abs(ut[:, -1]) < 0.5).all()


def test_rayleigh_surface_traction_vanishes(rayleigh_eig):
    ok = np.asarray(rayleigh_eig["valid"])
    assert ok.all()
    for name in ("szr", "szz"):
        s = np.asarray(rayleigh_eig[name])[:, 0, :]
        resid = np.abs(s[:, 0]) / np.abs(s).max(axis=1)
        assert resid.max() < 1e-3, f"{name} residual {resid.max():.2e}"
    uz = np.asarray(rayleigh_eig["uz"])[:, 0, :]
    assert np.allclose(uz[:, 0], 1.0)


def test_rayleigh_eigenfunction_matches_dltar_ellipticity(rayleigh_eig,
                                                          eus_model):
    """|ur(0)/uz(0)| from transfer matrices == |mup=2 ellipticity|."""
    m = eus_model
    ell, c, ok = surf_ellipticity(*_args(m), jnp.array(m["periods"]),
                                  m["nlay"], cfg=SurfConfig(nmodes=1))
    ratio = np.abs(np.asarray(rayleigh_eig["ur"])[:, 0, 0])
    ell = np.abs(np.asarray(ell)[:, 0])
    assert np.abs(ratio - ell).max() < 2e-3 * ell.max()


def _eig_err(golden, out, wt, m, ip, T, comp, col=1):
    """Max |ours - golden| / max|golden| for one profile (col 1 = value,
    col 2 = spherical-depth derivative), sign-aligned at the surface."""
    key = f"eig_{wt}_{m}_{T}_{comp}"
    if key not in golden.files:
        return None
    ref = golden[key]
    zgrid = np.asarray(out["z"])
    sel = ref[:, 0] <= zgrid[-1] + 1e-9
    zs, vref = ref[sel, 0], ref[sel, col]
    ii = np.round(zs / 2.0).astype(int)
    src = out[comp] if col == 1 else out["d" + comp]
    ours = np.asarray(src[ip, m])[ii]
    ok = np.asarray(out["mask"][ip, m])[ii]
    if ok.sum() < 5:
        return None
    sign = np.sign(ours[ok][0] * vref[ok][0]) or 1.0
    return (np.abs(sign * ours[ok] - vref[ok]).max()
            / np.abs(golden[key][:, col]).max())


def test_eigenfunctions_match_test1_goldens(golden, eus_model):
    """dz-gridded eigenfunctions match the TEST1 depth tables.

    Mode 0 runs at our own roots (root parity is ~1e-7, so profile
    parity is direct).  Mode 1 runs with the golden header's phase
    velocities injected (``c_given``): overtone roots near mode
    osculation differ between the two formulations by up to ~1e-3
    relative (see test_dispersion_golden tolerances), which shifts
    nodes and would swamp the profile comparison; injecting c isolates
    the eigenfunction machinery.  The R mode-1 T=20 s point is excluded
    outright — there the injected golden c is ~9e-4 off OUR secular
    root (the R1/R2 osculation), so the free-surface null vector mixes
    in the complementary solution (measured 1e-1 profile error from
    that root offset alone; every other (mode, period) is < 1e-4).
    """
    from pysurfinv_tpu.ops.eigen import eigenfunctions_regular

    m_ = eus_model
    periods_i = [int(t) for t in m_["periods"]]
    periods = jnp.asarray(np.asarray(m_["periods"], float))
    checked = 0
    for wave, wt in (("rayleigh", "R"), ("love", "L")):
        cg = np.full((len(periods_i), 2), -1.0)
        for mm in (0, 1):
            for ip, T in enumerate(periods_i):
                k = f"eig_{wt}_{mm}_{T}_hdr"
                if k in golden.files:
                    cg[ip, mm] = golden[k][1]
        kw = dict(wave=wave, cfg=SurfConfig(nmodes=2), dz=2.0, nz=500)
        out_own = eigenfunctions_regular(*_args(m_), periods,
                                         m_["nlay"], **kw)
        out_inj = eigenfunctions_regular(*_args(m_), periods,
                                         m_["nlay"],
                                         c_given=jnp.asarray(cg), **kw)
        comps = ("v1", "v2") if wt == "R" else ("v1",)
        for ip, T in enumerate(periods_i):
            for comp in comps:
                for mm, out in ((0, out_own), (1, out_inj)):
                    if wt == "R" and mm == 1 and T == 20:
                        continue  # osculation: see docstring
                    err = _eig_err(golden, out, wt, mm, ip, T, comp)
                    if err is None:
                        continue
                    assert err < 1e-4, \
                        f"{wt} m{mm} T={T} {comp}: {err:.2e}"
                    derr = _eig_err(golden, out, wt, mm, ip, T, comp,
                                    col=2)
                    assert derr < 5e-3, \
                        f"{wt} m{mm} T={T} d{comp}: {derr:.2e}"
                    checked += 1
    assert checked >= 50


@pytest.mark.slow  # two traced solver+expm programs per wave (~min compiles)
def test_energy_integrals_match_test1(golden, eus_model):
    """Boole-rule energy integrals + integral-path u vs TEST1 goldens.

    SURF_PERTURB prints, per (mode,
    period), the energy-integral row I0 I1 I2 [I3] flagr
    (``calcul_deep.f:254-349``; parsed into ``eig_*_int``), its
    integral-path group velocity u = I1/(c·I0) (Love,
    ``surfa.f:712-716``) / (k·I1+I2)/(ω·I0) (Rayleigh,
    ``surfa.f:1333``) into ``.grv``, and the variational phase velocity
    ω/k_var as the third ``.phv`` column.  `energy_integrals` rebuilds
    all of these from our expm-propagated eigenfunctions — the planned
    "second, validating implementation" of group velocity (SURVEY §7
    step 1e) — and here every quantity is pinned against the golden:

      * I0..I3 relative parity 1e-4 (measured ~1e-6: the analytic
        halfspace tail + composite Boole at npanel=8 out-resolves the
        golden's own ndiv-sublayer rule);
      * u_int vs golden ``.grv`` 1e-5 — and vs the implicit-diff u of
        the main dispersion path 1e-4 (that path's own tangent
        tolerance), two independent formulations;
      * c_var vs the golden ``.phv`` variational column 1e-6;
      * the Lagrangian residual ω²I0−k²I1[−2kI2−I3] vanishes at our
        roots relative to its ω²I0 term (1e-4).

    Mode 1 runs at the golden header's injected roots (as the depth-
    table test: near-osculation root offsets would otherwise dominate).
    Exclusions, same rationale as `test_eigenfunctions_match_test1`:
    R mode 1 T=20 s entirely (the injected golden c sits ~9e-4 off OUR
    secular root at the R1/R2 osculation — the recombined eigenfunction
    carries the complementary solution); the flagr assert additionally
    skips L mode 1 T=20 s, where flagr *measures* that same root
    offset (0.19 at the golden c, 1e-5 elsewhere) while the integrals
    themselves still match to 1e-5.
    """
    from pysurfinv_tpu.ops.eigen import energy_integrals

    m = eus_model
    periods_i = [int(t) for t in m["periods"]]
    periods = jnp.asarray(np.asarray(m["periods"], float))
    TWO_PI = 2.0 * np.pi
    checked = 0
    for wave, wt in (("rayleigh", "R"), ("love", "L")):
        names = ("I0", "I1", "I2", "I3") if wt == "R" else \
                ("I0", "I1", "I2")
        cg = np.full((len(periods_i), 2), -1.0)
        for mm in (0, 1):
            for ip, T in enumerate(periods_i):
                k = f"eig_{wt}_{mm}_{T}_hdr"
                if k in golden.files:
                    cg[ip, mm] = golden[k][1]
        own = energy_integrals(*_args(m), periods, m["nlay"], wave=wave,
                               cfg=SurfConfig(nmodes=2))
        inj = energy_integrals(*_args(m), periods, m["nlay"], wave=wave,
                               cfg=SurfConfig(nmodes=2),
                               c_given=jnp.asarray(cg))
        # integral-path u vs implicit-diff u: two independent group-
        # velocity formulations agreeing at our own mode-0 roots.  The
        # bound is the implicit path's own tolerance (its F_T/F_c
        # tangent ratio at an nbisect=12 root carries ~1e-5..1e-4 —
        # same bound as test_kernels.test_group_velocity_consistent);
        # the integral path sits at 1e-7 of the golden.
        u_imp = np.asarray(own["u"])[:, 0]
        u_int = np.asarray(own["u_int"])[:, 0]
        assert (np.abs(u_int - u_imp) / u_imp).max() < 1e-4
        for mm, res in ((0, own), (1, inj)):
            for ip, T in enumerate(periods_i):
                gi = golden[f"eig_{wt}_{mm}_{T}_int"]
                if wt == "R" and mm == 1 and T == 20:
                    continue  # osculation: see docstring
                for j, nm in enumerate(names):
                    ours = float(np.asarray(res[nm])[ip, mm])
                    rel = abs(ours - gi[j]) / abs(gi[j])
                    assert rel < 1e-4, f"{wt} m{mm} T={T} {nm}: {rel:.2e}"
                u_g = golden[f"grv_{wt}_{mm}"][ip, 1]
                du = abs(float(np.asarray(res["u_int"])[ip, mm]) - u_g) / u_g
                assert du < 1e-5, f"{wt} m{mm} T={T} u_int: {du:.2e}"
                cv_g = golden[f"phv_{wt}_{mm}"][ip, 2]
                dcv = abs(float(np.asarray(res["c_var"])[ip, mm])
                          - cv_g) / cv_g
                assert dcv < 1e-6, f"{wt} m{mm} T={T} c_var: {dcv:.2e}"
                if not (mm == 1 and T == 20):
                    om2I0 = (TWO_PI / T) ** 2 * float(
                        np.asarray(res["I0"])[ip, mm])
                    fl = abs(float(np.asarray(res["flagr"])[ip, mm]))
                    assert fl / om2I0 < 1e-4, f"{wt} m{mm} T={T} flagr"
                checked += 1
    assert checked >= 38


def test_rayleigh_amplitude_response(eus_model):
    """DLTAR4 mup=3 amplitude response (surfa.f:366-371).

    No golden carries this quantity (it is vestigial in the reference
    too — fast_surf only ever calls mup=1), so invariants: finite and
    positive at every root; scale-free on a uniform halfspace (no
    length scale -> period-independent); and on a water-covered
    halfspace the response is modulated by the water-column factor
    cos(wvno d1 sqrt(|c^2/a1^2 - 1|)) — verified by locating its
    predicted dips.
    """
    from pysurfinv_tpu.ops.dispersion import surf_amplitude

    m = eus_model
    amp, c, ok = surf_amplitude(*_args(m), jnp.array(m["periods"]),
                                m["nlay"], cfg=SurfConfig(nmodes=2))
    amp, ok = np.asarray(amp), np.asarray(ok)
    assert np.isfinite(amp).all()
    assert (amp[ok] > 0).all()

    # uniform Poisson halfspace: no length scale -> flat response
    L = 8
    vs0 = 3.0
    h = jnp.zeros(L)
    args = (h, jnp.full(L, vs0 * np.sqrt(3.0)), jnp.full(L, vs0),
            jnp.full(L, 2.7), jnp.zeros(L))
    periods = jnp.array([5.0, 10.0, 20.0, 50.0])
    cfg = SurfConfig(nmodes=1, atten=False, flat=False)
    a_hs, c_hs, ok_hs = surf_amplitude(*args, periods, 2, cfg=cfg)
    a_hs = np.asarray(a_hs)[:, 0]
    assert np.asarray(ok_hs).all()
    assert a_hs.std() / a_hs.mean() < 1e-3

    # water over halfspace: amplitude tracks |cos(rad)| of the column
    d1 = 3.0
    h_w = jnp.array([d1] + [0.0] * (L - 1))
    vs_w = jnp.array([0.0] + [vs0] * (L - 1))
    vp_w = jnp.array([1.475] + [vs0 * np.sqrt(3.0)] * (L - 1))
    rho_w = jnp.array([1.027] + [2.7] * (L - 1))
    periods_w = jnp.asarray(np.linspace(2.0, 12.0, 41))
    a_w, c_w, ok_w = surf_amplitude(h_w, vp_w, vs_w, rho_w,
                                    jnp.zeros(L), periods_w, 3, cfg=cfg)
    a_w = np.asarray(a_w)[:, 0]
    c_w = np.asarray(c_w)[:, 0]
    okw = np.asarray(ok_w)[:, 0]
    wvno = 2 * np.pi / (c_w * np.asarray(periods_w))
    rad = wvno * d1 * np.sqrt(np.abs((c_w / 1.475) ** 2 - 1.0))
    cosf = np.abs(np.cos(rad))
    # normalise out the smooth root-dependent prefactor and check the
    # modulation: amplitude must dip exactly where cos(rad) does
    sel = okw & (cosf > 1e-3)
    ratio = a_w[sel] / cosf[sel]
    smooth = np.abs(np.diff(np.log(ratio))).max()
    raw = np.abs(np.diff(np.log(a_w[sel]))).max()
    assert smooth < 0.5 * raw, (smooth, raw)


def test_halfspace_ellipticity_scale_invariant():
    """Uniform Poisson halfspace: ellipticity independent of period and
    equal to the textbook surface H/V (~0.68)."""
    L = 8
    vs0, vp0, rho0 = 3.0, 3.0 * np.sqrt(3.0), 2.7
    h = jnp.zeros(L)
    vs = jnp.full(L, vs0)
    vp = jnp.full(L, vp0)
    rho = jnp.full(L, rho0)
    qsi = jnp.zeros(L)
    periods = jnp.array([5.0, 10.0, 20.0, 50.0])
    cfg = SurfConfig(nmodes=1, atten=False, flat=False)
    ell, c, ok = surf_ellipticity(h, vp, vs, rho, qsi, periods, 2, cfg=cfg)
    ell = np.abs(np.asarray(ell)[:, 0])
    assert np.asarray(ok).all()
    # Rayleigh root of a Poisson solid: c = 0.9194 beta
    assert np.allclose(np.asarray(c)[:, 0], 0.9194 * vs0, rtol=2e-3)
    # no length scale -> period-independent
    assert ell.std() / ell.mean() < 1e-3
    # classic Poisson-solid surface H/V
    assert abs(ell.mean() - 0.681) < 0.02


def test_psv_halfspace_basis_near_vs_degeneracy():
    """c -> b degeneracy of the halfspace SV eigenvector.

    As the phase velocity approaches the halfspace shear velocity the
    SV vertical wavenumber gb -> 0 and the 1e-12 clamp in
    ``_psv_halfspace_basis`` kicks in.  The returned vectors must stay
    exact null vectors of (A + g I) for the ``_psv_system`` matrix A
    (their defining property) all the way down to machine-level
    evanescence, and must vary continuously across the clamp
    threshold — a blowup here would poison every long-period /
    near-cutoff eigenfunction lane.
    """
    from pysurfinv_tpu.ops.eigen import _psv_halfspace_basis, _psv_system

    a, b, rho = 8.0, 4.6, 3.3
    om = 2.0 * np.pi / 50.0

    def basis(eps):
        c = b * (1.0 - eps)
        k = om / c
        ga = k * np.sqrt(1.0 - (c / a) ** 2)
        gb = k * np.sqrt(max(1.0 - (c / b) ** 2, 0.0))
        A = np.asarray(_psv_system(jnp.float64(k), om, a, b, rho))
        vP, vS = _psv_halfspace_basis(jnp.float64(k), om, a, b, rho)
        return k, ga, gb, A, np.asarray(vP), np.asarray(vS)

    for eps in (1e-2, 1e-4, 1e-6, 1e-8, 1e-10):
        k, ga, gb, A, vP, vS = basis(eps)
        assert np.isfinite(vP).all() and np.isfinite(vS).all()
        scale = np.abs(A).max()
        resP = np.abs(A @ vP + ga * vP).max() / (scale * np.abs(vP).max())
        resS = np.abs(A @ vS + gb * vS).max() / (scale * np.abs(vS).max())
        assert resP < 1e-12, f"P residual {resP:.2e} at eps={eps}"
        assert resS < 1e-9, f"SV residual {resS:.2e} at eps={eps}"
    # continuity across the clamp threshold (eps ~ 5e-13): just above,
    # at, and past the clamp the normalised SV direction must sit at
    # its gb=0 limit (0, k, -mu k^2, 0)/|.| with no clamp-induced jump
    units = []
    for eps in (1e-11, 1e-12, 1e-13, 0.0):
        k, _, _, _, _, vS = basis(eps)
        assert np.isfinite(vS).all()
        units.append(vS / np.linalg.norm(vS))
    lim = np.array([0.0, k, -rho * b * b * k * k, 0.0])
    lim /= np.linalg.norm(lim)
    for u in units:
        assert np.linalg.norm(u - lim) < 1e-5


def test_love_eigenfunctions_near_halfspace_velocity():
    """Long-period Love lanes where the root sits ~0.1% below the
    halfspace vs: the ``nu`` clamp (`ops/eigen.py`) must still yield a
    valid decaying start vector — traction condition satisfied, all
    profiles finite, surface-normalised."""
    L = 8
    h = jnp.array([30.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
    vs = jnp.array([3.5] + [4.6] * (L - 1))
    vp = 1.76 * vs
    rho = jnp.full(L, 3.3)
    qsi = jnp.zeros(L)
    periods = jnp.array([100.0, 200.0, 400.0])
    cfg = SurfConfig(nmodes=1, atten=False, flat=False)
    out = eigenfunctions(h, vp, vs, rho, qsi, periods, 2, wave="love",
                         cfg=cfg)
    assert np.asarray(out["valid"]).all()
    c = np.asarray(out["c"])[:, 0]
    b_h = 4.6
    # the T=400 s root must actually probe the degenerate corner
    assert c[-1] > 0.997 * b_h, f"fixture too far from cutoff: c={c}"
    assert (c < b_h).all()
    ut = np.asarray(out["ut"])[:, 0, :]
    szt = np.asarray(out["szt"])[:, 0, :]
    assert np.isfinite(ut).all() and np.isfinite(szt).all()
    assert np.allclose(ut[:, 0], 1.0)
    resid = np.abs(szt[:, 0]) / np.abs(szt).max(axis=1)
    assert resid.max() < 1e-4
