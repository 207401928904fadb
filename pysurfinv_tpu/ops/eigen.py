"""Surface-wave eigenfunction depth profiles (SURF_PERTURB capability).

The reference writes displacement/stress eigenfunctions per (mode,
period) from its RK4 integration (``senskernel-1.0/src/SURF_PERTURB/
calcul_deep.f:254-349`` and the ``surfa.f`` REIGEN/LEIGEN machinery).
This module reconstructs the same profiles in batched JAX, without
copying that pipeline:

  * each homogeneous layer's displacement-stress propagator is the
    matrix exponential of the P-SV (4x4) or SH (2x2) first-order
    system matrix (Aki & Richards, Quantitative Seismology, eqs.
    7.28/7.24) — ``jax.scipy.linalg.expm`` replaces hand-coded
    Haskell-matrix entries;
  * propagation runs **upward from the truncation halfspace**, the
    numerically stable direction: the physical eigenfunction grows
    toward the surface while contamination by the complementary
    solution decays.  For Rayleigh, the two decaying halfspace
    solutions (P, SV) are propagated as a basis and combined by the
    free-surface traction condition (a 2x2 null-vector at the
    dispersion root);
  * profiles are normalised to unit vertical (Rayleigh) or transverse
    (Love) displacement at the top of the SOLID stack — the free
    surface for solid models, the water/solid interface for
    ocean models — the reference's convention (``surfa.f:709``
    divides the energy integrals by ut^2; the water branch copies the
    interface row to the top, ``surfa.f:1051-1055``);
  * a surface water column couples to the Rayleigh problem through an
    impedance condition (szz = tzz uz at the interface) obtained by
    propagating the embedded acoustic system `_fluid_system4` down
    from the free surface — the generic-machinery equivalent of the
    reference's closed cosh/sinh water algebra (``surfa.f:876-911``).

Intended for analysis (kernel/eigenfunction plots, mode QC) on the f64
CPU path; the inversion hot path never calls it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pysurfinv_tpu.ops.dispersion import (
    SurfConfig,
    _model_at_period,
    surf_forward,
)
from pysurfinv_tpu.ops.flatten import model_preamble
from pysurfinv_tpu.ops.secular import effective_halfspace

TWO_PI = 6.283185307179586


def _psv_system(k, om, a, b, rho):
    """P-SV system matrix d/dz [ur, uz, s_zr, s_zz] (A&R eq. 7.28)."""
    mu = rho * b * b
    lam = rho * a * a - 2.0 * mu
    l2m = lam + 2.0 * mu
    zeta = 4.0 * mu * (lam + mu) / l2m
    ro2 = rho * om * om
    z = jnp.zeros_like(k)
    row1 = jnp.stack([z, k, 1.0 / mu, z])
    row2 = jnp.stack([-k * lam / l2m, z, z, 1.0 / l2m])
    row3 = jnp.stack([k * k * zeta - ro2, z, z, k * lam / l2m])
    row4 = jnp.stack([z, -ro2, -k, z])
    return jnp.stack([row1, row2, row3, row4])


def _sh_system(k, om, b, rho):
    """SH system matrix d/dz [ut, s_zt] (A&R eq. 7.24)."""
    mu = rho * b * b
    z = jnp.zeros_like(k)
    return jnp.stack([jnp.stack([z, 1.0 / mu]),
                      jnp.stack([k * k * mu - om * om * rho, z])])


def _fluid_system4(k, om, a, rho):
    """Acoustic (liquid) layer embedded in the 4-component P-SV state.

    In a fluid the P-SV system degenerates: sigma_zr = 0 and, from the
    mu -> 0 limit of the sigma_zr' row of `_psv_system`, the horizontal
    displacement is slaved to the normal stress, ur = k szz / (rho
    om^2).  The remaining dynamics close on (uz, szz):

        uz'  = -gamma^2 / (rho om^2) * szz,   gamma^2 = k^2 - om^2/a^2
        szz' = -rho om^2 * uz

    (the displacement-potential formulation the reference evaluates in
    closed cosh/sinh form, ``surfa.f:876-911``).  The embedding keeps
    ur consistent along depth (ur' = k szz'/(rho om^2) = -k uz) and
    szr identically zero, so a state vector starting on the fluid
    constraint stays on it — letting the shared expm-sampling /
    Boole-integral machinery treat water layers like any other layer.
    """
    ro2 = rho * om * om
    gam2 = k * k - (om / a) ** 2
    z = jnp.zeros_like(k)
    row_ur = jnp.stack([z, -k, z, z])
    row_uz = jnp.stack([z, z, z, -gam2 / ro2])
    row_szr = jnp.stack([z, z, z, z])
    row_szz = jnp.stack([z, -ro2, z, z])
    return jnp.stack([row_ur, row_uz, row_szr, row_szz])


def _psv_halfspace_basis(k, om, a, b, rho):
    """Decaying-downward P and SV displacement-stress eigenvectors.

    For c < a, b the vertical wavenumbers ga/gb = k sqrt(1 - c^2/v^2)
    are real and the z-dependence is exp(-g z).  The vectors are the
    exact null vectors of (A + g I) for the `_psv_system` matrix A:
    eliminating the stresses via rows 1-2 and substituting into row 4
    gives (ur, uz) proportional to (k, ga) for P and (gb, k) for SV,
    with  szr = -mu (g ur + k uz),  szz = k lam ur - g (lam+2mu) uz.
    (Round-1 shipped sign-flipped uz/szz here — NOT eigenvectors; the
    leaked growing component swamped the evanescent overtone tails.)
    """
    mu = rho * b * b
    c = om / k
    ga = k * jnp.sqrt(jnp.maximum(1.0 - (c / a) ** 2, 1e-12))
    gb = k * jnp.sqrt(jnp.maximum(1.0 - (c / b) ** 2, 1e-12))
    ksq = k * k
    ro2 = rho * om * om
    # P: (ur, uz) = (k, ga);  szz = lam k^2 - ga^2 (lam+2mu) = ro2-2muk^2
    vP = jnp.stack([k, ga, -2.0 * mu * k * ga, ro2 - 2.0 * mu * ksq])
    # SV: (ur, uz) = (gb, k);  mu(gb^2+k^2) = 2muk^2 - ro2
    vS = jnp.stack([gb, k, -mu * (gb * gb + ksq), -2.0 * mu * k * gb])
    return vP, vS


def _collect_profiles(prop_fn, v0, mats, n_keep):
    """Scan upward applying inverse propagators, collecting states."""
    def body(v, M):
        v_new = prop_fn(M, v)
        return v_new, v_new
    vN, vs = jax.lax.scan(body, v0, mats, reverse=True)
    return vN, vs


def _lane_states(t, c0, ok, vp, vs, rho, fac, cfg, nlay, kind, idx,
                 qsinv):
    """Layer-top eigenfunction states + per-layer system matrices.

    One (period, mode) lane.  Returns ``(prof, Asys, hs)``:
    ``prof`` (L, ncmp) is the displacement-stress vector at every layer
    top, normalised to unit surface displacement (vertical for
    Rayleigh, transverse for Love); ``Asys`` (L, ncmp, ncmp) is the
    first-order system matrix of each (flattened, attenuated) layer, so
    the eigenfunction *within* layer l at depth s below its top is
    ``expm(Asys[l] s) @ prof[l]`` — which is how the regular-grid
    sampler below evaluates SURF_PERTURB's ``-s dz`` output
    (``surfa.f:748-830`` does the same analytically per regime).
    ``hs`` is the index of the truncation halfspace.
    """
    mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
    a_f, b_f, rho_f, d_f = mdl
    mm = effective_halfspace(c0, t, b_f, d_f, nlay, cfg.fact)
    c_safe = jnp.where(ok, c0, b_f[0] + 0.5)
    om = TWO_PI / t
    k = om / c_safe
    L = d_f.shape[0]
    active = idx < (mm - 1)            # layers above the halfspace
    hs = mm - 1
    water = jnp.abs(b_f) <= 1e-8
    # leading (surface) water stack — the only place liquid is physical
    # (the reference's secular/eigen liquid branch is surface-only,
    # surfa.f:216-251, 876-911)
    wtop = jnp.cumprod(water.astype(jnp.int32)).astype(bool)

    if kind == 2:
        b_solid = jnp.where(water, 1.0, b_f)   # keep 1/mu finite
        Apsv = jax.vmap(lambda aa, bb, rr: _psv_system(k, om, aa, bb, rr)
                        )(a_f, b_solid, rho_f)      # (L, 4, 4)
        Awat = jax.vmap(lambda aa, rr: _fluid_system4(k, om, aa, rr)
                        )(a_f, rho_f)
        Asys = jnp.where(water[:, None, None], Awat, Apsv)
        # upward propagator over layer l: expm(-A d); identity when
        # the layer is water, below the halfspace, or zero-thickness —
        # water layers are excluded from the solid propagation exactly
        # as the reference skips b <= 0 layers (surfa.f:1000) and
        # instead couple through the impedance condition below
        mats = jax.vmap(
            lambda Al, dl, act: jax.scipy.linalg.expm(
                -Al * jnp.where(act, dl, 0.0)))(
            Asys, d_f, active & ~water)             # (L, 4, 4)
        vP0, vS0 = _psv_halfspace_basis(
            k, om, a_f[hs], b_f[hs], rho_f[hs])

        # ---- water column: downward acoustic pass -------------------
        # free surface: szz = 0  =>  state (ur, uz, szr, szz) =
        # (0, 1, 0, 0); propagate down through the leading water stack
        # (identity elsewhere).  The carry after the scan is the state
        # at the water/solid interface; the per-layer outputs are the
        # states at each water layer's top.  tzz = szz/uz at the
        # interface is the reference's water impedance (surfa.f:910:
        # tzz = -rho om^2 tan-form for one layer; here generically via
        # expm so multi-layer water columns work too).
        fmats = jax.vmap(
            lambda Al, dl, w: jax.scipy.linalg.expm(
                Al * jnp.where(w, dl, 0.0)))(Asys, d_f, wtop)
        f0 = jnp.zeros((4,)).at[1].set(1.0)

        def fbody(f, M):
            return M @ f, f                          # output: layer-top

        f_int, ftops = jax.lax.scan(fbody, f0, fmats)
        uz_int = jnp.where(jnp.abs(f_int[1]) > 1e-30, f_int[1], 1.0)
        tzz = jnp.where(jnp.any(wtop), f_int[3] / uz_int, 0.0)

        # Stabilised two-solution shooting: propagating the raw (P, SV)
        # pair upward lets both columns align with the fastest-growing
        # direction, and the recombined mode then carries a spurious
        # growing-DOWNWARD component that swamps the evanescent tail
        # near the truncation halfspace (observed: 20% of curve max for
        # overtones at short period; the reference fights the same
        # instability with per-step renormalisation and by zeroing
        # small growing-exponential coefficients, surfa.f:804-807).
        # QR re-orthonormalisation at every layer top preserves the
        # *subspace* exactly and keeps both columns O(1): classic
        # continuous-orthonormalisation, expressed as a lax.scan.
        Y0 = jnp.stack([vP0, vS0], axis=1)           # (4, 2)
        Y0 = Y0 / jnp.linalg.norm(Y0, axis=0, keepdims=True)

        def body(Y, M):
            Q, R = jnp.linalg.qr(M @ Y)              # (4,2), (2,2)
            return Q, (Q, R)

        _, (Qs, Rs) = jax.lax.scan(body, Y0, mats, reverse=True)

        # boundary condition at the top of the SOLID stack (water
        # propagators are identity, so Qs[0] IS the interface state
        # basis): szr = 0 and szz = tzz * uz.  With no water tzz = 0
        # and this is the free-surface traction condition.  Null vector
        # via the adjugate row with the larger norm.
        M11, M12 = Qs[0, 2, 0], Qs[0, 2, 1]
        M21 = Qs[0, 3, 0] - tzz * Qs[0, 1, 0]
        M22 = Qs[0, 3, 1] - tzz * Qs[0, 1, 1]
        a1 = jnp.stack([M22, -M21])
        a2 = jnp.stack([-M12, M11])
        use1 = jnp.sum(a1 * a1) >= jnp.sum(a2 * a2)
        q0 = jnp.where(use1, a1, a2)

        # coefficients back down: c_l = R_l c_{l+1}  =>
        # c_{l+1} = R_l^{-1} c_l, seeded by the surface null vector
        def down(cvec, R):
            c_next = jax.scipy.linalg.solve_triangular(R, cvec,
                                                       lower=False)
            return c_next, cvec

        _, cs = jax.lax.scan(down, q0, Rs)           # cs[l] = c_l
        prof = jnp.einsum("lij,lj->li", Qs, cs)      # (L, 4)
        # normalise to unit uz at the top of the solid stack (= the
        # free surface for solid models, the water/solid interface for
        # ocean models — the reference's bb divisor, surfa.f:1060-1066,
        # whose water branch copies the interface row to the top)
        norm = prof[0, 1]
        norm = jnp.where(jnp.abs(norm) > 0, norm, 1.0)
        prof = prof / norm
        # physical acoustic fields at the leading water layer tops,
        # rescaled to the same normalisation (uz(interface) = 1); the
        # slaved ur = k szz/(rho om^2) is recomputed per layer top with
        # that layer's rho (ur is discontinuous across fluid interfaces)
        ftops = ftops / uz_int
        ur_w = k * ftops[:, 3] / (rho_f * om * om)
        ftops = ftops.at[:, 0].set(ur_w)
        prof = jnp.where(wtop[:, None], ftops, prof)
        gate = (idx <= hs)[:, None] & ok
        prof = jnp.where(gate, prof, 0.0)
        return prof, Asys, hs  # columns: ur, uz, szr, szz at layer tops

    # SH waves do not propagate in a fluid: water layers are excluded
    # from the propagation (identity; the reference's jj=2 /
    # b(m)<=0 skips) and their field rows are zero.  b -> 1 keeps the
    # 1/mu entry finite; those matrices only ever multiply zero states.
    b_sh = jnp.where(water, 1.0, b_f)
    Asys = jax.vmap(lambda bb, rr: _sh_system(k, om, bb, rr)
                    )(b_sh, rho_f)
    act = active & ~water
    mats = jax.vmap(
        lambda Al, dl, a_: jax.scipy.linalg.expm(
            -Al * jnp.where(a_, dl, 0.0)))(Asys, d_f, act)
    b_h = jnp.where(jnp.abs(b_f[hs]) > 1e-8, b_f[hs], 1.0)
    nu = k * jnp.sqrt(jnp.maximum(1.0 - (c_safe / b_h) ** 2, 1e-12))
    mu_h = rho_f[hs] * b_h * b_h
    v0 = jnp.stack([jnp.ones_like(k), -mu_h * nu])

    def body(v, M):
        v2 = M @ v
        return v2, v2
    _, states = jax.lax.scan(body, v0, mats, reverse=True)
    norm = states[0, 0]
    norm = jnp.where(jnp.abs(norm) > 0, norm, 1.0)
    prof = states / norm
    gate = (idx <= hs)[:, None] & ok & ~wtop[:, None]
    return jnp.where(gate, prof, 0.0), Asys, hs       # ut, szt


@partial(jax.jit, static_argnames=("wave", "cfg"))
def eigenfunctions(h, vp, vs, rho, qsinv, periods, nlay,
                   wave: str = "rayleigh",
                   cfg: SurfConfig = SurfConfig()):
    """Displacement/stress eigenfunctions at every layer top.

    Returns a dict with the dispersion results (``c``, ``u``,
    ``valid`` of shape (P, nmodes)) plus depth profiles of shape
    (P, nmodes, L):

      Rayleigh: ``ur``, ``uz``, ``szr``, ``szz``  (uz(0) = 1)
      Love:     ``ut``, ``szt``                   (ut(0) = 1)

    ``z`` (L,) gives the flattened-domain depths of the layer tops;
    entries at/below each lane's truncation halfspace decay physically
    and are zeroed past it.

    Water-topped models (leading layers with vs = 0): the Rayleigh
    solid stack is solved against the water-column impedance condition
    (szz = tzz uz, szr = 0 at the interface — the reference's ``tzz``
    coupling, ``surfa.f:876-911``), normalisation is unit uz at the
    water/solid INTERFACE (the reference's convention: its output
    table starts there, SURF_PERTURB ``surfa.f:1375-1379``), and the
    water layer tops carry the physical acoustic fields (szr = 0, ur
    slaved to szz).  Love rows inside water are zero (no SH in fluid).
    """
    c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods,
                                        nlay, wave=wave, cfg=cfg)
    L = h.shape[0]
    idx = jnp.arange(L)
    kind = 1 if wave in ("love", "lov", "L") else 2
    h_eff, fac = model_preamble(h, nlay, kind, cfg.flat)

    nmodes = cfg.nmodes
    t_l = jnp.repeat(periods, nmodes)
    c_l = c_all.reshape(-1)
    ok_l = ok_all.reshape(-1)

    def one(t, c0, ok):
        prof, _, _ = _lane_states(t, c0, ok, vp, vs, rho, fac, cfg,
                                  nlay, kind, idx, qsinv)
        return prof

    profs = jax.vmap(one)(t_l, c_l, ok_l)
    P = periods.shape[0]
    z_tops = jnp.cumsum(fac.h_flat) - fac.h_flat

    out = {"c": c_all, "u": u_all, "valid": ok_all, "z": z_tops}
    if kind == 2:
        prof = profs.reshape(P, nmodes, L, 4)
        out.update(ur=prof[..., 0], uz=prof[..., 1],
                   szr=prof[..., 2], szz=prof[..., 3])
    else:
        prof = profs.reshape(P, nmodes, L, 2)
        out.update(ut=prof[..., 0], szt=prof[..., 1])
    return out


def _exp_pair_integral(coA, coB, p, q):
    """∫_0^∞ f g ds for f = coA·(e^{-ps}, e^{-qs}), g = coB·(...).

    ``coA``/``coB`` are length-2 coefficient vectors on the decaying
    exponentials exp(-p s), exp(-q s).  Closed form of the halfspace
    tail integrals the reference evaluates analytically
    (``surfa.f:618-620`` Love, ``surfa.f:1303-1308`` Rayleigh)."""
    return (coA[0] * coB[0] / (2.0 * p)
            + (coA[0] * coB[1] + coA[1] * coB[0]) / (p + q)
            + coA[1] * coB[1] / (2.0 * q))


@partial(jax.jit, static_argnames=("wave", "cfg", "npanel"))
def energy_integrals(h, vp, vs, rho, qsinv, periods, nlay,
                     wave: str = "rayleigh",
                     cfg: SurfConfig = SurfConfig(),
                     npanel: int = 8, c_given=None):
    """Eigenfunction energy integrals + the integral-path group velocity.

    The reference's second group-velocity implementation: LEIGEN/REIGEN
    accumulate Boole's-rule energy integrals over the eigenfunction
    depth profiles and derive

      Love      (``surfa.f:712-716``):
        I0 = ∫ ρ ut²,  I1 = ∫ μ ut²,  I2 = ∫ μ ut'²
        u  = I1 / (c I0)
        Lagrangian  flagr = ω² I0 - k² I1 - I2        (→ 0 at a root)
        variational k² = (ω² I0 - I2) / I1

      Rayleigh  (``surfa.f:1270-1273, 1333-1338``):
        I0 = ∫ ρ (ur² + uz²),   I1 = ∫ (λ+2μ) ur² + μ uz²
        I2 = ∫ μ uz ur' - λ ur uz',  I3 = ∫ (λ+2μ) uz'² + μ ur'²
        u  = (k I1 + I2) / (ω I0)
        flagr = ω² I0 - k² I1 - 2k I2 - I3
        variational k = (-I2 + sqrt(I2² - I1 (I3 - ω² I0))) / I1

    against the implicit-differentiation group velocity of the main
    dispersion path — two entirely independent formulations (SURVEY §7
    step 1e).  The variational phase velocity ω/k_var is the third
    column of the reference's ``.phv`` output (``calcul_deep.f``).

    Implementation: fields at 4·npanel+1 nodes per layer via
    ``expm(A s) @ prof`` on the `_lane_states` layer-top states
    (composite Boole weights — the reference's 5-point rule per
    ndiv-sublayer), plus the *analytic* halfspace tail from the
    decaying-exponential representation (exactly as the reference,
    which integrates e^{-2νs}-type tails in closed form).  All in the
    attenuated + earth-flattened domain, normalised to unit surface
    displacement — the golden convention (``surfa.f:709-711``).

    A surface water column contributes to the Rayleigh integrals
    through the acoustic fields of `_lane_states` (mu = 0 reduces the
    generic P-SV integrands to the liquid forms the reference
    evaluates in closed trig form, ``surfa.f:1028-1050``); the
    water-only partials are returned as ``I0_wat``..``I3_wat`` (zero
    for solid models) so that closed form can be checked verbatim.
    Love waves carry no fluid motion — water layers stay excluded
    there, as in LEIGEN.

    Returns a dict of (P, nmodes) arrays: ``c``, ``u`` (implicit-diff),
    ``valid``, ``I0``, ``I1``, ``I2``, ``I3`` + ``I*_wat`` (Rayleigh
    only), ``flagr``, ``u_int``, ``c_var``.

    ``c_given``: as in :func:`eigenfunctions_regular` — evaluate at
    externally supplied roots (golden cross-checks near osculations).
    When given, the dispersion solver is skipped entirely (``u`` comes
    back as zeros): the integral path needs only the roots.
    """
    if c_given is not None:
        c_all = jnp.asarray(c_given).reshape(periods.shape[0], cfg.nmodes)
        ok_all = c_all > 0.0
        u_all = jnp.zeros_like(c_all)
    else:
        c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv,
                                            periods, nlay, wave=wave,
                                            cfg=cfg)
    L = h.shape[0]
    idx = jnp.arange(L)
    kind = 1 if wave in ("love", "lov", "L") else 2
    h_eff, fac = model_preamble(h, nlay, kind, cfg.flat)

    nmodes = cfg.nmodes
    t_l = jnp.repeat(periods, nmodes)
    c_l = c_all.reshape(-1)
    ok_l = ok_all.reshape(-1)

    # composite-Boole node offsets (fractions of layer thickness) and
    # weights: npanel panels x 5 nodes, endpoints shared
    nn = 4 * npanel + 1
    frac = jnp.arange(nn) / (nn - 1.0)
    wts = jnp.zeros(nn)
    boole = jnp.array([7.0, 32.0, 12.0, 32.0, 7.0]) / 22.5
    for p_ in range(npanel):
        wts = wts.at[4 * p_: 4 * p_ + 5].add(boole / (4.0 * npanel))
    # wts * d = Boole weights with node spacing d/(4 npanel)

    def one(t, c0, ok):
        prof, Asys, hs = _lane_states(t, c0, ok, vp, vs, rho, fac, cfg,
                                      nlay, kind, idx, qsinv)
        mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
        a_f, b_f, rho_f, d_f = mdl
        mu = rho_f * b_f * b_f
        lam = rho_f * a_f * a_f - 2.0 * mu
        c_safe = jnp.where(ok, c0, b_f[0] + 0.5)
        om = TWO_PI / t
        k = om / c_safe
        water = jnp.abs(b_f) <= 1e-8
        wtop = jnp.cumprod(water.astype(jnp.int32)).astype(bool)
        solid = (idx < hs) & ~water
        # Rayleigh carries energy in the surface water column too
        # (`_lane_states` provides the acoustic fields + embedded fluid
        # system there, mu = 0 reduces the integrands to the liquid
        # forms of surfa.f:1028-1050); Love has no fluid motion.
        contrib = (solid | wtop) if kind == 2 else solid

        def layer_ints(li):
            d = jnp.where(contrib[li], d_f[li], 0.0)
            s_nodes = frac * d

            def at(s):
                w = jax.scipy.linalg.expm(Asys[li] * s) @ prof[li]
                return w, Asys[li] @ w

            w, dw = jax.vmap(at)(s_nodes)            # (nn, ncmp)
            wl = wts * d
            if kind == 2:
                ur, uz = w[:, 0], w[:, 1]
                dur, duz = dw[:, 0], dw[:, 1]
                i0 = rho_f[li] * jnp.sum(wl * (ur * ur + uz * uz))
                i1 = jnp.sum(wl * ((lam[li] + 2 * mu[li]) * ur * ur
                                   + mu[li] * uz * uz))
                i2 = jnp.sum(wl * (mu[li] * uz * dur
                                   - lam[li] * ur * duz))
                i3 = jnp.sum(wl * ((lam[li] + 2 * mu[li]) * duz * duz
                                   + mu[li] * dur * dur))
                return jnp.stack([i0, i1, i2, i3])
            ut, dut = w[:, 0], dw[:, 0]
            i0 = rho_f[li] * jnp.sum(wl * ut * ut)
            i1 = mu[li] * jnp.sum(wl * ut * ut)
            i2 = mu[li] * jnp.sum(wl * dut * dut)
            return jnp.stack([i0, i1, i2])

        per_layer = jax.vmap(layer_ints)(idx)        # (L, 3|4)
        ints = jnp.sum(per_layer, axis=0)
        ints_wat = jnp.sum(jnp.where(wtop[:, None], per_layer, 0.0),
                           axis=0)

        # ---- analytic halfspace tail --------------------------------
        if kind == 2:
            vP0, vS0 = _psv_halfspace_basis(k, om, a_f[hs], b_f[hs],
                                            rho_f[hs])
            V = jnp.stack([vP0, vS0], axis=1)
            G = V.T @ V
            coef = jnp.linalg.solve(G + 1e-30 * jnp.eye(2),
                                    V.T @ prof[hs])
            ga = k * jnp.sqrt(jnp.maximum(
                1.0 - (c_safe / a_f[hs]) ** 2, 1e-12))
            gb = k * jnp.sqrt(jnp.maximum(
                1.0 - (c_safe / b_f[hs]) ** 2, 1e-12))
            # per-component exponential coefficients (P, SV)
            cur = coef * V[0]          # ur  = cur·(e^{-ga s}, e^{-gb s})
            cuz = coef * V[1]
            rates = jnp.stack([ga, gb])
            cdur = -rates * cur        # d/ds of the decaying exps
            cduz = -rates * cuz
            E = partial(_exp_pair_integral, p=ga, q=gb)
            i0 = rho_f[hs] * (E(cur, cur) + E(cuz, cuz))
            i1 = ((lam[hs] + 2 * mu[hs]) * E(cur, cur)
                  + mu[hs] * E(cuz, cuz))
            i2 = mu[hs] * E(cuz, cdur) - lam[hs] * E(cur, cduz)
            i3 = ((lam[hs] + 2 * mu[hs]) * E(cduz, cduz)
                  + mu[hs] * E(cdur, cdur))
            ints = ints + jnp.stack([i0, i1, i2, i3])
            I0, I1, I2, I3 = ints
            # our A&R system carries the opposite relative sign between
            # (ur, szr) and (uz, szz) vs the reference's REIGEN fields
            # (our row 1 is ur' = +k uz + szr/mu; surfa.f:1241 uses
            # durdz = atr/mu - wvno*auz), so the cross-term integral I2
            # flips sign; every quadratic integral is invariant.  Flip
            # to the reference convention, in which u = (k I1 + I2)/
            # (omega I0) reproduces the implicit-diff group velocity.
            I2 = -I2
            u_int = (k * I1 + I2) / (om * I0)
            flagr = om * om * I0 - k * k * I1 - 2.0 * k * I2 - I3
            disc = I2 * I2 - I1 * (I3 - om * om * I0)
            k_var = (-I2 + jnp.sqrt(jnp.abs(disc))) / I1
            c_var = om / k_var
            # water-column partials in the reference convention (same
            # I2 flip) — the verbatim check against surfa.f:1028-1050's
            # closed trig forms lives in tests/test_eigen_water.py
            return jnp.stack([I0, I1, I2, I3, flagr, u_int, c_var,
                              ints_wat[0], ints_wat[1], -ints_wat[2],
                              ints_wat[3]])

        b_h = jnp.where(jnp.abs(b_f[hs]) > 1e-8, b_f[hs], 1.0)
        nu = k * jnp.sqrt(jnp.maximum(1.0 - (c_safe / b_h) ** 2, 1e-12))
        ut_h = prof[hs][0]
        I0 = ints[0] + rho_f[hs] * ut_h * ut_h / (2.0 * nu)
        I1 = ints[1] + mu[hs] * ut_h * ut_h / (2.0 * nu)
        I2 = ints[2] + mu[hs] * ut_h * ut_h * nu / 2.0
        u_int = I1 / (c_safe * I0)
        flagr = om * om * I0 - k * k * I1 - I2
        k_var = jnp.sqrt(jnp.abs(om * om * I0 - I2) / I1)
        c_var = om / k_var
        zero = jnp.zeros_like(I0)
        return jnp.stack([I0, I1, I2, zero, flagr, u_int, c_var,
                          zero, zero, zero, zero])

    outs = jax.vmap(one)(t_l, c_l, ok_l)            # (PN, 11)
    P = periods.shape[0]
    outs = outs.reshape(P, nmodes, 11)
    res = {"c": c_all, "u": u_all, "valid": ok_all,
           "I0": outs[..., 0], "I1": outs[..., 1], "I2": outs[..., 2],
           "flagr": outs[..., 4], "u_int": outs[..., 5],
           "c_var": outs[..., 6]}
    if kind == 2:
        res["I3"] = outs[..., 3]
        res.update(I0_wat=outs[..., 7], I1_wat=outs[..., 8],
                   I2_wat=outs[..., 9], I3_wat=outs[..., 10])
    return res


R0_KM = 6371.0


@partial(jax.jit, static_argnames=("wave", "cfg", "nz"))
def eigenfunctions_regular(h, vp, vs, rho, qsinv, periods, nlay,
                           wave: str = "rayleigh",
                           cfg: SurfConfig = SurfConfig(),
                           dz: float = 2.0, nz: int = 300,
                           c_given=None):
    """Eigenfunctions on a regular *spherical* depth grid.

    The SURF_PERTURB ``-s dz`` capability: the reference samples each
    eigenfunction analytically within the layer containing every grid
    depth (``surfa.f:748-830``) and writes, per (mode, period), rows
    ``z, v*(1-z/R0), v' - v/R0`` of spherical depth, flattening-
    corrected displacement and its spherical-depth derivative
    (``calcul_deep.f:293-296, 381-393``, KEY_FLAT branch).  Here the
    within-layer evaluation is ``expm(Asys s) @ prof`` on the same
    layer-top states the dispersion path produces.

    Returns a dict of (P, nmodes, nz) arrays in the reference's printed
    convention (surface vertical/transverse displacement = 1):

      Rayleigh: ``v1``/``dv1`` (horizontal), ``v2``/``dv2`` (vertical)
      Love:     ``v1``/``dv1`` (transverse)

    plus ``z`` (nz,) spherical depths, ``mask`` (P, nmodes, nz) True
    where the sample lies above the lane's truncation halfspace, and
    the dispersion outputs ``c``, ``u``, ``valid``.

    Water-topped models: samples inside the surface water column carry
    the physical acoustic fields (Rayleigh: slaved horizontal
    displacement + vertical displacement from `_fluid_system4`; Love:
    zero), flagged by the extra ``in_water`` (nz,) output.  NOTE the
    reference's ``-s dz`` writer instead prints ZEROS above the
    water/solid interface (its depth loop starts at ``dept1(1) =
    d(1)``, SURF_PERTURB ``surfa.f:1375,1400``) — mask with
    ``in_water`` before comparing against reference outfiles.

    Sign convention note: the reference's horizontal component is
    positive at the surface for the fundamental mode (its ellipticity
    ``rat`` > 0); ours follows the A&R system sign, which may be
    globally flipped per profile — compare shapes after aligning signs
    at the surface.

    ``c_given`` (P, nmodes), optional: evaluate the eigenfunctions at
    these phase velocities instead of solving for the roots — for
    cross-validating the eigenfunction machinery against an external
    code's roots independently of root parity.
    """
    c_all, u_all, ok_all = surf_forward(h, vp, vs, rho, qsinv, periods,
                                        nlay, wave=wave, cfg=cfg)
    if c_given is not None:
        c_all = jnp.asarray(c_given).reshape(c_all.shape)
        ok_all = c_all > 0.0
    L = h.shape[0]
    idx = jnp.arange(L)
    kind = 1 if wave in ("love", "lov", "L") else 2
    h_eff, fac = model_preamble(h, nlay, kind, cfg.flat)

    z_s = jnp.arange(nz) * dz                       # spherical depths
    if cfg.flat:
        z_f = R0_KM * jnp.log(R0_KM / (R0_KM - z_s))
        amp_fac = 1.0 - z_s / R0_KM
    else:
        z_f = z_s
        amp_fac = jnp.ones_like(z_s)
    z_tops = jnp.cumsum(fac.h_flat) - fac.h_flat
    wtop0 = jnp.cumprod((jnp.abs(vs) <= 1e-8).astype(jnp.int32)
                        ).astype(bool)
    z_int = jnp.sum(jnp.where(wtop0, fac.h_flat, 0.0))
    in_water = z_f < z_int - 1e-9

    nmodes = cfg.nmodes
    t_l = jnp.repeat(periods, nmodes)
    c_l = c_all.reshape(-1)
    ok_l = ok_all.reshape(-1)

    lay = jnp.clip(jnp.searchsorted(z_tops, z_f, side="right") - 1,
                   0, L - 1)

    def one(t, c0, ok):
        prof, Asys, hs = _lane_states(t, c0, ok, vp, vs, rho, fac, cfg,
                                      nlay, kind, idx, qsinv)
        z_hs = z_tops[hs]
        below = z_f > z_hs

        def sample(zf, li, bel):
            s = jnp.where(bel, 0.0, zf - z_tops[li])  # no expm overflow
            w = jax.scipy.linalg.expm(Asys[li] * s) @ prof[li]
            dw = Asys[li] @ w
            return w, dw

        w, dw = jax.vmap(sample)(z_f, lay, below)    # (nz, ncmp) x2

        # Below the truncation halfspace the solution continues as the
        # pure decaying combination — the reference prints this tail
        # analytically too (surfa.f:748-830, halfspace branch).
        mdl = _model_at_period(t, vp, vs, rho, qsinv, fac, cfg)
        a_f, b_f, rho_f, _ = mdl
        c_safe = jnp.where(ok, c0, b_f[0] + 0.5)
        om = TWO_PI / t
        k = om / c_safe
        s_hs = jnp.maximum(z_f - z_hs, 0.0)
        if kind == 2:
            vP0, vS0 = _psv_halfspace_basis(k, om, a_f[hs], b_f[hs],
                                            rho_f[hs])
            V = jnp.stack([vP0, vS0], axis=1)        # (4, 2)
            G = V.T @ V
            coef = jnp.linalg.solve(
                G + 1e-30 * jnp.eye(2), V.T @ prof[hs])
            ga = k * jnp.sqrt(jnp.maximum(
                1.0 - (c_safe / a_f[hs]) ** 2, 1e-12))
            gb = k * jnp.sqrt(jnp.maximum(
                1.0 - (c_safe / b_f[hs]) ** 2, 1e-12))
            decay = jnp.exp(-jnp.stack([ga, gb])[None, :]
                            * s_hs[:, None])         # (nz, 2)
            w_ext = (coef[None, :] * decay) @ V.T    # (nz, 4)
        else:
            b_h = jnp.where(jnp.abs(b_f[hs]) > 1e-8, b_f[hs], 1.0)
            nu = k * jnp.sqrt(jnp.maximum(
                1.0 - (c_safe / b_h) ** 2, 1e-12))
            w_ext = prof[hs][None, :] * jnp.exp(-nu * s_hs)[:, None]
        dw_ext = w_ext @ Asys[hs].T
        w = jnp.where(below[:, None], w_ext, w)
        dw = jnp.where(below[:, None], dw_ext, dw)
        valid = ok & jnp.ones_like(z_f, bool)
        w = jnp.where(valid[:, None], w, 0.0)
        dw = jnp.where(valid[:, None], dw, 0.0)
        return w, dw, valid

    w, dw, valid = jax.vmap(one)(t_l, c_l, ok_l)
    P = periods.shape[0]
    w = w.reshape(P, nmodes, nz, -1)
    dw = dw.reshape(P, nmodes, nz, -1)
    out = {"c": c_all, "u": u_all, "valid": ok_all, "z": z_s,
           "mask": valid.reshape(P, nmodes, nz), "in_water": in_water}
    deriv_corr = (1.0 / R0_KM) if cfg.flat else 0.0
    out["v1"] = w[..., 0] * amp_fac
    out["dv1"] = dw[..., 0] - w[..., 0] * deriv_corr
    if kind == 2:
        out["v2"] = w[..., 1] * amp_fac
        out["dv2"] = dw[..., 1] - w[..., 1] * deriv_corr
    return out
