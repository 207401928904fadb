"""Pallas fused secular kernel vs the XLA reference path.

The Pallas kernel (``ops/pallas_secular.py``) must reproduce the XLA
scan (``ops/secular.py``) bit-for-bit in structure: same attenuation
rescale, same truncation decisions, same recursion, same closure.  Here
it runs in interpreter mode (no GPU needed) in float32 — the dtype it
serves on the GPU — against the XLA path evaluated in float32 on CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pysurfinv_tpu.ops.dispersion import (
    SurfConfig,
    _model_at_period,
    surf_forward,
    surf_forward_batch,
)
from pysurfinv_tpu.ops.flatten import flatten_factors
from pysurfinv_tpu.ops.pallas_secular import secular_lanes
from pysurfinv_tpu.ops.secular import (
    effective_halfspace,
    love_secular,
    rayleigh_secular,
)


@pytest.fixture(scope="module")
def batch(eus_model):
    """3 perturbed copies of the eus model, float32, (B, L) arrays."""
    m = eus_model
    rng = np.random.default_rng(7)
    B = 3
    mk = lambda x: np.repeat(np.asarray(x, np.float32)[None], B, 0)  # noqa
    h, vp, vs = mk(m["h"]), mk(m["vp"]), mk(m["vs"])
    rho, qsi = mk(m["rho"]), mk(m["qsinv"])
    pert = (1.0 + 0.01 * rng.standard_normal(vs.shape)).astype(np.float32)
    vs[1:] *= pert[1:]
    vp[1:] *= pert[1:]
    nlay = np.full((B,), m["nlay"], np.int32)
    return h, vp, vs, rho, qsi, nlay


def _lanes_inputs(batch, periods, cs_per_lane, wave):
    h, vp, vs, rho, qsi, nlay = batch
    B, L = h.shape
    kind = 1 if wave == "love" else 2
    fac = jax.vmap(flatten_factors, in_axes=(0, 0, None))(
        jnp.asarray(h), jnp.asarray(nlay), kind)
    model_T = (jnp.asarray(vp).T, jnp.asarray(vs).T, jnp.asarray(rho).T,
               jnp.asarray(qsi).T, fac.h_flat.T, fac.vel_fac.T,
               fac.rho_fac.T)
    K = len(periods)
    c = jnp.asarray(np.array(cs_per_lane, np.float32))      # (K, B)
    t = jnp.broadcast_to(
        jnp.asarray(np.array(periods, np.float32))[:, None], (K, B))
    return model_T, fac, c, t, jnp.asarray(nlay)


@pytest.mark.quick
@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_kernel_matches_xla_secular(batch, wave):
    """F, b_hs, mm agree with the XLA path across regimes."""
    h, vp, vs, rho, qsi, nlay = batch
    B, L = h.shape
    cfg = SurfConfig()
    periods = [10.0, 25.0, 60.0, 100.0]
    # probe velocities spanning evanescent/oscillatory/liquid regimes
    cs = np.array([[3.0, 3.4, 4.1], [3.2, 3.9, 4.4],
                   [3.6, 4.05, 4.6], [3.8, 4.3, 4.9]], np.float32)
    model_T, fac, c, t, nl = _lanes_inputs(batch, periods, cs, wave)

    F, bhs, mm = secular_lanes(c, t, jnp.zeros(c.shape, jnp.int32),
                               *model_T, nl, wave=wave, interpret=True)
    F, bhs, mm = map(np.asarray, (F, bhs, mm))

    Fx = np.zeros_like(F)
    mmx = np.zeros_like(mm)
    bx = np.zeros_like(bhs)
    for ib in range(B):
        fac_i = jax.tree_util.tree_map(lambda x: x[ib], fac)
        for ik, T in enumerate(periods):
            mdl = _model_at_period(
                jnp.float32(T), jnp.asarray(vp[ib]), jnp.asarray(vs[ib]),
                jnp.asarray(rho[ib]), jnp.asarray(qsi[ib]), fac_i, cfg)
            cv = jnp.float32(cs[ik, ib])
            m_eff = effective_halfspace(cv, jnp.float32(T), mdl[1], mdl[3],
                                        nlay[ib], cfg.fact)
            if wave == "rayleigh":
                val = rayleigh_secular(cv, jnp.float32(T), *mdl, m_eff)
            else:
                val = love_secular(cv, jnp.float32(T), mdl[1], mdl[2],
                                   mdl[3], m_eff)
            Fx[ik, ib] = float(val)
            mmx[ik, ib] = int(m_eff)
            bx[ik, ib] = float(mdl[1][int(m_eff) - 1])

    np.testing.assert_array_equal(mm, mmx)
    np.testing.assert_allclose(bhs, bx, rtol=1e-6)
    # renormalised secular values: compare sign and magnitude loosely —
    # the two paths renormalise at different points so only sign and
    # order of magnitude are contractually shared
    assert np.all(np.sign(F) == np.sign(Fx))
    ratio = np.abs(F) / np.abs(Fx)
    assert ratio.max() / ratio.min() < 1e3


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_frozen_mm(batch, wave):
    """mm_frozen pins the closure layer exactly."""
    periods = [20.0, 50.0]
    cs = np.array([[3.3, 3.5, 3.7], [3.7, 3.9, 4.1]], np.float32)
    model_T, fac, c, t, nl = _lanes_inputs(batch, periods, cs, wave)
    mmf = jnp.full(c.shape, 12, jnp.int32)
    _, _, mm = secular_lanes(c, t, mmf, *model_T, nl, wave=wave,
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(mm), 12)


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_grad_kernel_matches_xla_jvp(batch, wave):
    """secular_lanes_grad: primal == plain kernel; F_T/F_c == XLA jvp.

    The ratio F_T/F_c is the quantity group velocity consumes
    (u = c / (1 - (T/c) F_T/F_c)); the per-layer renorm treats the
    rescale as an AD constant on both paths, so only the ratio is
    contractually shared (absolute tangents carry the scale factors).
    """
    from pysurfinv_tpu.ops.secular import attenuation_rescale
    from pysurfinv_tpu.ops.pallas_secular import secular_lanes_grad

    h, vp, vs, rho, qsi, nlay = batch
    periods = [15.0, 40.0, 90.0]
    cs = np.array([[3.4, 3.5, 3.6], [3.7, 3.8, 3.9],
                   [4.0, 4.1, 4.2]], np.float32)
    model_T, fac, c, t, nl = _lanes_inputs(batch, periods, cs, wave)
    mmf = jnp.full(c.shape, 40, jnp.int32)

    F, Fc, Ft = secular_lanes_grad(c, t, mmf, *model_T, nl, wave=wave,
                                   interpret=True)
    Fp, _, _ = secular_lanes(c, t, mmf, *model_T, nl, wave=wave,
                             interpret=True)
    np.testing.assert_array_equal(np.asarray(F), np.asarray(Fp))

    vp_j, vs_j = jnp.asarray(vp), jnp.asarray(vs)
    rho_j, qsi_j = jnp.asarray(rho), jnp.asarray(qsi)

    def xla_F(cv, tv, ib, ik):
        tm = jnp.asarray(periods[ik], c.dtype)  # material held fixed
        a_t, b_t = attenuation_rescale(vp_j[ib], vs_j[ib], qsi_j[ib], tm)
        a = a_t * fac.vel_fac[ib]
        b = b_t * fac.vel_fac[ib]
        r = rho_j[ib] * fac.rho_fac[ib]
        d = fac.h_flat[ib]
        if wave == "rayleigh":
            return rayleigh_secular(cv, tv, a, b, r, d, 40)
        return love_secular(cv, tv, b, r, d, 40)

    one = jnp.ones((), c.dtype)
    for ik in range(len(periods)):
        for ib in range(h.shape[0]):
            cv = jnp.asarray(cs[ik, ib], c.dtype)
            tv = jnp.asarray(periods[ik], c.dtype)
            _, fc = jax.jvp(lambda x: xla_F(x, tv, ib, ik), (cv,), (one,))
            _, ft = jax.jvp(lambda x: xla_F(cv, x, ib, ik), (tv,), (one,))
            ratio_x = float(ft / fc)
            ratio_p = float(Ft[ik, ib] / Fc[ik, ib])
            assert abs(ratio_p - ratio_x) <= 2e-3 * max(abs(ratio_x), 1e-6)


@pytest.mark.parametrize("nnewton", [0, 2])
def test_batch_fast_path_matches_vmap(batch, nnewton):
    """End-to-end: the Pallas batched solver (interpret) == vmapped XLA.

    Run in float32 on both sides; phase roots agree to the Illinois
    tolerance and validity masks agree exactly.  nnewton=0 exercises
    the separate Illinois + tangent launches (the shipped default);
    nnewton=2 exercises the fused refine_lanes kernel.
    """
    h, vp, vs, rho, qsi, nlay = batch
    periods = jnp.asarray(np.array([10.0, 20.0, 40.0, 80.0], np.float32))
    cfg_x = SurfConfig(nmodes=1, backend="xla")
    cfg_p = SurfConfig(nmodes=1, backend="pallas_interpret",
                       nnewton=nnewton)
    args = tuple(map(jnp.asarray, (h, vp, vs, rho, qsi)))
    cx, ux, okx = surf_forward_batch(*args, periods, jnp.asarray(nlay),
                                     wave="rayleigh", cfg=cfg_x)
    cp, up, okp = surf_forward_batch(*args, periods, jnp.asarray(nlay),
                                     wave="rayleigh", cfg=cfg_p)
    np.testing.assert_array_equal(np.asarray(okx), np.asarray(okp))
    assert np.abs(np.asarray(cx) - np.asarray(cp)).max() < 5e-5
    assert np.abs(np.asarray(ux) - np.asarray(up)).max() < 5e-4


def test_batch_fast_path_multimode_matches_vmap(batch):
    """Fused-path overtone chain == vmapped XLA (modes 0-3).

    The XLA mode chain is pinned against a dense-scan oracle
    (tests/test_overtones.py); this closes the loop for the fused
    path's own per-mode start margins (root_est + 0.1 dc over a
    12-iteration estimate — the round-5 duplicate-mode guard)."""
    h, vp, vs, rho, qsi, nlay = batch
    periods = jnp.asarray(np.array([10.0, 15.0], np.float32))
    kw = dict(nmodes=4, compute_group=False)
    args = tuple(map(jnp.asarray, (h, vp, vs, rho, qsi)))
    cx, _, okx = surf_forward_batch(*args, periods, jnp.asarray(nlay),
                                    wave="rayleigh",
                                    cfg=SurfConfig(backend="xla", **kw))
    cp, _, okp = surf_forward_batch(
        *args, periods, jnp.asarray(nlay), wave="rayleigh",
        cfg=SurfConfig(backend="pallas_interpret", **kw))
    np.testing.assert_array_equal(np.asarray(okx), np.asarray(okp))
    assert np.asarray(okx).all()
    assert np.abs(np.asarray(cx) - np.asarray(cp)).max() < 5e-5
    # strictly increasing mode ordering (no duplicated brackets)
    c = np.asarray(cp)
    assert (np.diff(c, axis=2) > 0).all()


@pytest.mark.parametrize("fhandoff", [False, True])
def test_fused_illinois_matches_separate_launches(batch, fhandoff):
    """SurfConfig.fuse_illinois routes the nbisect Illinois iterations
    through ONE plain-body refine_lanes launch; the algorithm is the
    same as illinois_lanes' separate frozen launches (the MCMC sampler
    exposes it via PYSURFINV_MCMC_FUSE_ILL).  At the default
    fhandoff=False both paths evaluate their own frozen-truncation
    endpoints and the roots are BITWISE identical.  With fhandoff=True
    the separate-launch path seeds its secant with the bracket sweep's
    endpoint values while the fused kernel evaluates its own, so roots
    agree only to the f32 Illinois noise floor (measured worst-lane
    difference 7e-7 km/s; the tangent ratio amplifies that ~1000x
    into u)."""
    h, vp, vs, rho, qsi, nlay = batch
    periods = jnp.asarray(np.array([10.0, 20.0, 40.0, 80.0], np.float32))
    base = dict(nmodes=1, backend="pallas_interpret", coarse=4,
                nbisect=11, fhandoff=fhandoff)
    args = tuple(map(jnp.asarray, (h, vp, vs, rho, qsi)))
    outs = []
    for fuse in (False, True):
        cfg = SurfConfig(fuse_illinois=fuse, **base)
        outs.append(surf_forward_batch(*args, periods, jnp.asarray(nlay),
                                       wave="rayleigh", cfg=cfg))
    (c0, u0, ok0), (c1, u1, ok1) = outs
    np.testing.assert_array_equal(np.asarray(ok0), np.asarray(ok1))
    if fhandoff:
        np.testing.assert_allclose(np.asarray(c0), np.asarray(c1),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(u0), np.asarray(u1),
                                   atol=1e-3)
    else:
        np.testing.assert_array_equal(np.asarray(c0), np.asarray(c1))
        np.testing.assert_array_equal(np.asarray(u0), np.asarray(u1))


@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_tile_padding_bit_identical(batch, wave, monkeypatch):
    """Padding K and B up to whole power-of-two tiles changes nothing.

    The same 3 models and 5 probes run unpadded-looking (alone, padded
    by the wrapper to one tile) and embedded at the head of a batch of
    130 models under a (kb=2, bb=64) tile, which pads both axes; every
    output of the shared lanes is bitwise identical."""
    from pysurfinv_tpu.ops import pallas_secular as ps

    periods = [10.0, 25.0, 40.0, 60.0, 100.0]
    cs = np.linspace(3.2, 4.4, 15, dtype=np.float32).reshape(5, 3)
    model_T, _, c, t, nl = _lanes_inputs(batch, periods, cs, wave)
    mmf = jnp.full(c.shape, 30, jnp.int32)
    zero = jnp.zeros(c.shape, jnp.int32)

    def run(c, t, zero, mmf, model_T, nl):
        out = ps.secular_lanes(c, t, zero, *model_T, nl, wave=wave,
                               interpret=True)
        out += (ps.secular_lanes_frozen(c, t, mmf, *model_T, nl,
                                        wave=wave, interpret=True),)
        return out + ps.secular_lanes_grad(c, t, mmf, *model_T, nl,
                                           wave=wave, interpret=True)

    small = run(c, t, zero, mmf, model_T, nl)
    reps = -(-130 // 3)
    wide = lambda x: jnp.tile(x, (1, reps))[:, :130]  # noqa: E731
    monkeypatch.setattr(ps, "TILE", ps.Tile(kb=2, bb=64, warps=4))
    jax.clear_caches()
    big = run(wide(c), wide(t), wide(zero), wide(mmf),
              tuple(wide(x) for x in model_T),
              jnp.tile(nl, reps)[:130])
    jax.clear_caches()
    for s, b in zip(small, big):
        np.testing.assert_array_equal(np.asarray(s), np.asarray(b)[:, :3])


@pytest.mark.parametrize("kernel", ["lanes", "frozen", "grad", "refine"])
@pytest.mark.parametrize("wave", ["rayleigh", "love"])
def test_kernels_lower_to_triton(kernel, wave):
    """Every kernel lowers for CUDA to one Triton custom call, here on
    the CPU (cross-lowering): no primitive the Triton route lacks, no
    non-power-of-two load — the model block keeps the eus model's
    L = 72 rows, read one row at a time."""
    import re

    from pysurfinv_tpu.ops import pallas_secular as ps

    L, B, K = 72, 200, 5
    f32 = jnp.float32
    m = [jax.ShapeDtypeStruct((L, B), f32)] * 7
    nl = jax.ShapeDtypeStruct((B,), jnp.int32)
    lk = jax.ShapeDtypeStruct((K, B), f32)
    li = jax.ShapeDtypeStruct((K, B), jnp.int32)
    fn, args = {
        "lanes": (lambda c, t, mm, *mo: ps.secular_lanes(
            c, t, mm, *mo, wave=wave), (lk, lk, li, *m, nl)),
        "frozen": (lambda c, t, mm, *mo: ps.secular_lanes_frozen(
            c, t, mm, *mo, wave=wave), (lk, lk, li, *m, nl)),
        "grad": (lambda c, t, mm, *mo: ps.secular_lanes_grad(
            c, t, mm, *mo, wave=wave), (lk, lk, li, *m, nl)),
        "refine": (lambda lo, hi, t, mm, *mo: ps.refine_lanes(
            lo, hi, t, mm, *mo, wave=wave, n_newton=2),
            (lk, lk, lk, li, *m, nl)),
    }[kernel]
    txt = jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()
    calls = re.findall(r"custom_call @([^\(]+)\(", txt)
    assert calls == ["__gpu$xla.gpu.triton"]


@pytest.mark.chip
def test_compiled_kernels_match_interpret(batch, gpu):
    """On a GPU: the compiled Triton kernel equals its interpret-mode
    run on the same lanes (signs, truncation, halfspace)."""
    cs = np.array([[3.0, 3.4, 4.1], [3.2, 3.9, 4.4]], np.float32)
    model_T, _, c, t, nl = _lanes_inputs(batch, [10.0, 60.0], cs,
                                         "rayleigh")
    zero = jnp.zeros(c.shape, jnp.int32)
    F, bhs, mm = secular_lanes(c, t, zero, *model_T, nl)
    Fi, bhsi, mmi = secular_lanes(c, t, zero, *model_T, nl, interpret=True)
    np.testing.assert_array_equal(np.asarray(mm), np.asarray(mmi))
    np.testing.assert_allclose(np.asarray(bhs), np.asarray(bhsi), rtol=1e-6)
    assert np.all(np.sign(np.asarray(F)) == np.sign(np.asarray(Fi)))
