"""Sensitivity-kernel checks.

1. AD kernels vs central finite differences of our own forward — this is
   exactly the cross-validation the reference performs between
   SensKernel (eigenfunction kernels) and SensKernelPert (+-0.1 % FD
   through fast_surf, senskernel.py:129-158), but with machine-precision
   agreement expected since both sides share one secular function.
2. Apparent Q vs the TEST1 att goldens (calcul.f:256-265).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from pysurfinv_tpu.ops.dispersion import SurfConfig, surf_forward
from pysurfinv_tpu.ops.kernels import sensitivity_kernels


def _args(m):
    return (jnp.array(m["h"]), jnp.array(m["vp"]), jnp.array(m["vs"]),
            jnp.array(m["rho"]), jnp.array(m["qsinv"]))


# The FD reference must be converged well past the FD signal: at the
# library default nbisect=12 the root carries ~3e-7 km/s of Illinois
# truncation error, which divided by the 2e-3 FD step shows up as a
# ~1e-3 *apparent* kernel error that has nothing to do with the AD
# values.  nbisect=30 puts the roots at ~1e-12, and AD-vs-FD agreement
# tightens to <1e-6 of the kernel scale.
_CFG = SurfConfig(nmodes=1, nbisect=30)


@pytest.fixture(scope="module", params=["rayleigh", "love"])
def kr(request, eus_model):
    m = eus_model
    res = sensitivity_kernels(*_args(m), jnp.array(m["periods"]), m["nlay"],
                              wave=request.param, cfg=_CFG)
    return request.param, m, res


def _fd_kernel(m, wave, which, ilayers, rel=1e-3):
    """Central finite difference d(c,u)/d(param_i), reference-style."""
    periods = jnp.array(m["periods"])
    base = {k: np.array(m[k]) for k in ("h", "vp", "vs", "rho", "qsinv")}
    dc, du = [], []
    for i in ilayers:
        out = []
        for sgn in (+1, -1):
            pert = {k: v.copy() for k, v in base.items()}
            step = rel * pert[which][i]
            pert[which][i] += sgn * step
            c, u, ok = surf_forward(
                jnp.array(pert["h"]), jnp.array(pert["vp"]),
                jnp.array(pert["vs"]), jnp.array(pert["rho"]),
                jnp.array(pert["qsinv"]), periods, m["nlay"], wave=wave,
                cfg=_CFG)
            out.append((np.array(c[:, 0]), np.array(u[:, 0]), step))
        (cp, up, s), (cm, um, _) = out
        dc.append((cp - cm) / (2 * s))
        du.append((up - um) / (2 * s))
    return np.array(dc).T, np.array(du).T  # (P, len(ilayers))


@pytest.mark.parametrize("which,attr", [("vs", "dc_dvs"), ("vp", "dc_dvp"),
                                        ("rho", "dc_drho")])
def test_phase_kernels_vs_fd(kr, which, attr):
    wave, m, res = kr
    if wave == "love" and which == "vp":
        pytest.skip("Love waves are independent of Vp")
    ilayers = [0, 5, 17, 30, 50, 64]  # spread through the stack
    fd_c, _ = _fd_kernel(m, wave, which, ilayers)
    ad = np.array(getattr(res, attr))[:, ilayers]
    scale = np.abs(fd_c).max() + 1e-12
    assert np.abs(ad - fd_c).max() / scale < 2e-5


@pytest.mark.parametrize("which,attr", [("vs", "du_dvs"), ("rho", "du_drho")])
def test_group_kernels_vs_fd(kr, which, attr):
    wave, m, res = kr
    ilayers = [5, 17, 30, 50]
    _, fd_u = _fd_kernel(m, wave, which, ilayers)
    ad = np.array(getattr(res, attr))[:, ilayers]
    scale = np.abs(fd_u).max() + 1e-12
    # Looser than the phase-kernel bound: the FD group velocity jumps by
    # ~1e-4 relative when the +- runs freeze different halfspace
    # truncations (the AD value is smooth); the reference's own group
    # kernels use a far cruder dlnT finite difference
    # (GRV_SENS_KERNEL.f:100-108).
    assert np.abs(ad - fd_u).max() / scale < 3e-3


def test_group_velocity_consistent(kr, golden):
    wave, m, res = kr
    wt = "R" if wave == "rayleigh" else "L"
    ref = golden[f"grv_{wt}_0"][:, 1]
    rel = np.abs(np.array(res.u) - ref) / ref
    assert rel.max() < 1e-4


def test_apparent_q_golden(kr, golden):
    """Apparent Q from AD attenuation integrals vs TEST1 .att goldens."""
    wave, m, res = kr
    wt = "R" if wave == "rayleigh" else "L"
    ref = golden[f"att_{wt}_0"][:, 1]
    rel = np.abs(np.array(res.q_app) - ref) / ref
    assert rel.max() < 2e-2


@pytest.mark.parametrize("wave,wt", [("rayleigh", "R"), ("love", "L")])
def test_apparent_q_golden_mode1(wave, wt, eus_model, golden):
    """First-overtone apparent Q vs the TEST1 ``.att`` goldens.

    The reference ships both modes in ``TEST1/test.{R,L}.att``
    (``calcul_deep.f`` writes one Q column per mode); mode 0 is pinned
    by ``test_apparent_q_golden`` above, this closes the mode-1 gap.

    Tiered tolerance (measured residual pattern): at T >= 30 s our AD Q
    matches the golden to ~5e-7 relative — far tighter than mode 0's
    2 % — so those periods are pinned at 1e-4.  At T = 10-20 s the
    golden itself carries up to ~2.5e-2 of error (R: 2.46e-2 @ 10 s,
    L: 4.5e-3 @ 20 s): the overtone eigenfunctions oscillate fastest
    there, and the golden's Q comes from ndiv-sublayer RK4 energy
    integrals of those oscillatory fields while every other period of
    the same run agrees to 1e-6 — a golden-discretisation signature,
    same in kind as GRV_TOL's rationale in test_kernel_golden.py.
    """
    m = eus_model
    res = sensitivity_kernels(*_args(m), jnp.array(m["periods"]), m["nlay"],
                              wave=wave, cfg=SurfConfig(nmodes=2, nbisect=30),
                              group=False)
    q = np.array(res.q_app)        # (P, 2)
    ok = np.array(res.valid)
    assert ok[:, 1].all()          # mode 1 exists at every golden period
    ref = golden[f"att_{wt}_1"][:, 1]
    rel = np.abs(q[:, 1] - ref) / ref
    short = m["periods"] <= 20.0
    assert rel[~short].max() < 1e-4, rel
    assert rel[short].max() < 3e-2, rel
