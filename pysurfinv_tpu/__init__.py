"""pysurfinv_tpu — accelerator-native surface-wave dispersion inversion.

A ground-up JAX/XLA/Pallas re-design of the capabilities of pySurfInv
(reference: /root/reference): Markov-chain Monte Carlo inversion of
Rayleigh/Love surface-wave dispersion for 1-D layered shear-velocity
profiles, assembled over geographic grids into 3-D models.

Design principles:
  * The Thomson–Haskell / Dunkin dispersion solve is a batched,
    differentiable JAX primitive (masked ``lax.scan`` over padded layer
    stacks) instead of an f2py-wrapped Fortran subroutine per model.
  * Root finding uses uniform control flow (fine c-grid bracketing +
    fixed-iteration bisection) so thousands of models solve in lockstep
    on the GPU (Triton kernels, ``ops/pallas_secular.py``).
  * Group velocities and depth sensitivity kernels come from implicit
    differentiation of the secular function (AD), replacing the
    reference's eigenfunction energy integrals (surfa.f LEIGEN/REIGEN)
    and the triple-run finite-difference kernel pipeline (senskernel-1.0).
  * MCMC chains are vmapped on the device; geographic grid points shard
    across the devices of a ``jax.sharding.Mesh``.
"""

__version__ = "0.2.0"

from pysurfinv_tpu.ops.dispersion import (  # noqa: F401
    surf_forward,
    surf_forward_batch,
    surf_forward_joint,
    surf_ellipticity,
    surf_amplitude,
    SurfConfig,
)


def __getattr__(name):
    """Lazy top-level re-exports of the main user-facing classes.

    Importing them eagerly would pull matplotlib/pandas into every
    process (including pure solver workloads); lazy access keeps
    ``import pysurfinv_tpu`` light while letting users write e.g.
    ``pysurfinv_tpu.Point`` / ``Model3D`` / ``buildModel1D`` directly.
    """
    _lazy = {
        "buildModel1D": "pysurfinv_tpu.models.model1d",
        "Model1D": "pysurfinv_tpu.models.model1d",
        "buildSeisLayer": "pysurfinv_tpu.models.layers",
        "BrownianVar": "pysurfinv_tpu.models.brownian",
        "BrownianVarMC": "pysurfinv_tpu.models.brownian",
        "Point": "pysurfinv_tpu.inversion.point",
        "PointCascadia": "pysurfinv_tpu.inversion.point",
        "PostPoint": "pysurfinv_tpu.inversion.point",
        "PostPointCascadia": "pysurfinv_tpu.inversion.point",
        "invert_grid": "pysurfinv_tpu.parallel.grid",
        "Model3D": "pysurfinv_tpu.geo.model3d",
        "Model1D_Exchange": "pysurfinv_tpu.geo.exchange",
        "Model3D_Exchange": "pysurfinv_tpu.geo.exchange",
        "SensKernel": "pysurfinv_tpu.senskernel",
        "SensKernelPert": "pysurfinv_tpu.senskernel",
        "sensitivity_kernels": "pysurfinv_tpu.ops.kernels",
        "eigenfunctions": "pysurfinv_tpu.ops.eigen",
        "eigenfunctions_regular": "pysurfinv_tpu.ops.eigen",
        "mala_point": "pysurfinv_tpu.inversion.mala",
        "adaptive_point": "pysurfinv_tpu.inversion.adaptive",
        "tuned_rwm_point": "pysurfinv_tpu.inversion.adaptive",
        "AdaptConfig": "pysurfinv_tpu.inversion.adaptive",
    }
    if name in _lazy:
        import importlib

        return getattr(importlib.import_module(_lazy[name]), name)
    raise AttributeError(f"module 'pysurfinv_tpu' has no attribute {name!r}")
