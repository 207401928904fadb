"""Host-tracing cost breakdown of the grid sampler's segment program.

A fresh process on a PRIMED machine still pays host tracing before
the cached executable loads.  This probe
times ``jax.jit(...).lower()`` (tracing + STABLEHLO lowering, no XLA
compile) of the segment program and of its pieces, so the fix targets
the real cost:

    python scripts/trace_cost.py --points 64 --chainL 200

Pieces timed: the fused forward (surf_forward_batch under the sampler
config), the prior graph (isgood), one proposal-pyramid round
structure, and the whole segment program.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=64)
    ap.add_argument("--chainL", type=int, default=200)
    ap.add_argument("--segment", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        from pysurfinv_tpu.testing import force_cpu
        force_cpu(1, x64=False)
    import jax
    import jax.numpy as jnp

    from examples.invert_point import (localInfo, periods, setting,
                                       uncers, vels)
    from pysurfinv_tpu.inversion.compiled import (BrownianSpec,
                                                  CompiledModel)
    from pysurfinv_tpu.inversion.mcmc import (ChainConfig,
                                              make_segmented_sampler)
    from pysurfinv_tpu.inversion.point import PointCascadia
    from pysurfinv_tpu.ops.dispersion import surf_forward_batch
    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg
    from pysurfinv_tpu.utils import host_eager

    t00 = time.perf_counter()
    pt = PointCascadia(setting, localInfo, periods=periods, vels=vels,
                       uncers=uncers)
    with host_eager():
        cm = CompiledModel(pt.initMod)
        spec1 = cm.spec_of(pt.initMod)
        psi1 = cm.psi_of(pt.initMod)
    print(f"host model build: {time.perf_counter() - t00:.1f}s",
          flush=True)

    n_ch = 6000 // args.chainL
    N = args.points * n_ch
    rep = lambda x: jnp.repeat(jnp.asarray(x)[None], N, 0)  # noqa: E731
    spec = BrownianSpec(*[rep(f) for f in spec1])
    T, c_obs, unc, m_obs = pt._obs_arrays()
    ctx = (rep(psi1), rep(T), rep(c_obs), rep(unc), rep(m_obs))
    scfg = mcmc_solver_cfg()
    cfg = ChainConfig(chain_len=args.chainL)

    def timed_lower(name, fn, *a, **kw):
        t0 = time.perf_counter()
        lowered = jax.jit(fn, **kw).lower(*a)
        t1 = time.perf_counter()
        txt_len = len(lowered.as_text())
        print(f"lower {name:22s} {t1 - t0:6.1f}s  "
              f"(stablehlo {txt_len / 1e6:.1f} MB)", flush=True)
        return lowered

    # 1. fused forward alone
    thetas = spec.theta0
    h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(thetas, ctx[0])

    def fwd(h, vp, vs, rho, qsi, per, nlay, cw):
        return surf_forward_batch(h, vp, vs, rho, qsi, per, nlay,
                                  wave="rayleigh", cfg=scfg, c_warm=cw)

    timed_lower("forward(batch)", fwd, h, vp, vs, rho, qsi, ctx[1],
                nlay, jnp.zeros_like(ctx[1]))

    # 2. prior graph alone (vmapped isgood)
    def prior(th, psi):
        return jax.vmap(cm.isgood)(th, psi)

    timed_lower("isgood(batch)", prior, thetas, ctx[0])

    # 3. whole segment program
    def isgood1(theta, ctx1):
        return cm.isgood(theta, ctx1[0])

    def chi_b(th, cx, cw):
        h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(th, cx[0])
        c, _, okk = surf_forward_batch(h, vp, vs, rho, qsi, cx[1],
                                       nlay, wave="rayleigh", cfg=scfg,
                                       c_warm=cw)
        cP = jnp.where(okk[:, :, 0], c[:, :, 0], 0.0)
        m, chi, L = jax.vmap(
            lambda cp, t, oc, u, mk: pt._misfit_from_c(
                cp, t, oc, u, mk, valid=mk))(cP, cx[1], cx[2], cx[3],
                                             cx[4])
        return m, chi, L, cP

    init_fn, seg_fn = make_segmented_sampler(
        isgood1, chi_b, cfg,
        aux_init=lambda spec_b, ctx_b: jnp.zeros_like(ctx_b[1]))

    keys = jax.vmap(lambda i: jax.random.fold_in(
        jax.random.PRNGKey(0), i))(jnp.arange(N))
    t0 = time.perf_counter()
    carry_shape = jax.eval_shape(init_fn, keys, spec, ctx, spec.theta0,
                                 jnp.zeros((N,), bool))
    print(f"eval_shape init: {time.perf_counter() - t0:.1f}s",
          flush=True)
    carry = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         carry_shape)
    timed_lower("init program", init_fn, keys, spec, ctx, spec.theta0,
                jnp.zeros((N,), bool))
    timed_lower(f"segment({args.segment})",
                lambda c, k, sp, cx, s0: seg_fn(c, k, sp, cx, s0,
                                                args.segment),
                carry, keys, spec, ctx, jnp.asarray(0, jnp.int32))


if __name__ == "__main__":
    main()
