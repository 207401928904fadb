"""Vmapped Metropolis sampler: many chains per chip, one jitted step.

Reference semantics (``/root/reference/point.py:32-125``):
  * proposal — every Brownian parameter takes a Gaussian step rejected
    until in bounds (brownian.py:20-27) == a truncated normal, which we
    sample directly with ``jax.random.truncated_normal``;
  * whole-model proposals are retried until the prior accepts them
    (models.py:192-205, up to 1000 tries) — here a fixed number of
    masked retry rounds (the acceptance probability of a proposal is
    high, so a handful of rounds reproduces the distribution; a failed
    round falls back to staying put, counted as a rejection);
  * chain segmentation — every ``chainL`` steps the chain restarts from
    a uniform draw (point.py:47-55); segments are *independent*, which
    is exactly what MCinvMP exploits with one process per segment
    (point.py:90-107).  Here each segment is a vmapped lane: the whole
    ``runN``-step inversion runs as (runN // chainL) parallel chains of
    ``chainL`` steps in one ``lax.scan``;
  * Metropolis rule on the soft-capped chi^2 (point.py:26-37), failed
    forward -> misfit 88888 and rejection (point.py:20-21);
  * ``priori=True`` skips the forward entirely to sample the prior
    (point.py:66-69).

``isgood(theta, ctx)`` and ``chi_sqr(theta, ctx)`` receive an arbitrary
per-point context pytree (psi constants + observations), so the same
kernel vmaps over chains within a point and again over grid points —
the sharded 3-D driver (parallel/grid.py).

The recorded track rows are ``[misfit, L, accepted] + theta`` — the npz
chain format PostPoint consumes (point.py:80-85).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class ChainConfig(NamedTuple):
    chain_len: int = 1000          # steps per independent chain segment
    n_perturb_rounds: int = 100    # retry cap, prior-rejected proposals
    n_reset_rounds: int = 500      # retry cap, uniform resets
    priori: bool = False           # sample the prior only
    misfit_fail: float = 88888.0   # sentinel for failed forwards
    propose_flat: int = int(os.environ.get("PYSURFINV_PROPOSE_FLAT",
                                           2048))
    #   ^ target flat batch per retry round (env override for A/B runs)
    #   (batched sampler): stage s of the compacted retry pyramid draws
    #   W_s = clamp(propose_flat // M_s, 1, 64) candidates per lane per
    #   round.  At full lane count W = 1 — the in-chain prior pass rate
    #   is ~55% (measured on real Cascadia chains), isgood is
    #   compute-bound at 1920 lanes, and W = 4 measured SLOWER end to
    #   end (wasted candidate evaluations cost real time) — while the
    #   compacted unfound tail goes WIDE: a pathological lane with a
    #   near-unsatisfiable prior burns its whole ~600-draw budget every
    #   step, and at W = 64 that costs ~10 rounds instead of 600
    #   sequential prior-graph executions.  Results are bit-identical
    #   for any width (see _propose_batched).
    propose_ratio: int = int(os.environ.get("PYSURFINV_PROPOSE_RATIO", 2))
    #   ^ compaction-pyramid shrink factor: stage sizes N/r, N/r^2, ...
    #   Results are bit-identical for any ratio (compaction only moves
    #   lanes between buffer rows); r trades wasted evals on finished
    #   lanes (smaller r compacts sooner) against argsort/gather
    #   overhead per stage.  r=2 measured +11.5% end-to-end over the
    #   round-1 r=4 (49.6k vs 44.3-44.7k solves/s, 64 pts x 6,000,
    #   same-process bracketed A/B): at ~55% prior pass rate the
    #   unfound tail halves every round, so halving stages track it
    #   while quartering stages leave finished lanes burning isgood
    #   evaluations for a full extra round.


def truncated_step(key, theta, step, vmin, vmax):
    """One bounded Gaussian proposal for the whole parameter vector."""
    lo = (vmin - theta) / step
    hi = (vmax - theta) / step
    z = jax.random.truncated_normal(key, lo, hi, shape=theta.shape,
                                    dtype=theta.dtype)
    return theta + z * step


def uniform_reset(key, vmin, vmax, dtype):
    u = jax.random.uniform(key, shape=vmin.shape, dtype=dtype)
    return vmin + u * (vmax - vmin)


def _propose(key, theta, spec, ctx, isgood, cfg: ChainConfig):
    """Prior-accepted proposal: perturb retries, then uniform resets
    (models.py:192-219), as ONE fused early-exit retry loop.

    Round i draws a bounded-Gaussian whole-model step while
    ``i < n_perturb_rounds`` and a uniform reset after — the same
    draw sequence as the reference's two nested loops, in a single
    ``while_loop`` with exactly one ``isgood`` (grid build + priors)
    per round.  The round-1 implementation nested the reset loop
    inside a ``lax.cond``; under vmap a cond lowers to both branches,
    so the reset ``while_loop`` ran to its all-lanes-found fixed point
    on EVERY Metropolis step — ~10-20 wasted full grid builds per
    step, which dominated real-workload sampling (measured: the
    batched forward was < 5% of step time).  Typical proposals pass
    in 1-2 rounds.
    """
    max_rounds = cfg.n_perturb_rounds + cfg.n_reset_rounds

    def cond(s):
        i, found, _, _ = s
        return (i < max_rounds) & ~found

    def body(s):
        i, found, cand, k = s
        k, k1 = jax.random.split(k)
        stepped = truncated_step(k1, theta, spec.step, spec.vmin,
                                 spec.vmax)
        fresh = uniform_reset(k1, spec.vmin, spec.vmax, theta.dtype)
        prop = jnp.where(i < cfg.n_perturb_rounds, stepped, fresh)
        good = isgood(prop, ctx)
        cand = jnp.where(good & ~found, prop, cand)
        return i + 1, found | good, cand, k

    # derive the initial flag from the candidate so its sharding
    # "varying" type matches the body output under shard_map
    found0 = jnp.zeros_like(theta, bool).any()
    _, found, cand, _ = lax.while_loop(
        cond, body, (jnp.zeros((), jnp.int32), found0, theta, key))
    return cand, found


def _propose_batched(keys, thetas, spec_b, ctx_b, isgood, cfg: ChainConfig,
                     min_stage: int = 32, skip=None):
    """``vmap(_propose)`` with tail compaction — bitwise-identical lanes.

    The vmapped retry loop runs until EVERY lane has a prior-accepted
    proposal: expected rounds ~ ln(N)/p for prior pass rate p, while
    the per-lane work floor is ~1/p — the all-lanes loop wastes the
    gap on finished lanes (in-chain pass rate measured ~55% on real
    Cascadia chains).  Here, whenever the unfound tail fits a 4x
    smaller buffer, it is compacted (argsort on
    the found flag + gather) and the loop continues at that size, so
    finished lanes stop consuming ``isgood`` evaluations.

    Per-lane results are bit-identical to ``vmap(_propose)``: each
    lane's candidate depends only on its own key chain and its own
    first-success draw index, and both are preserved exactly —
    compaction only changes which buffer row a lane occupies, and the
    ``propose_width``-wide rounds only change how many chain draws are
    materialised per round (tests/test_compiled_mcmc.py asserts the
    equivalence).  Sole deviation: the retry cap is honoured to within
    one stage-width of ``n_perturb_rounds + n_reset_rounds`` (a lane
    succeeding inside that sliver counts as found where the sequential
    loop would have given up).

    ``skip``: optional traced scalar bool; True marks every lane found
    before the first round, so the retry loops exit immediately and the
    input ``thetas`` come back unchanged (used by the merged init row
    of the segment scan, whose proposal is discarded anyway).
    """
    N, Pdim = thetas.shape
    max_rounds = cfg.n_perturb_rounds + cfg.n_reset_rounds
    visgood = jax.vmap(isgood)

    # A/B knobs re-read at TRACE time (ChainConfig defaults freeze the
    # env at import): a live env override wins over the config so the
    # same process can vary them (after clearing the traced-program
    # cache between variants).
    def _env_int(name, default):
        v = os.environ.get(name)
        return int(v) if v is not None else int(default)

    propose_flat = _env_int("PYSURFINV_PROPOSE_FLAT", cfg.propose_flat)

    def vdraw(r, k1, th, sp):
        def one(k, t, vmin, vmax, step):
            return jnp.where(r < cfg.n_perturb_rounds,
                             truncated_step(k, t, step, vmin, vmax),
                             uniform_reset(k, vmin, vmax, t.dtype))
        return jax.vmap(one)(k1, th, sp.vmin, sp.vmax, sp.step)

    def run_stage(state, th, sp, cx, stop_at):
        """Wide retry rounds until the unfound tail <= stop_at (or cap).

        Each round advances every lane's key chain by W draws and
        evaluates all W x M candidates in one flattened isgood batch;
        a lane keeps the FIRST passing candidate in global draw order
        — exactly what W sequential rounds would have kept.  W scales
        inversely with the stage size (see ChainConfig.propose_flat):
        full-size stages run W = 1, the compacted pathological tail
        runs wide so its retry budget drains in few rounds.
        """
        M = th.shape[0]
        W = max(min(propose_flat // M, 64), 1)
        cxw = jax.tree.map(
            lambda x: jnp.tile(x, (W,) + (1,) * (x.ndim - 1)), cx)

        def cond(s):
            r, found, _, _ = s
            return (r < max_rounds) & (jnp.sum(~found) > stop_at)

        def body(s):
            r, found, cand, ks = s
            k = ks
            if W <= 2:
                props = []
                for j in range(W):              # unrolled key-chain walk
                    k2 = jax.vmap(jax.random.split)(k)
                    k, kj = k2[:, 0], k2[:, 1]
                    props.append(vdraw(r + j, kj, th, sp))
                props = jnp.stack(props)        # (W, M, P)
            else:
                # identical key-chain walk as a lax.scan: the draw body
                # traces ONCE instead of W times (at the compacted tail
                # W reaches 64, and the unrolled walk dominated fresh-
                # process host tracing of the segment program).  Values
                # are bitwise identical — same ops, same order, scan
                # stacks along axis 0 exactly like the Python loop
                # (gated by tests/test_compiled_mcmc.py's width
                # equivalence asserts).
                def draw_j(kc, j):
                    k2 = jax.vmap(jax.random.split)(kc)
                    return k2[:, 0], vdraw(r + j, k2[:, 1], th, sp)

                k, props = lax.scan(draw_j, k,
                                    jnp.arange(W, dtype=jnp.int32))
            good = visgood(props.reshape(W * M, Pdim),
                           cxw).reshape(W, M)
            first = jnp.argmax(good, axis=0)    # first passing draw
            has = jnp.any(good, axis=0)
            pick = props[first, jnp.arange(M)]
            upd = has & ~found
            cand = jnp.where(upd[:, None], pick, cand)
            return r + W, found | has, cand, k

        return lax.while_loop(cond, body, state)

    # stage pyramid: N -> N/r -> N/r^2 -> ... (>= min_stage).  min_stage
    # bounds per-stage overhead (argsort + gathers + while_loop cond
    # rounds): r and min_stage trade wasted isgood evaluations on
    # finished lanes against fixed per-stage cost — re-measure on-chip
    # when the isgood graph's cost changes (the env knobs above).
    ratio = max(_env_int("PYSURFINV_PROPOSE_RATIO", cfg.propose_ratio), 2)
    # clamp >= 1: min_stage <= 0 would spin the pyramid-size loop forever
    # (m reaches 0 and `0 >= min_stage` stays true while m //= ratio
    # keeps m at 0)
    min_stage = max(_env_int("PYSURFINV_PROPOSE_MINSTAGE", min_stage), 1)
    sizes = []
    m = N // ratio
    while m >= min_stage:
        sizes.append(m)
        m //= ratio

    found = jnp.zeros((N,), bool)
    if skip is not None:
        found = found | skip
    r = jnp.zeros((), jnp.int32)
    r, found, cand, ks = run_stage((r, found, thetas, keys), thetas,
                                   spec_b, ctx_b,
                                   sizes[0] if sizes else 0)
    for i, M in enumerate(sizes):
        stop = sizes[i + 1] if i + 1 < len(sizes) else 0
        idx = jnp.argsort(found)[:M]           # unfound lanes first
        take = lambda a: jax.tree.map(lambda x: x[idx], a)  # noqa: E731
        st = (r, found[idx], cand[idx], take(ks))
        r, f_s, c_s, k_s = run_stage(st, thetas[idx], take(spec_b),
                                     take(ctx_b), stop)
        found = found.at[idx].set(f_s)
        cand = cand.at[idx].set(c_s)
        ks = jax.tree.map(lambda x, y: x.at[idx].set(y), ks, k_s)
    return cand, found


def make_chain_kernel(isgood, chi_sqr, cfg: ChainConfig):
    """Build the per-chain sampler.

    Args:
      isgood:  (theta, ctx) -> bool (vectorised prior).
      chi_sqr: (theta, ctx) -> (misfit, chiSqr, L); never called in
               priori mode.
      cfg:     ChainConfig.

    Returns ``run(key, spec, ctx, theta_init, use_init) -> track`` of
    shape (chain_len, 3 + ntheta): columns [misfit, L, accepted, theta].
    """

    def eval_misfit(theta, ctx):
        if cfg.priori:
            z = jnp.zeros((), theta.dtype)
            return z, z, jnp.ones((), theta.dtype)
        return chi_sqr(theta, ctx)

    def init_state(key, spec, ctx, theta_init, use_init):
        k1, k2 = jax.random.split(key)
        theta_reset, _ = _propose(
            k1, uniform_reset(k2, spec.vmin, spec.vmax, spec.theta0.dtype),
            spec, ctx, isgood, cfg._replace(n_perturb_rounds=1))
        theta = jnp.where(use_init, theta_init, theta_reset)
        misfit, chi, L = eval_misfit(theta, ctx)
        return theta, misfit, chi, L

    def step(spec, ctx, carry, key):
        theta0, misfit0, chi0, L0 = carry
        k_prop, k_acc = jax.random.split(key)
        theta1, ok = _propose(k_prop, theta0, spec, ctx, isgood, cfg)
        if cfg.priori:
            row = jnp.concatenate([jnp.zeros(2, theta1.dtype),
                                   jnp.ones(1, theta1.dtype), theta1])
            return (theta1, misfit0, chi0, L0), row

        misfit1, chi1, L1 = eval_misfit(theta1, ctx)
        # Metropolis on chi^2 (point.py:34-37); prior-failed proposal or
        # failed forward is rejected.
        u = jax.random.uniform(k_acc, dtype=theta1.dtype)
        accept = (chi1 < chi0) | (u > 1.0 - jnp.exp(-(chi1 - chi0) / 2.0))
        accept = accept & ok & (misfit1 < cfg.misfit_fail)
        row = jnp.concatenate([
            jnp.stack([misfit1, L1, accept.astype(theta1.dtype)]), theta1])
        new = (jnp.where(accept, theta1, theta0),
               jnp.where(accept, misfit1, misfit0),
               jnp.where(accept, chi1, chi0),
               jnp.where(accept, L1, L0))
        return new, row

    def run(key, spec, ctx, theta_init, use_init):
        k0, ks = jax.random.split(key)
        theta, misfit, chi, L = init_state(k0, spec, ctx, theta_init,
                                           use_init)
        first_row = jnp.concatenate([
            jnp.stack([misfit, L, jnp.ones((), theta.dtype)]), theta])
        keys = jax.random.split(ks, cfg.chain_len - 1)
        _, rows = lax.scan(lambda c, k: step(spec, ctx, c, k),
                           (theta, misfit, chi, L), keys)
        return jnp.concatenate([first_row[None], rows], axis=0)

    return run


def make_segmented_sampler(isgood, chi_sqr_batch, cfg: ChainConfig,
                           aux_init=None):
    """Init/segment pair behind :func:`make_batched_sampler`.

    Splitting the time-major scan into segments enables mid-chain
    checkpoint/resume and retry-on-device-fault (``parallel.grid``):
    every row's RNG draws are a pure function of (lane key, global row
    index), so running the chain as one scan or as any sequence of
    segments is bitwise identical (asserted by
    ``tests/test_parallel_grid.py``).

    The chain-format init row is ROW 0 of the first segment: ``init_fn``
    only builds prior-accepted start thetas (no forward), and the
    segment scan evaluates them at global row 0 with acceptance forced.
    This keeps the dispersion solver traced and compiled exactly ONCE
    per run — a separate init program duplicating the forward measured
    ~15 s of host tracing plus a second large XLA program.

    ``aux_init``: optional ``(spec_b, ctx_b) -> array`` building the
    initial per-lane auxiliary state.  When set, ``chi_sqr_batch`` is
    called as ``chi(thetas, ctx_b, aux)`` and must return
    ``(misfit, chi, L, aux')``; ``aux`` always carries the LAST
    EVALUATED value
    (accepted or not) — the warm-start contract of
    ``surf_forward_batch(c_warm=...)``: the previous evaluation's roots
    seed the next bracket, and zeros mean "cold".

    Returns ``(init_fn, segment_fn)``:
      init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b)
        -> carry                   carry = (theta, misfit, chi, L)
                                   (+ aux when ``aux_init`` is set);
                                   misfit/chi/L are zeros until row 0
                                   evaluates them
      segment_fn(carry, lane_keys, spec_b, ctx_b, s0, n_steps)
        -> (carry, rows)           rows (n_steps, N, 3 + k); covers
                                   global rows s0 .. s0 + n_steps - 1
                                   (``n_steps`` static, ``s0`` traced)
    """

    def eval_all(thetas, ctx_b, aux):
        if cfg.priori:
            N = thetas.shape[0]
            z = jnp.zeros((N,), thetas.dtype)
            return z, z, jnp.ones((N,), thetas.dtype), aux
        if aux_init is None:
            return (*chi_sqr_batch(thetas, ctx_b), aux)
        return chi_sqr_batch(thetas, ctx_b, aux)

    def init_fn(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        CL = cfg.chain_len
        dtype = spec_b.theta0.dtype

        def init_lane(lk, spec1, ctx1, th_init, ui):
            k1 = jax.random.fold_in(lk, 2 * CL)
            k2 = jax.random.fold_in(lk, 2 * CL + 1)
            th_r, _ = _propose(
                k1, uniform_reset(k2, spec1.vmin, spec1.vmax, dtype),
                spec1, ctx1, isgood, cfg._replace(n_perturb_rounds=1))
            return jnp.where(ui, th_init, th_r)

        theta = jax.vmap(init_lane)(lane_keys, spec_b, ctx_b,
                                    theta_init_b, use_init_b)
        z = jnp.zeros((theta.shape[0],), dtype)
        if aux_init is None:
            return (theta, z, z, z)
        return (theta, z, z, z, aux_init(spec_b, ctx_b))

    def segment_fn(carry, lane_keys, spec_b, ctx_b, s0, n_steps):
        N = spec_b.theta0.shape[0]
        dtype = spec_b.theta0.dtype

        def step(carry, r):
            theta0, m0, chi0, L0, *aux = carry
            aux0 = aux[0] if aux else None
            at_init = r == 0  # row 0 = evaluate-the-start-model row
            k_prop = jax.vmap(lambda lk: jax.random.fold_in(lk, 2 * r))(
                lane_keys)
            theta1, okp = _propose_batched(k_prop, theta0, spec_b, ctx_b,
                                           isgood, cfg, skip=at_init)
            if cfg.priori:
                Lcol = jnp.broadcast_to(
                    jnp.where(at_init, 1.0, 0.0).astype(dtype), (N, 1))
                row = jnp.concatenate(
                    [jnp.zeros((N, 1), dtype), Lcol,
                     jnp.ones((N, 1), dtype), theta1], axis=1)
                return (theta1, m0, chi0, L0, *aux), row
            m1, chi1, L1, aux1 = eval_all(theta1, ctx_b, aux0)
            u = jax.vmap(lambda lk: jax.random.uniform(
                jax.random.fold_in(lk, 2 * r + 1), dtype=dtype))(lane_keys)
            accept = (chi1 < chi0) | (u > 1.0 - jnp.exp(-(chi1 - chi0) / 2))
            accept = at_init | (accept & okp & (m1 < cfg.misfit_fail))
            row = jnp.concatenate(
                [jnp.stack([m1, L1, accept.astype(dtype)], axis=1), theta1],
                axis=1)
            acc = accept[:, None]
            new = (jnp.where(acc, theta1, theta0),
                   jnp.where(accept, m1, m0),
                   jnp.where(accept, chi1, chi0),
                   jnp.where(accept, L1, L0),
                   *((aux1,) if aux else ()))
            return new, row

        return lax.scan(step, carry, s0 + jnp.arange(n_steps))

    return init_fn, segment_fn


def make_batched_sampler(isgood, chi_sqr_batch, cfg: ChainConfig):
    """Time-major sampler: one fused *batched* forward per MCMC step.

    ``make_chain_kernel`` nests the time loop inside each vmapped chain,
    so the dispersion solve runs as vmapped single-model XLA scans.
    Here the loop order is inverted: every lane (chain, or point x
    chain) advances one Metropolis step per ``lax.scan`` iteration, and
    all lanes' forwards evaluate in ONE ``chi_sqr_batch`` call — which
    routes through ``surf_forward_batch`` and hence the fused secular
    kernels on a GPU.

    Args:
      isgood:        (theta, ctx_lane) -> bool, single lane (vmapped
                     internally — its retry while_loops stay per-lane).
      chi_sqr_batch: (thetas (N, k), ctx_batched) -> (misfit, chi, L)
                     each (N,).  Never called in priori mode.
      cfg:           ChainConfig.

    Returns ``run(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b)
    -> track`` of shape (N, chain_len, 3 + k); all args carry a leading
    lane axis N.  ``lane_keys`` are per-lane PRNG keys — derive them
    from *global* lane indices (``fold_in(PRNGKey(seed), lane_id)``)
    and every lane's stream is a pure function of its key: the result
    is bitwise identical however the lane axis is sharded or padded.
    RNG streams differ from ``make_chain_kernel``; both samplers
    target the identical stationary distribution.
    """

    init_fn, segment_fn = make_segmented_sampler(isgood, chi_sqr_batch,
                                                  cfg)

    def run(lane_keys, spec_b, ctx_b, theta_init_b, use_init_b):
        carry = init_fn(lane_keys, spec_b, ctx_b, theta_init_b,
                        use_init_b)
        _, rows = segment_fn(carry, lane_keys, spec_b, ctx_b,
                             jnp.asarray(0, jnp.int32), cfg.chain_len)
        # rows: (chain_len, N, 3+k) -> (N, chain_len, 3+k); row 0 is
        # the init-evaluation row
        return jnp.moveaxis(rows, 0, 1)

    return run


def run_chains(kernel, key, spec, ctx, n_chains: int):
    """vmap the chain kernel within one point: chain 0 starts from theta0
    (init=True), the rest from uniform resets — the MCinvMP layout
    (point.py:101-102)."""
    keys = jax.random.split(key, n_chains)
    use_init = jnp.arange(n_chains) == 0
    run = jax.jit(jax.vmap(
        lambda k, ui: kernel(k, spec, ctx, spec.theta0, ui)))
    return run(keys, use_init)
