"""Sharded 3-D grid inversion: all grid points in one SPMD program.

The reference runs each geographic point as a separate OS job writing
``lon_lat.npz`` (``/root/reference/model3D.py:36-57``), with chains as
separate processes per point (``point.py:90-107``).  Here:

    mesh axis "points"  — grid points, data-parallel across devices
    vmap axis           — chains within a point
    lax.scan            — steps within a chain

All points must share one model *structure* (the YAML setting); they
differ only through localInfo-injected constants (water depth, sediment
thickness, plate age, topo) and per-point Brownian bounds — both live in
per-point vectors (psi, theta bounds) so a single compiled program
serves the whole grid.  Mixed settings (ocean + continent grids) are
handled by calling ``invert_grid`` once per model family.

Very large grids auto-tile into programs of at most ``max_lanes``
(point, chain) lanes: per-lane work is identical, so tiling changes no
result.  Tiles reuse the traced program and the persistent compile
cache — only the first pays compilation — and lane PRNG keys are offset
per tile, so tiled and untiled runs produce bitwise-identical tracks.

Output: one ``{lon:g}_{lat:g}.npz`` per point in the reference chain
format, directly consumable by PostPoint / Model3D.loadInvDir.
"""

from __future__ import annotations

import os
import time

import numpy as np

# ---- traced-program cache ------------------------------------------------
# Tracing the batched segment program costs ~15-20 s of host time (the
# grid build + priors + solver graph is large, and the proposal pyramid
# traces it at several batch sizes).  The trace depends only on the
# model *structure*, the point-class likelihood, and the solver/sampler
# configs — NOT on parameter values, observations, or lane count (jit
# re-specializes per shape under the same callable) — so one traced
# program serves every tile of a large grid and every repeat call in a
# process.  Keyed LRU below; values are (init_all, seg_all) as built by
# ``_batched_programs``.
_PROGRAM_CACHE = {}
_PROGRAM_CACHE_MAX = 8


def _fetch_rows(rows_dev):
    """Device -> host fetch of one segment's rows, optionally as
    parallel chunk streams (``PYSURFINV_FETCH_STREAMS=k``).

    Chunks slice the lane axis; the result is byte-identical to a
    whole-array fetch.  Default 1 stream (plain ``np.asarray``); more
    streams help only where one device->host stream cannot saturate
    the link.
    """
    k = int(os.environ.get("PYSURFINV_FETCH_STREAMS", "1"))
    n_lanes = rows_dev.shape[1]
    if k <= 1 or n_lanes < 2 * k:
        return np.asarray(rows_dev)
    from concurrent.futures import ThreadPoolExecutor
    bounds = np.linspace(0, n_lanes, k + 1).astype(int)
    parts = [rows_dev[:, a:b] for a, b in zip(bounds[:-1], bounds[1:])]
    out = np.empty(rows_dev.shape, rows_dev.dtype)
    def pull(i):
        out[:, bounds[i]:bounds[i + 1]] = np.asarray(parts[i])
    with ThreadPoolExecutor(max_workers=k) as pool:
        list(pool.map(pull, range(k)))
    return out


def _structure_key(cm):
    """Hashable fingerprint of everything a CompiledModel bakes into the
    traced graph as a constant: layer classes and static parms (theta /
    psi slots masked — their values flow in as arguments), info entries
    not routed through psi, frozen fine-grid sizes, and the node/group
    layout."""
    theta_tags = [f"<theta{i}>" for i in range(len(cm._slots))]
    psi_tags = [f"<psi{j}>" for j in range(len(cm._const_slots))]
    parms = cm._substitute(theta_tags, psi_tags)
    info = {k: ("<psi>" if k in ("topo", "lithoAge") else v)
            for k, v in cm.info.items()}
    return (type(cm.model).__name__,
            tuple(type(l).__name__ for l in cm._layers),
            repr(parms), repr(sorted(info.items(), key=str)),
            tuple(cm._nfine), cm.L, cm._use_ref,
            cm.grp_nodes.tobytes(), cm.name_nodes.tobytes())


def mcmc_solver_cfg():
    """The dispersion-solver configuration of the MCMC samplers —
    ONE definition so host recomputations (tests, PostPoint checks)
    can reproduce recorded misfits exactly on the XLA path.

    Window sizing: the sampler seeds every period's bracket at
    (previous evaluated root - warm_backoff*dc) and sweeps nscan*dc
    (ops/dispersion.py c_warm).  Per-step root drift measured on real
    Cascadia chains (8192 consecutive evaluated pairs x 18 periods):
    signed drift within [-6.9, +7.2]*dc — so [-12, +20]*dc misses
    ~never and the all-lanes rescue cond stays cold.  coarse=8: the
    warm sweep probes the window at 8*dc and hands the refinement an
    8*dc bracket.

    newton_sep=3: on the kernel path the refinement runs as 3
    separated safeguarded-Newton gradient launches instead of nbisect
    Illinois launches (the XLA path ignores it and keeps Illinois — it
    is the oracle/CPU path).  newton_sep=2 was found to bias chain
    statistics (scripts/compare_tracks.py).  The Newton path is
    covered by the interpret-mode root-accuracy gate
    (tests/test_warm_roots.py::test_mcmc_newton_refinement_accuracy);
    docs/POSTERIOR_PARITY.md records the statistical checks.

    These settings were tuned on earlier hardware; their H100 timing
    is ROADMAP §1 item 3.  The PYSURFINV_MCMC_* env knobs exist for
    on-chip A/B runs only; the committed defaults are the validated
    configuration.
    """
    from pysurfinv_tpu.ops.dispersion import SurfConfig
    e = os.environ.get
    return SurfConfig(nmodes=1, compute_group=False,
                      nscan=int(e("PYSURFINV_MCMC_NSCAN", 32)),
                      warm_backoff=int(e("PYSURFINV_MCMC_BACKOFF", 12)),
                      nbisect=int(e("PYSURFINV_MCMC_NBISECT", 11)),
                      coarse=int(e("PYSURFINV_MCMC_COARSE", 8)),
                      fuse_illinois=e("PYSURFINV_MCMC_FUSE_ILL", "0") == "1",
                      nnewton=int(e("PYSURFINV_MCMC_NNEWTON", 0)),
                      newton_sep=int(e("PYSURFINV_MCMC_NEWTON_SEP", 3)),
                      fhandoff=e("PYSURFINV_MCMC_FHANDOFF", "0") == "1",
                      coarse_first=8)


def _batched_programs(cm, pcls, cfg, wave, scfg, mesh):
    """(init_all, seg_all) for the batched sampler, traced at most once
    per (structure, likelihood, config, mesh) per process."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from pysurfinv_tpu.inversion.mcmc import make_segmented_sampler
    from pysurfinv_tpu.ops.dispersion import surf_forward_batch

    key = (_structure_key(cm),
           f"{pcls.__module__}.{pcls.__qualname__}",
           cfg, wave, scfg,
           tuple(int(d.id) for d in mesh.devices.flat),
           bool(jax.config.jax_enable_x64))
    hit = _PROGRAM_CACHE.pop(key, None)
    if hit is not None:
        _PROGRAM_CACHE[key] = hit  # LRU refresh
        return hit

    misfit_from_c = pcls._misfit_from_c

    def isgood(theta, ctx):
        return cm.isgood(theta, ctx[0])

    def chi_sqr_batch(thetas, ctx_b, c_warm):
        psi_b, per_b, c_b, u_b, m_b = ctx_b
        h, vp, vs, rho, qsi, nlay = cm.build_profile_batch(thetas, psi_b)
        c, _, okk = surf_forward_batch(h, vp, vs, rho, qsi, per_b,
                                       nlay, wave=wave, cfg=scfg,
                                       c_warm=c_warm)
        cP = jnp.where(okk[:, :, 0], c[:, :, 0], 0.0)
        m, chi, L = jax.vmap(
            lambda cp, t, oc, u, m:
            misfit_from_c(cp, t, oc, u, m, valid=m))(
                cP, per_b, c_b, u_b, m_b)
        # cP of THIS evaluation seeds the next step's brackets (zeros
        # where the solve failed -> those lanes re-bracket cold)
        return m, chi, L, cP

    init_fn, seg_fn = make_segmented_sampler(
        isgood, chi_sqr_batch, cfg,
        aux_init=lambda spec_b, ctx_b: jnp.zeros_like(ctx_b[1]))

    # check_vma=False where sharded: the sampler's scan/while carries
    # start from unvarying literals (e.g. the secular recursion's e1
    # seed), which the varying-manual-axes checker rejects even though
    # the program is purely lane-parallel (no cross-device
    # communication inside).
    n_dev = mesh.devices.size
    # Shard the flat lane axis over EVERY mesh axis: a 1-D ("points",)
    # mesh and a 2-D mesh (mesh.py multislice_mesh) compile the
    # identical per-shard program — the sampler has no cross-lane
    # collectives, so devices never communicate in the hot loop.
    axes = tuple(mesh.axis_names)
    pp = P(axes)
    if n_dev > 1:
        init_all = jax.shard_map(
            init_fn, mesh=mesh, in_specs=(pp,) * 5,
            out_specs=pp, check_vma=False)
    else:
        init_all = init_fn
    init_all = jax.jit(init_all)

    seg_cache = {}

    def seg_all(n):
        if n not in seg_cache:
            f = (lambda carry, lk, sp, cx, s0, n=n:
                 seg_fn(carry, lk, sp, cx, s0, n))
            if n_dev > 1:
                f = jax.shard_map(
                    f, mesh=mesh,
                    in_specs=(pp, pp, pp, pp, P()),
                    out_specs=(pp, P(None, axes)),
                    check_vma=False)
            seg_cache[n] = jax.jit(f)
        return seg_cache[n]

    entry = (init_all, seg_all)
    _PROGRAM_CACHE[key] = entry
    while len(_PROGRAM_CACHE) > _PROGRAM_CACHE_MAX:
        _PROGRAM_CACHE.pop(next(iter(_PROGRAM_CACHE)))
    return entry


def invert_grid(points, lonlats, outdir="mcdata", runN=24000, chainL=800,
                seed=42, priori=False, wave="rayleigh", mesh=None,
                verbose=True, point_cls=None, sampler="batched",
                segment=100, retries=2, checkpoint=None, resume=False,
                max_lanes="auto", pids=None, _abort_after_segments=None,
                _lane_offset=0):
    """Run MCMC for many grid points as one sharded computation.

    Args:
      points:  list of Point objects sharing one model structure (their
               initMod YAML settings differ only in numeric values).
      lonlats: list of (lon, lat) used for output file names.
      outdir:  directory for the reference-format npz chain files.
      runN, chainL, seed, priori: as in Point.MCinvMP.
      mesh:    optional jax Mesh with a "points" axis; default = all
               local devices.
      point_cls: Point subclass whose ``_misfit_from_c`` defines the
               likelihood for every lane; default = type(points[0]),
               with a homogeneity check (a PointCascadia grid samples
               the band-split chi^2, reference point.py:336-366).
               Pass explicitly to silence the check for mixed grids.
      sampler: "batched" (default) runs all (point, chain) lanes
               time-major with one fused batched forward per step —
               the lane-grid solver on the GPU kernels — under
               ``shard_map`` over the "points" mesh axis; "legacy"
               keeps the per-point vmapped
               chain kernel under automatic sharding.
      segment: batched sampler only — run the chain in jitted segments
               of this many steps (None = one monolithic scan).  Every
               step's RNG draws are a pure function of (lane key,
               global step index), so segmented and monolithic runs
               are bitwise identical; segmentation enables the three
               features below and overlaps the host's row fetches
               with device compute.
      retries: on a transient device fault re-run from the last
               fetched segment this many times before giving up
               (0 = any fault raises at once).  The sampler is
               deterministic, so a retry continues the exact chain.
               Segments are dispatched up to
               ``PYSURFINV_PIPELINE`` (default 3) ahead of the host
               fetch, so row transfers overlap device compute.
      checkpoint: optional path; after each segment the carry and the
               rows so far are written there, and
      resume:  True resumes from ``checkpoint`` if it exists —
               mid-chain checkpoint/resume the reference lacks
               (its npz is results-level only, point.py:80-85).
      pids:    optional list of output file basenames (without ``.npz``)
               overriding the default ``lon_lat`` naming —
               ``Point.MCinvMP`` routes its single point through here
               with its own pid.
      max_lanes: batched sampler only.  "auto" (default) runs the whole
               grid as ONE program up to 8192 (point, chain) lanes —
               lanes are the device's parallelism — and tiles larger
               grids into 1024-lane programs.  An integer forces tiling
               at that lane count; None disables tiling entirely.  Lane
               PRNG keys are offset per tile so tiled and untiled runs
               are bitwise identical.

    Returns the list of written file paths.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    # Persistent compile cache: grid programs are large (fused kernels
    # x sampler); once one compile lands, every later run (and retry)
    # skips it.  No-op if the process already configured a cache.
    from pysurfinv_tpu.utils import configure_jit_cache
    configure_jit_cache()

    from pysurfinv_tpu.inversion.compiled import BrownianSpec, CompiledModel
    from pysurfinv_tpu.inversion.mcmc import ChainConfig, make_chain_kernel
    from pysurfinv_tpu.parallel.mesh import points_mesh

    if priori and outdir.split("_")[-1] != "priori":
        outdir = "_".join((outdir, "priori"))

    # ---- auto-tiling ---------------------------------------------------
    # Tile the point axis so each call stays under the lane cap.  Lane
    # PRNG keys derive from the *global* lane index (offset per tile),
    # so tiled and untiled runs produce bitwise-identical tracks.
    # "auto" runs one program up to AUTO_CEILING lanes and tiles larger
    # grids at FALLBACK_LANES (a plain cap, not yet re-laddered for the
    # H100's memory: ROADMAP §1 item 5).
    FALLBACK_LANES = 1024
    AUTO_CEILING = 8192
    nch = max(runN // chainL, 1)
    auto = max_lanes == "auto"
    lane_limit = AUTO_CEILING if auto else max_lanes

    def _tiled(per_lanes):
        per = max(1, per_lanes // nch)
        paths = []
        for i in range(0, len(points), per):
            ck = f"{checkpoint}.tile{i}" if checkpoint else None
            paths += invert_grid(
                points[i:i + per], lonlats[i:i + per], outdir=outdir,
                runN=runN, chainL=chainL, seed=seed, priori=priori,
                wave=wave, mesh=mesh, verbose=verbose,
                point_cls=point_cls, sampler=sampler, segment=segment,
                retries=retries, checkpoint=ck, resume=resume,
                max_lanes=None,
                pids=pids[i:i + per] if pids else None,
                _abort_after_segments=_abort_after_segments,
                _lane_offset=_lane_offset + i * nch)
        return paths

    if (sampler == "batched" and lane_limit and len(points) > 1
            and len(points) * nch > lane_limit):
        return _tiled(FALLBACK_LANES if auto else max_lanes)

    t0 = time.time()
    marks = []
    _mark = lambda name: marks.append((name, time.time()))  # noqa: E731
    lane_zc = None   # streaming chain compressor (batched sampler only)
    K = len(points)
    cm = CompiledModel(points[0].initMod)
    _mark("compile_model")

    # ---- point-class likelihood -----------------------------------------
    # The reference's per-point jobs always sample with the point's OWN
    # misfit (e.g. PointCascadia's band-split chi^2, point.py:336-366);
    # the sharded grid must too.  All points in one call share one
    # compiled program, so the class must be homogeneous.
    pcls = point_cls or type(points[0])
    bad = [type(p).__name__ for p in points if type(p) is not pcls]
    if bad and point_cls is None:
        raise ValueError(
            f"invert_grid requires a homogeneous point class per call "
            f"(got {pcls.__name__} and {sorted(set(bad))}); split the "
            f"grid by class, or pass point_cls explicitly to override")
    misfit_from_c = pcls._misfit_from_c

    # ---- per-point parameter stacks ------------------------------------
    from pysurfinv_tpu.utils import host_eager
    with host_eager():  # pure host walks: keep eager ops on the CPU
        specs = [cm.spec_of(p.initMod) for p in points]
        psi_np = np.stack([cm.psi_of(p.initMod) for p in points])
    spec = BrownianSpec(*[jnp.stack([getattr(s, f) for s in specs])
                          for f in BrownianSpec._fields])
    psi = jnp.asarray(psi_np)

    # ---- per-point observations (padded to the longest period list) ----
    Ts = [np.asarray(p.obs["T"], dtype=float) for p in points]
    P_max = max(len(t) for t in Ts)
    periods = np.zeros((K, P_max))
    obs_c = np.zeros((K, P_max))
    uncer = np.ones((K, P_max))
    obs_m = np.zeros((K, P_max), dtype=bool)
    for k, p in enumerate(points):
        n = len(Ts[k])
        periods[k, :n] = Ts[k]
        periods[k, n:] = Ts[k][-1]  # padded periods solve but are masked
        cO = np.ma.masked_array(np.asarray(p.obs["c"], dtype=float))
        mask = ~np.ma.getmaskarray(cO) & np.ones(n, bool)
        obs_c[k, :n] = np.where(mask, cO.filled(0.0), 0.0)
        uncer[k, :n] = np.asarray(p.obs["uncer"], dtype=float)
        obs_m[k, :n] = mask
    periods, obs_c, uncer, obs_m = map(jnp.asarray,
                                       (periods, obs_c, uncer, obs_m))

    _mark("per_point_specs")

    # ---- kernel ----------------------------------------------------------
    def isgood(theta, ctx):
        return cm.isgood(theta, ctx[0])

    def chi_sqr(theta, ctx):
        psi_k, per_k, c_k, u_k, m_k = ctx
        cP = cm.forward(theta, per_k, psi=psi_k, wave=wave)
        return misfit_from_c(cP, per_k, c_k, u_k, m_k, valid=m_k)

    cfg = ChainConfig(chain_len=chainL, priori=priori)
    n_chains = runN // chainL

    mesh = mesh or points_mesh()
    n_dev = mesh.devices.size
    shard = NamedSharding(mesh, P(tuple(mesh.axis_names)))

    ctx = (psi, periods, obs_c, uncer, obs_m)   # per point, unpadded
    put = lambda x: jax.device_put(x, shard)  # noqa: E731

    if sampler == "batched":
        init_all, seg_all = _batched_programs(cm, pcls, cfg, wave,
                                              mcmc_solver_cfg(), mesh)

        # lanes = (point, chain), point-major, sharded on the flat lane
        # axis.  Padding happens at LANE granularity: the lane count is
        # rounded up to the device count with replicas of the last lane
        # (discarded on output), so a single point's chains spread over
        # the whole mesh (MCinvMP on a pod = n_dev-way parallel) instead
        # of burning (n_dev-1)/n_dev of it on replicated points.
        # Per-lane keys are a pure function of the GLOBAL lane index,
        # so the tracks are bitwise independent of the mesh size and of
        # the padding while every shard holds >= 2 lanes; degenerate
        # 1-lane shards agree only to f64 rounding (XLA scalarizes the
        # size-1 lane dim and re-associates fp math) — see
        # tests/test_parallel_grid.py sharding-identity + single-point
        # tests.
        n_real = K * n_chains
        padL = (-n_real) % n_dev

        def lanes(x):
            r = jnp.repeat(x, n_chains, axis=0)
            if padL:
                r = jnp.concatenate([r, jnp.repeat(r[-1:], padL, axis=0)])
            return r

        ctx_l = jax.tree.map(lambda x: put(lanes(x)), ctx)
        spec_l = jax.tree.map(lambda x: put(lanes(x)), spec)
        theta0_l = spec_l.theta0
        ui = jnp.tile(jnp.arange(n_chains) == 0, K)
        if padL:
            ui = jnp.concatenate([ui, jnp.zeros((padL,), bool)])
        use_init = put(ui)
        key0 = jax.random.PRNGKey(seed)
        lane_keys = put(jax.vmap(lambda i: jax.random.fold_in(key0, i))(
            jnp.arange(n_real + padL) + _lane_offset))

        def _transient(e):
            """Runtime faults worth retrying: a ``JaxRuntimeError`` whose
            message starts with a retryable status word.  Anchoring to
            the message start lets deterministic failures that merely
            *mention* e.g. INTERNAL (compile errors) surface at once
            instead of burning retries."""
            from jax.errors import JaxRuntimeError
            return isinstance(e, JaxRuntimeError) and str(e).startswith(
                ("UNAVAILABLE", "DEADLINE_EXCEEDED", "ABORTED", "INTERNAL"))

        # Dispatch up to ``depth`` segments ahead of the host-side
        # fetch: jax dispatch is async, so converting segment j's rows
        # to numpy (a multi-MB transfer — the whole host cost of the
        # loop) overlaps with the device already running segment j+1.
        depth = (max(1, int(os.environ.get("PYSURFINV_PIPELINE", "3")))
                 if _abort_after_segments is None else 1)

        seg = (chainL if segment is None
               else min(max(int(segment), 1), chainL))

        with mesh:
            s = 0
            n_done = 0      # completed segments (testing hook)
            row_segs = []   # time-major segment rows (checkpoint payload)
            tracks_buf = None  # lane-major (N, chainL, w) output buffer
            n_lanes_tot = n_real + padL

            # Stream-compress committed rows while the device runs
            # later segments: the npz write is zlib-bound and strictly
            # serial on a 1-core host, but during the segment loop the
            # CPU idles in (GIL-released) fetches — so by the time the
            # last segment lands, the chain files are already deflated
            # and the write phase is pure assembly (utils.py
            # StreamingLaneCompressor).  PYSURFINV_STREAM_NPZ=0 opts
            # out (falls back to the end-of-run savez_fast pool).
            stream_npz = (os.environ.get("PYSURFINV_STREAM_NPZ", "1")
                          != "0")

            def _store(host_rows, s_after):
                """Transpose one fetched segment into the lane-major
                output buffer.  Doing it per segment keeps the copy
                inside the pipeline slack (the device is running the
                next segment) — one big end-of-run transpose measured
                ~18 s on a cold-page host vs ~1 s amortized here."""
                nonlocal tracks_buf, lane_zc
                if tracks_buf is None:
                    tracks_buf = np.empty(
                        (n_lanes_tot, chainL, host_rows.shape[-1]),
                        host_rows.dtype)
                    if stream_npz:
                        from pysurfinv_tpu.utils import (
                            StreamingLaneCompressor)
                        # padding lanes are never written: skip them
                        lane_zc = StreamingLaneCompressor(n_real)
                n0 = host_rows.shape[0]
                tracks_buf[:, s_after - n0:s_after] = np.moveaxis(
                    host_rows, 0, 1)
                if lane_zc is not None:
                    lane_zc.feed(tracks_buf, s_after - n0, s_after)

            carry = None
            ck_meta = {"fmt": 3, "seed": seed + _lane_offset,
                       "runN": runN, "chainL": chainL, "K": K,
                       "n_lanes": n_real + padL}
            if resume and checkpoint and os.path.exists(checkpoint):
                ck = np.load(checkpoint, allow_pickle=True)
                got = {k: int(ck[k]) for k in ck_meta if k in ck}
                if got != ck_meta:
                    raise ValueError(
                        f"checkpoint {checkpoint} was written by a "
                        f"different run configuration: saved {got}, "
                        f"current {ck_meta}; delete it or rerun with "
                        f"the original settings")
                s = int(ck["s"])
                n_carry = sum(1 for k in ck.files
                              if k.startswith("carry"))
                carry = tuple(jnp.asarray(ck[f"carry{i}"])
                              for i in range(n_carry))
                if s > 0:
                    ck_rows = np.asarray(ck["rows"])
                    row_segs = [ck_rows]
                    _store(ck_rows, s)
                if verbose:
                    print(f"invert_grid: resumed at step {s}")
            resumed = carry is not None
            if not resumed:
                # async dispatch — a failure surfaces at the first
                # pipeline fetch below, where retry lives.
                # init builds start thetas only; their evaluation is
                # row 0 of the first segment (no duplicated forward)
                carry = init_all(lane_keys, spec_l, ctx_l,
                                 theta0_l, use_init)
                _mark("dispatch_init")
            # ---- pipelined segment loop -------------------------------
            # Each fetched segment also materialises its (tiny) carry,
            # giving a per-segment host sync point; on a transient
            # device fault every in-flight segment is recomputed from
            # the last sync point — bitwise identical, since each
            # step's RNG is a pure function of (lane key, global step
            # index).  Segments always execute exactly ``seg`` steps
            # and a short tail's surplus rows are discarded: XLA fully
            # unrolls length-1 scans, which re-associates the step math
            # and breaks bitwise identity with the monolithic run.  The
            # surplus steps' RNG indices are distinct, so kept rows are
            # unaffected, and the over-advanced carry is never used.
            tries = 0
            # sync = None means "roll back by re-running init"; after a
            # resume the checkpoint carry is already host-side
            sync = ((s, jax.tree.map(np.asarray, carry)) if resumed
                    else None)
            pending = []  # (n_kept, s_after, rows_dev, carry_dev)
            seg_debug = os.environ.get("PYSURFINV_SEG_TIMES") == "1"
            while s < chainL or pending:
                try:
                    t_disp = time.time()
                    while s < chainL and len(pending) < depth:
                        n = min(seg, chainL - s)
                        carry, rows = seg_all(seg)(
                            carry, lane_keys, spec_l, ctx_l,
                            jnp.asarray(s, jnp.int32))
                        pending.append((n, s + n, rows, carry))
                        s += n
                    t_fetch = time.time()
                    n0, s_after, rows0, carry0 = pending[0]
                    host_rows = _fetch_rows(rows0)[:n0]
                    host_carry = jax.tree.map(np.asarray, carry0)
                    pending.pop(0)
                    if seg_debug:
                        t_now = time.time()
                        print(f"  seg->{s_after}: dispatch "
                              f"{t_fetch - t_disp:.2f}s fetch "
                              f"{t_now - t_fetch:.2f}s")
                except Exception as e:  # noqa: BLE001
                    if tries >= retries or not _transient(e):
                        if lane_zc is not None:
                            lane_zc.abort()  # stop the deflate worker
                        raise
                    tries += 1
                    back = sync[0] if sync else "init"
                    if verbose:
                        print(f"invert_grid: transient device fault "
                              f"({type(e).__name__}), retry "
                              f"{tries}/{retries} from step {back}")
                    time.sleep(10.0 * tries)
                    pending = []
                    if sync is None:
                        carry = init_all(lane_keys, spec_l, ctx_l,
                                         theta0_l, use_init)
                        s = 0
                    else:
                        s, hc = sync
                        carry = tuple(jnp.asarray(c) for c in hc)
                    continue
                tries = 0
                _store(host_rows, s_after)
                n_done += 1
                sync = (s_after, host_carry)
                if checkpoint:
                    row_segs.append(host_rows)
                    tmp = checkpoint + ".tmp.npz"
                    with open(tmp, "wb") as fh:
                        np.savez(fh, s=s_after,
                                 rows=np.concatenate(row_segs, axis=0),
                                 **ck_meta,
                                 **{f"carry{i}": c
                                    for i, c in enumerate(host_carry)})
                    os.replace(tmp, checkpoint)
                if (_abort_after_segments is not None
                        and n_done >= _abort_after_segments
                        and s_after < chainL):
                    # testing hook: simulate the process dying mid-run
                    if lane_zc is not None:
                        lane_zc.abort()
                    raise KeyboardInterrupt("aborted after "
                                            f"{n_done} segments")
        _mark("segments")
        # row 0 of the first segment is the init-evaluation row;
        # tracks_buf is already lane-major (point-major lanes), so this
        # reshape is a view
        tracks = tracks_buf[:n_real].reshape(K, n_chains, chainL, -1)
    else:
        kernel = make_chain_kernel(isgood, chi_sqr, cfg)

        def point_fn(key, spec_k, ctx_k):
            keys = jax.random.split(key, n_chains)
            use_init = jnp.arange(n_chains) == 0
            return jax.vmap(lambda kk, ui: kernel(kk, spec_k, ctx_k,
                                                  spec_k.theta0, ui))(
                keys, use_init)

        # this per-point vmap path shards whole points, so it pads the
        # POINT axis to the device count (replicas discarded below)
        pad = (-K) % n_dev

        def padk(x):
            if pad == 0:
                return x
            return jnp.concatenate([x, jnp.repeat(x[-1:], pad, axis=0)])

        keys = jax.random.split(jax.random.PRNGKey(seed), K + pad)
        ctx_p = jax.tree.map(lambda x: put(padk(x)), ctx)
        spec_pp = jax.tree.map(lambda x: put(padk(x)), spec)
        keys = put(keys)

        run_all = jax.jit(jax.vmap(point_fn))
        with mesh:
            tracks = run_all(keys, spec_pp, ctx_p)
            tracks.block_until_ready()
        tracks = np.asarray(tracks)[:K]  # (K, n_chains, chainL, 3+ntheta)

    # ---- write reference-format npz per point ---------------------------
    # zlib is the bottleneck of the write phase (measured 11 s serial
    # for 64 points x 24k samples) and this host has ONE core, so the
    # batched sampler deflates each lane's rows DURING the segment loop
    # (lane_zc, fed in _store while the CPU idles in device fetches);
    # here each point's entry is assembled by concatenating its lanes'
    # compressed chunks — no end-of-run recompression.  The fallback
    # (legacy sampler / PYSURFINV_STREAM_NPZ=0) compresses at write
    # time across a thread pool (zlib releases the GIL).
    from pysurfinv_tpu.utils import (DEFLATE_TERMINATOR, deflate_bytes,
                                     npy_bytes, npy_header_bytes,
                                     savez_fast,
                                     write_npz_precompressed)
    os.makedirs(outdir, exist_ok=True)

    if lane_zc is not None:
        import zlib
        lane_zc.close()
        w_row = tracks_buf.shape[-1]
        hdr = npy_header_bytes((runN, w_row), tracks_buf.dtype)
        hobj = zlib.compressobj(1, zlib.DEFLATED, -15)
        hparts = [hobj.compress(hdr) + hobj.flush(zlib.Z_FULL_FLUSH)]
        raw_size = len(hdr) + n_chains * chainL * w_row * \
            tracks_buf.itemsize

    def _write(k_lonlat):
        k, (lon, lat) = k_lonlat
        pid = pids[k] if pids else f"{lon:g}_{lat:g}"
        path = f"{outdir}/{pid}.npz"
        meta = dict(setting=dict(points[k].initMod.toYML()),
                    obs=points[k].obs,
                    invMeta={"pid": pid, "chainL": chainL})
        if lane_zc is not None:
            lo = k * n_chains
            crc = zlib.crc32(hdr)
            for lane in range(lo, lo + n_chains):
                crc = zlib.crc32(tracks_buf[lane], crc)
            entries = [("mcTrack", raw_size, crc,
                        hparts + lane_zc.lane_chunks(lo, lo + n_chains)
                        + [DEFLATE_TERMINATOR])]
            for name, val in meta.items():
                b = npy_bytes(val)
                c, parts = deflate_bytes(b)
                entries.append((name, len(b), c, parts))
            write_npz_precompressed(path, entries)
        else:
            savez_fast(path, mcTrack=tracks[k].reshape(runN, -1), **meta)
        return path

    from pysurfinv_tpu.utils import host_eager
    with host_eager():  # toYML walks layers eagerly: keep it on the CPU
        if len(lonlats) > 4:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(max_workers=8) as pool:
                paths = list(pool.map(_write, enumerate(lonlats)))
        else:
            paths = [_write(kl) for kl in enumerate(lonlats)]
    if verbose:
        _mark("write_npz")
        prev = t0
        parts = []
        for name, t in marks:
            parts.append(f"{name} {t - prev:.1f}")
            prev = t
        print(f"invert_grid: {K} points x {n_chains} chains x {chainL} "
              f"steps in {time.time() - t0:.1f}s on {n_dev} device(s) "
              f"[{', '.join(parts)}]")
    return paths
