"""Sharded grid inversion -> reference npz -> Model3D assembly.

Exercises the sharded replacement for "one OS job per grid point"
(SURVEY.md §2.2): 4 grid points with different localInfo, sharded over
the 8-device virtual CPU mesh, then the full 3-D product chain.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.slow  # heavy tier; excluded by -m "not slow"

from tests.test_compiled_mcmc import LOCAL, PERIODS, SETTING, UNCERS, VELS  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _no_persistent_cache_writes():
    """Skip persistent-cache WRITES of this module's large sharded programs.

    Only relevant when PYSURFINV_TEST_JIT_CACHE opts back into the
    persistent cache (see tests/conftest.py for the jaxlib 0.9.0
    XLA:CPU (de)serialization segfault this guards against):
    ``LoadedExecutable.serialize()`` of the big segment executables is
    the write-path face of that bug, so never persist them.
    """
    import jax
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1e9)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def _mk_points():
    from pysurfinv_tpu.inversion.point import PointCascadia
    pts, lls = [], []
    for lon, lat, sed in [(229.0, 46.0, 0.019), (229.5, 46.0, 0.25),
                          (229.0, 46.5, 0.5), (229.5, 46.5, 1.0)]:
        local = dict(LOCAL)
        local["sedthk"] = sed
        pts.append(PointCascadia(SETTING, local, periods=PERIODS, vels=VELS,
                                 uncers=UNCERS))
        lls.append((lon, lat))
    return pts, lls


@pytest.fixture(scope="module")
def invdir(tmp_path_factory):
    import jax
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    assert len(jax.devices()) == 8  # conftest virtual mesh
    outdir = str(tmp_path_factory.mktemp("grid") / "mcdata")
    pts, lls = _mk_points()
    paths = invert_grid(pts, lls, outdir=outdir, runN=24, chainL=8, seed=3,
                        mesh=points_mesh(4), verbose=False)
    assert len(paths) == 4
    return outdir


def test_chain_files_are_reference_format(invdir):
    from pysurfinv_tpu.inversion.point import PostPoint
    pp = PostPoint(f"{invdir}/229_46.npz")
    assert pp.N == 24
    assert np.isfinite(pp.misfits).all()
    assert np.isfinite(pp.minMod.misfit)


def test_sharding_does_not_change_results(invdir, tmp_path):
    """The same program on a 1-device mesh gives bit-identical tracks.

    Per-lane PRNG keys are a pure function of the global lane index
    (parallel/grid.py), so mesh size must not leak into the physics —
    the reference's per-point OS jobs have the same property.
    """
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    outdir1 = str(tmp_path / "mc1")
    pts, lls = _mk_points()
    invert_grid(pts, lls, outdir=outdir1, runN=24, chainL=8, seed=3,
                mesh=points_mesh(1), verbose=False)
    for lon, lat in lls:
        pid = f"{lon:g}_{lat:g}"
        a = np.load(f"{invdir}/{pid}.npz", allow_pickle=True)["mcTrack"]
        b = np.load(f"{outdir1}/{pid}.npz", allow_pickle=True)["mcTrack"]
        np.testing.assert_array_equal(a, b)


def test_multislice_mesh_identical(invdir, tmp_path):
    """A 2-D ("dcn", "points") mesh gives bitwise-identical tracks to
    the flat 1-D mesh.

    The sampler shards its lane axis over EVERY mesh axis and has no
    cross-lane collectives, so devices never communicate in the hot
    loop; validated on a virtual 2x4 mesh.
    """
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import multislice_mesh

    outdir2 = str(tmp_path / "mc_dcn")
    pts, lls = _mk_points()
    invert_grid(pts, lls, outdir=outdir2, runN=24, chainL=8, seed=3,
                mesh=multislice_mesh(2, 4), verbose=False)
    for lon, lat in lls:
        pid = f"{lon:g}_{lat:g}"
        a = np.load(f"{invdir}/{pid}.npz", allow_pickle=True)["mcTrack"]
        b = np.load(f"{outdir2}/{pid}.npz", allow_pickle=True)["mcTrack"]
        np.testing.assert_array_equal(a, b)


def test_single_point_shards_across_mesh(tmp_path):
    """ONE point's chains spread over the whole mesh.

    Lanes are padded at lane (chain) granularity, not point
    granularity, so MCinvMP-style single-point runs use every device
    instead of replicating the point n_dev times.  Per-lane keys derive
    from the global lane index, so the track is bitwise independent of
    the mesh size as long as every shard holds >= 2 lanes; with
    degenerate 1-lane shards XLA scalarizes the size-1 lane dim and
    re-associates the fp math, so agreement there is at f64 rounding
    (measured ~3e-12 relative), not bitwise.
    """
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    pts, lls = _mk_points()
    tracks = {}
    for nd in (1, 2, 4, 8):   # 8 chains -> 8, 4, 2, 1 lanes per shard
        outdir = str(tmp_path / f"mc_sp{nd}")
        invert_grid(pts[:1], lls[:1], outdir=outdir, runN=64, chainL=8,
                    seed=3, mesh=points_mesh(nd), verbose=False)
        tracks[nd] = np.load(f"{outdir}/229_46.npz",
                             allow_pickle=True)["mcTrack"]
    np.testing.assert_array_equal(tracks[1], tracks[2])
    np.testing.assert_array_equal(tracks[1], tracks[4])
    np.testing.assert_allclose(tracks[8], tracks[1], rtol=1e-9)


def test_streamed_npz_matches_savez(invdir, tmp_path, monkeypatch):
    """The streaming lane compressor writes np.load-identical npz files.

    The default batched path deflates each lane's rows during the
    segment loop and assembles the zip by hand
    (utils.write_npz_precompressed); PYSURFINV_STREAM_NPZ=0 recompresses
    everything at write time through zipfile/savez_fast.  Entry values,
    dtypes, and zip CRCs must agree exactly.
    """
    import zipfile
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    monkeypatch.setenv("PYSURFINV_STREAM_NPZ", "0")
    outdir0 = str(tmp_path / "mc_plain")
    pts, lls = _mk_points()
    invert_grid(pts, lls, outdir=outdir0, runN=24, chainL=8, seed=3,
                mesh=points_mesh(4), verbose=False)
    for lon, lat in lls:
        pid = f"{lon:g}_{lat:g}"
        a = np.load(f"{invdir}/{pid}.npz", allow_pickle=True)  # streamed
        b = np.load(f"{outdir0}/{pid}.npz", allow_pickle=True)
        assert sorted(a.files) == sorted(b.files)
        assert a["mcTrack"].dtype == b["mcTrack"].dtype
        np.testing.assert_array_equal(a["mcTrack"], b["mcTrack"])
        for key in ("setting", "obs", "invMeta"):
            assert repr(a[key][()]) == repr(b[key][()])
        with zipfile.ZipFile(f"{invdir}/{pid}.npz") as zf:
            assert zf.testzip() is None  # hand-built container + CRCs


def test_segmented_resume_matches_monolithic(invdir, tmp_path):
    """Segmented execution + mid-chain checkpoint/resume are bitwise
    identical to the monolithic scan.

    Every step's RNG draws are a pure function of (lane key, global
    step index) — see make_segmented_sampler — so splitting the chain
    into jitted segments, or killing it mid-run and resuming from the
    checkpoint, must reproduce the exact same track.
    """
    import os
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    pts, lls = _mk_points()

    # segmented, with a checkpoint file
    out_seg = str(tmp_path / "mc_seg")
    ck = str(tmp_path / "ck.npz")
    invert_grid(pts, lls, outdir=out_seg, runN=24, chainL=8, seed=3,
                mesh=points_mesh(4), verbose=False, segment=3,
                checkpoint=ck)
    assert os.path.exists(ck)

    # a run killed mid-chain (after the first 3-step segment) ...
    out_res = str(tmp_path / "mc_res")
    ck2 = str(tmp_path / "ck2.npz")
    with pytest.raises(KeyboardInterrupt):
        invert_grid(pts, lls, outdir=out_res, runN=24, chainL=8, seed=3,
                    mesh=points_mesh(4), verbose=False, segment=3,
                    checkpoint=ck2, _abort_after_segments=1)
    assert int(np.load(ck2)["s"]) == 3
    # ... resumes from its checkpoint and completes the tail only
    invert_grid(pts, lls, outdir=out_res, runN=24, chainL=8, seed=3,
                mesh=points_mesh(4), verbose=False, segment=3,
                checkpoint=ck2, resume=True)

    for lon, lat in lls:
        pid = f"{lon:g}_{lat:g}"
        a = np.load(f"{invdir}/{pid}.npz", allow_pickle=True)["mcTrack"]
        b = np.load(f"{out_seg}/{pid}.npz", allow_pickle=True)["mcTrack"]
        c = np.load(f"{out_res}/{pid}.npz", allow_pickle=True)["mcTrack"]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_auto_tiling_matches_untiled(invdir, tmp_path):
    """max_lanes tiling is bitwise identical to the single program.

    Lane PRNG keys are offset by each tile's global start lane, so
    splitting the point axis cannot change any chain (the discarded
    per-tile pad lanes are the only difference).
    """
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    pts, lls = _mk_points()
    out_t = str(tmp_path / "mc_tiled")
    # 4 points x 3 chains = 12 lanes; max_lanes=6 forces 2 tiles
    invert_grid(pts, lls, outdir=out_t, runN=24, chainL=8, seed=3,
                mesh=points_mesh(1), verbose=False, max_lanes=6)
    for lon, lat in lls:
        pid = f"{lon:g}_{lat:g}"
        a = np.load(f"{invdir}/{pid}.npz", allow_pickle=True)["mcTrack"]
        b = np.load(f"{out_t}/{pid}.npz", allow_pickle=True)["mcTrack"]
        np.testing.assert_array_equal(a, b)


def test_point_class_misfit_reaches_sampler(invdir):
    """invert_grid samples with the point class's OWN likelihood.

    A grid of PointCascadia points must record the band-split chi^2
    (reference point.py:336-366) in the misfit column — recomputing
    PointCascadia.misfit on host for every proposed theta must match,
    and must differ from the plain Point chi^2 the round-1 code
    hardcoded.
    """
    import jax
    import jax.numpy as jnp
    from pysurfinv_tpu.inversion.compiled import CompiledModel
    from pysurfinv_tpu.inversion.point import Point, PointCascadia
    from pysurfinv_tpu.parallel.grid import mcmc_solver_cfg

    pts, _ = _mk_points()
    p = pts[0]
    cm = CompiledModel(p.initMod)
    tr = np.load(f"{invdir}/229_46.npz", allow_pickle=True)["mcTrack"]
    dev = tr[:, 0]

    # recompute with the sampler's own solver config (mcmc_solver_cfg):
    # the default SurfConfig refines brackets with one more Illinois
    # iteration, which moves roots at the ~1e-6 km/s refinement floor
    periods = jnp.asarray(np.array(PERIODS, float))
    cPs = jax.jit(jax.vmap(lambda th: cm.forward(
        th, periods, cfg=mcmc_solver_cfg())))(jnp.asarray(tr[:, 3:]))
    T, obs_c, uncer, obs_m = p._obs_arrays()
    casc = np.asarray(jax.vmap(
        lambda cp: PointCascadia._misfit_from_c(cp, T, obs_c, uncer,
                                                obs_m)[0])(cPs))
    plain = np.asarray(jax.vmap(
        lambda cp: Point._misfit_from_c(cp, T, obs_c, uncer,
                                        obs_m)[0])(cPs))
    ok = dev < 80000
    assert ok.sum() >= len(tr) // 2
    np.testing.assert_allclose(dev[ok], casc[ok], rtol=1e-6, atol=1e-6)
    # sanity: the two likelihoods genuinely disagree on this chain, so
    # the match above proves the band-split one reached the sampler
    assert np.abs(casc[ok] - plain[ok]).max() > 1e-3


def test_mixed_point_classes_rejected(tmp_path):
    from pysurfinv_tpu.inversion.point import Point
    from pysurfinv_tpu.parallel.grid import invert_grid

    pts, lls = _mk_points()
    pts[1] = Point(SETTING, dict(LOCAL, sedthk=0.25), periods=PERIODS,
                   vels=VELS, uncers=UNCERS)
    with pytest.raises(ValueError, match="homogeneous point class"):
        invert_grid(pts, lls, outdir=str(tmp_path / "mc"), runN=8,
                    chainL=4, verbose=False)


def test_chainL1_degenerate(tmp_path):
    """chainL=1 chains have zero Metropolis steps; the track is the
    init rows alone (advisor r1: np.concatenate([]) crash)."""
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    pts, lls = _mk_points()
    out = str(tmp_path / "mc1step")
    invert_grid(pts[:1], lls[:1], outdir=out, runN=2, chainL=1, seed=3,
                mesh=points_mesh(1), verbose=False)
    tr = np.load(f"{out}/229_46.npz", allow_pickle=True)["mcTrack"]
    assert tr.shape[0] == 2
    assert np.isfinite(tr).all()


def test_parallel_fetch_streams_identical(invdir, tmp_path, monkeypatch):
    """PYSURFINV_FETCH_STREAMS chunked segment fetches are byte-identical.

    The chunked path slices the lane axis and must never change the
    written tracks.
    """
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    monkeypatch.setenv("PYSURFINV_FETCH_STREAMS", "4")
    outdir1 = str(tmp_path / "mcf4")
    pts, lls = _mk_points()
    invert_grid(pts, lls, outdir=outdir1, runN=24, chainL=8, seed=3,
                mesh=points_mesh(4), verbose=False)
    for lon, lat in lls:
        pid = f"{lon:g}_{lat:g}"
        a = np.load(f"{invdir}/{pid}.npz", allow_pickle=True)["mcTrack"]
        b = np.load(f"{outdir1}/{pid}.npz", allow_pickle=True)["mcTrack"]
        np.testing.assert_array_equal(a, b)


def test_checkpoint_config_mismatch(tmp_path):
    """Resuming a checkpoint from a different run configuration raises
    instead of silently producing corrupted tracks (advisor r1)."""
    from pysurfinv_tpu.parallel.grid import invert_grid
    from pysurfinv_tpu.parallel.mesh import points_mesh

    pts, lls = _mk_points()
    ck = str(tmp_path / "ck.npz")
    invert_grid(pts, lls, outdir=str(tmp_path / "a"), runN=24, chainL=8,
                seed=3, mesh=points_mesh(1), verbose=False, segment=3,
                checkpoint=ck)
    with pytest.raises(ValueError, match="different run configuration"):
        invert_grid(pts, lls, outdir=str(tmp_path / "b"), runN=24,
                    chainL=8, seed=4, mesh=points_mesh(1), verbose=False,
                    segment=3, checkpoint=ck, resume=True)


def test_model3d_pipeline(invdir):
    from pysurfinv_tpu.geo.model3d import Model3D
    m3 = Model3D()
    m3.loadInvDir(invdir)
    assert (~m3.mask).sum() == 4

    vs50_map = m3.genVsMap(50.0)
    assert np.isfinite(vs50_map.zMasked).sum() >= 4

    # profile + section through the grid
    prof = m3.vsProfile(np.array([10.0, 50.0, 150.0]), 46.25, 229.25)
    assert np.isfinite(prof).all()
    XX, YY, Z, moho, topo = m3.section(229.0, 46.0, 229.5, 46.5,
                                       y=np.linspace(0, 180, 19))
    assert Z.shape == (19, 301)
    assert np.isfinite(Z).any()

    # physical-grid smoothing (GMT surface replacement, on device)
    m3.smoothGrid(width=60, nGridsDict={"water": 2, "sediment": 4,
                                        "crust": 8, "mantle": 24})
    vs50b = m3.genVsMap(50.0)
    assert np.isfinite(vs50b.zMasked).sum() >= 4

    qc = m3.checkPhaseVelocity(pers=[10, 50])
    assert set(qc.keys()) == {10, 50}

    # full-feature section plot (round-2: restored depth-tick relabel,
    # zoom separator, endpoint labels, decorateFuns hook, trueAspect,
    # two colorbars — reference model3D.py:340-371)
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    hook_calls = []
    imC, imM = m3.plotSection(
        229.0, 46.0, 229.5, 46.5, label=("A", "A'"), trueAspect=True,
        decorateFuns=[lambda *a: hook_calls.append(a)])
    ax = imC.axes
    assert hook_calls == [(229.0, 46.0, 229.5, 46.5)]
    assert len(ax.figure.axes) >= 3  # main + crust + mantle colorbars
    ylabels = [t.get_text() for t in ax.get_yticklabels()]
    assert "15" in ylabels and "200" in ylabels  # true-depth relabel
    texts = [t.get_text() for t in ax.texts]
    assert "A" in texts and "A'" in texts
    plt.close("all")


@pytest.mark.slow
def test_dryrun_16_device_mesh():
    """16-device virtual mesh beyond the session's 8-device backend.

    Runs the driver's multichip dryrun in its own subprocess (it forces
    a fresh 16-device CPU backend), which since round 3 also asserts
    cross-mesh identity of the chain behaviour (bitwise accept/theta
    columns; misfit/L within the f32 batch-shape codegen envelope — see
    the dryrun docstring) on an uneven point count — so this exercises
    2x the usual virtual mesh width end to end.
    """
    import __graft_entry__ as g
    g.dryrun_multichip(16)
