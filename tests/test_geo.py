"""Geo layer: grids, smoothing, exchange containers, great circles."""

import numpy as np

from pysurfinv_tpu.geo.exchange import Model1D_Exchange, Model3D_Exchange
from pysurfinv_tpu.geo.grid import (GeoMap, gaussian_smooth_nan, gc_direct,
                                    gc_inverse, mapSmooth)


def test_gc_roundtrip():
    geo = gc_inverse(46.0, -131.0, 43.8, -125.0)
    assert 400e3 < geo["s12"] < 600e3
    end = gc_direct(46.0, -131.0, geo["azi1"], geo["s12"])
    assert abs(end["lat2"] - 43.8) < 1e-6
    assert abs(end["lon2"] - (-125.0)) < 1e-6


def test_smoothing_preserves_constants_and_nans():
    lons = np.arange(228, 232.1, 0.5)
    lats = np.arange(44, 47.1, 0.5)
    z = np.full((len(lats), len(lons)), 3.5)
    z[2, 3] = np.nan
    out = mapSmooth(lons, lats, z, width=50)
    assert np.isnan(out[2, 3])
    good = ~np.isnan(out)
    assert np.allclose(out[good], 3.5, atol=1e-6)


def test_smoothing_reduces_noise():
    rng = np.random.default_rng(0)
    lons = np.arange(0, 10.1, 0.5)
    lats = np.arange(0, 10.1, 0.5)
    z = 4.0 + 0.1 * rng.standard_normal((len(lats), len(lons)))
    out = gaussian_smooth_nan(lons, lats, z[None], 200.0)[0]
    assert np.nanstd(out) < 0.5 * np.nanstd(z)


def test_geomap_bilinear_value():
    lons, lats = np.array([0.0, 1.0]), np.array([0.0, 1.0])
    z = np.array([[0.0, 1.0], [2.0, 3.0]])
    gm = GeoMap(lons, lats, z)
    assert abs(gm.value(0.5, 0.5) - 1.5) < 1e-12
    assert abs(gm.value(1.0, 0.0) - 1.0) < 1e-12


def test_exchange_roundtrip(tmp_path):
    m3 = Model3D_Exchange(lons=[0, 1], lats=[0, 1])
    z = np.linspace(0, 100, 11)
    for lon in (0, 1):
        for lat in (0, 1):
            vs = 3.0 + 0.01 * z + 0.1 * lon + 0.2 * lat
            m3.addMod(lon, lat, Model1D_Exchange({"z": z, "vs": vs}))
    mid = m3.getMod(0.5, 0.5, "vs", zdeps=z)
    expect = 3.0 + 0.01 * z + 0.1 * 0.5 + 0.2 * 0.5
    assert np.allclose(mid.parm["vs"], expect, atol=1e-9)

    f = str(tmp_path / "m3.npz")
    m3.save(f)
    m3b = Model3D_Exchange(fname=f)
    v = m3b.getMap(50.0, "vs")
    assert np.isfinite(v.z).all()

    # layer-type container round trip
    m1 = Model1D_Exchange({"h": np.array([1.0, 2.0]),
                           "vs": np.array([3.0, 4.0])})
    zg, vg = m1.propGrids("vs")
    assert zg.tolist() == [0, 1, 1, 3]
    hh, vv = m1.propLayers("vs")
    assert np.allclose(hh, [1, 2]) and np.allclose(vv, [3, 4])


def test_tension_smoothing_parity():
    """Quantified parity between the Gaussian smoother and the GMT
    `surface`-style spline-in-tension filter.

    Both are tuned to the same half-power wavelength, so on a
    band-limited field they must agree closely; the measured max
    deviation on this fixture (documented bound below) is ~2% of the
    field's dynamic range at tension ~ 0.  Tension's defining property
    — suppressing biharmonic-spline overshoot around sharp steps — is
    asserted directly.
    """
    from pysurfinv_tpu.geo.grid import tension_spline_smooth

    rng = np.random.default_rng(3)
    lons = np.arange(0.0, 12.01, 0.25)
    lats = np.arange(40.0, 48.01, 0.25)
    LO, LA = np.meshgrid(lons, lats)
    base = 4.0 + 0.3 * np.sin(2 * np.pi * LO / 8.0) * np.cos(
        2 * np.pi * LA / 6.0)
    z = base + 0.05 * rng.standard_normal(base.shape)
    z[5:8, 10:14] = np.nan  # a data hole

    width = 150.0
    g = gaussian_smooth_nan(lons, lats, z[None], width)[0]
    t0 = tension_spline_smooth(lons, lats, z[None], width, 0.01)[0]
    t9 = tension_spline_smooth(lons, lats, z[None], width, 0.9)[0]

    good = np.isfinite(z)
    assert (np.isnan(t0) == ~good).all()  # NaNs restored
    rng_z = np.nanmax(z) - np.nanmin(z)
    # same half-power point -> close agreement on a smooth field.
    # Measured on this fixture (2026-08): interior max deviation
    # |gauss - tension(0.01)| / range = 0.017; grid-edge max = 0.056
    # (the smoothers impose different boundary conditions: replicate-
    # pad convolution vs the DCT's Neumann edge).
    dev = np.abs(g - t0) / rng_z
    assert np.nanmax(dev) < 0.08, np.nanmax(dev)
    interior = np.full(z.shape, np.nan)
    interior[4:-4, 4:-4] = dev[4:-4, 4:-4]
    assert np.nanmax(interior) < 0.03, np.nanmax(interior)
    # both remove comparable noise power
    assert np.nanstd(z - t0) < 2.0 * np.nanstd(z - g) + 1e-12

    # constant preservation (H(0) = 1) with holes
    zc = np.full_like(z, 3.5)
    zc[3, 3] = np.nan
    tc = tension_spline_smooth(lons, lats, zc[None], width, 0.5)[0]
    assert np.allclose(tc[np.isfinite(tc)], 3.5, atol=1e-6)

    # tension suppresses spline overshoot around a step
    step = np.where(LO < 6.0, 4.0, 4.5)
    s0 = tension_spline_smooth(lons, lats, step[None], width, 0.01)[0]
    s9 = tension_spline_smooth(lons, lats, step[None], width, 0.9)[0]
    over0 = max(np.nanmax(s0) - 4.5, 4.0 - np.nanmin(s0))
    over9 = max(np.nanmax(s9) - 4.5, 4.0 - np.nanmin(s9))
    assert over9 < over0, (over0, over9)
