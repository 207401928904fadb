"""Geographic grids, maps, smoothing, and great-circle sampling.

Replaces the reference's external ``Triforce.utils.GeoGrid/GeoMap``
dependency (used throughout model3D.py) and the GMT ``surface``
subprocess smoothing (``model3D.py:11-14``) with:

  * a minimal GeoGrid/GeoMap pair with the same access patterns
    (``_findInd``, ``_findInd_linear_interp``, ``XX/YY``, ``zMasked``);
  * NaN-aware Gaussian smoothing as a *batched convolution on device* —
    the on-device equivalent of shelling out to GMT per field: all
    (property, depth-node) maps smooth in one XLA call;
  * spherical great-circle interpolation replacing geographiclib
    geodesics for cross-sections (WGS84 vs sphere differs by < 0.5 %
    in path length — visualization-grade, documented).
"""

from __future__ import annotations

import numpy as np

EARTH_R_KM = 6371.0
DEG2KM = np.pi / 180.0 * EARTH_R_KM


class GeoGrid:
    def __init__(self, lons=(), lats=()):
        self.lons = np.asarray(lons, dtype=float)
        self.lats = np.asarray(lats, dtype=float)

    @property
    def XX(self):
        return np.meshgrid(self.lons, self.lats)[0]

    @property
    def YY(self):
        return np.meshgrid(self.lons, self.lats)[1]

    def _findInd(self, lon, lat):
        """(ilat, ilon) of the nearest grid node."""
        i = int(np.argmin(np.abs(self.lats - lat)))
        j = int(np.argmin(np.abs(self.lons - lon)))
        return i, j

    def _findInd_linear_interp(self, lon, lat):
        """Bilinear stencil (i, j, dx, dy, Dx, Dy) or exact (i, j)."""
        lon = lon + 360 * (lon < 0)
        if (lon - self.lons[0]) * (lon - self.lons[-1]) > 0:
            return None
        if (lat - self.lats[0]) * (lat - self.lats[-1]) > 0:
            return None
        j = int(np.where(self.lons - lon >= 0)[0][0])
        i = int(np.where(self.lats - lat >= 0)[0][0])
        if self.lons[j] == lon and self.lats[i] == lat:
            return i, j
        Dx = self.lons[j] - self.lons[j - 1]
        Dy = self.lats[i] - self.lats[i - 1]
        dx = lon - self.lons[j - 1]
        dy = lat - self.lats[i - 1]
        return i, j, dx, dy, Dx, Dy

    def copy(self):
        from copy import deepcopy
        return deepcopy(self)


class GeoMap(GeoGrid):
    def __init__(self, lons=(), lats=(), z=None, mask=None):
        super().__init__(lons, lats)
        self.z = np.asarray(z, dtype=float) if z is not None else None
        self.mask = (np.asarray(mask, dtype=bool) if mask is not None
                     else (np.isnan(self.z) if self.z is not None else None))

    @property
    def zMasked(self):
        return np.ma.masked_array(self.z, mask=self.mask
                                  | np.isnan(self.z))

    def value(self, lon, lat):
        ind = self._findInd_linear_interp(lon, lat)
        if ind is None:
            return np.nan
        if len(ind) == 2:
            return self.z[ind]
        i, j, dx, dy, Dx, Dy = ind
        p0, p1 = self.z[i - 1, j - 1], self.z[i, j - 1]
        p2, p3 = self.z[i - 1, j], self.z[i, j]
        return (p0 + (p1 - p0) * dy / Dy + (p2 - p0) * dx / Dx
                + (p0 + p3 - p1 - p2) * dx * dy / Dx / Dy)

    def smooth(self, tension=0.0, width=50.0):
        """NaN-aware smoothing with half-width ``width`` km.

        ``tension=0`` (the reference's default) uses the separable
        Gaussian; ``tension>0`` uses the spline-in-tension spectral
        filter (:func:`tension_spline_smooth`), the GMT ``surface``
        analogue — both share the same half-power wavelength, and their
        tension->0 deviation is quantified in
        ``tests/test_geo.py::test_tension_smoothing_parity``.
        """
        if tension > 0:
            zNew = tension_spline_smooth(self.lons, self.lats,
                                         self.z[None], width, tension)[0]
        else:
            zNew = gaussian_smooth_nan(self.lons, self.lats, self.z[None],
                                       width)[0]
        return GeoMap(self.lons, self.lats, zNew)

    def _lon_range_change_to(self, rng):
        if rng == "-180 to 180":
            self.lons = self.lons - 360 * (self.lons > 180)
        else:
            self.lons = self.lons + 360 * (self.lons < 0)


def _gauss_kernel(dx_km, width_km, nsig=3.0):
    sigma = max(width_km / 2.0, 1e-6)  # width = full width at ~1 sigma each side
    n = max(int(np.ceil(nsig * sigma / dx_km)), 1)
    x = np.arange(-n, n + 1) * dx_km
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _gaussian_smooth_core(lons, lats, fields, width_km):
    """Normalized-convolution Gaussian smooth; values EVERYWHERE (no
    NaN restore) — NaN cells get their Gaussian-weighted neighborhood
    mean, which is also how the tension filter infills."""
    import jax
    import jax.numpy as jnp

    fields = np.asarray(fields, dtype=float)
    dlat_km = abs(lats[1] - lats[0]) * DEG2KM
    dlon_km = (abs(lons[1] - lons[0]) * DEG2KM
               * np.cos(np.deg2rad(np.mean(lats))))
    k_lat = jnp.asarray(_gauss_kernel(dlat_km, width_km))
    k_lon = jnp.asarray(_gauss_kernel(dlon_km, width_km))

    z = jnp.asarray(fields)
    good = jnp.isfinite(z)
    z0 = jnp.where(good, z, 0.0)
    w0 = good.astype(z0.dtype)

    def conv1(x, k, axis):
        x = jnp.moveaxis(x, axis, -1)
        pad = (k.shape[0] - 1) // 2
        xp = jnp.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad, pad)], mode="edge")
        shape = xp.shape
        xp2 = xp.reshape(-1, 1, shape[-1])
        out = jax.lax.conv_general_dilated(
            xp2, k[None, None, :], window_strides=(1,), padding="VALID")
        out = out.reshape(*shape[:-1], -1)
        return jnp.moveaxis(out, -1, axis)

    num = conv1(conv1(z0 * w0, k_lat, 1), k_lon, 2)
    den = conv1(conv1(w0, k_lat, 1), k_lon, 2)
    return np.array(num / jnp.maximum(den, 1e-12))


def gaussian_smooth_nan(lons, lats, fields, width_km):
    """Batched NaN-aware separable Gaussian smoothing on device.

    Args:
      lons, lats: 1-D grid coordinates (degrees).
      fields: (B, nlat, nlon) stack of maps (NaN = missing).
      width_km: smoothing width in km (like GeoMap.smooth(width=...)).

    Returns (B, nlat, nlon) with NaNs restored where inputs were NaN.
    Normalized convolution handles missing data; the lon kernel uses the
    metric at the mean latitude (adequate for regional grids).
    """
    fields = np.asarray(fields, dtype=float)
    sm = _gaussian_smooth_core(lons, lats, fields, width_km)
    sm[~np.isfinite(fields)] = np.nan
    return sm


def tension_spline_smooth(lons, lats, fields, width_km, tension=0.25):
    """Spline-in-tension low-pass smoothing — the GMT ``surface`` family.

    GMT's ``surface`` grids data by solving the spline-in-tension PDE
    ``(1-T) L(L z) - T L z = 0`` (Smith & Wessel, Geophysics 1990,
    ``-T`` flag).  The smoothing analogue on an already-complete grid is
    Tikhonov regularisation with the same operator,

        min  ||z - z0||^2 + lam [ (1-T) ||Lap z||^2 + T ||grad z||^2 ]

    whose normal equations diagonalise in the DCT-II basis (Neumann
    boundaries, matching ``surface``'s natural-spline edges):

        H(k) = 1 / (1 + lam ((1-T) |k|^4 + T |k|^2)).

    ``lam`` is chosen so the half-power wavenumber equals the Gaussian
    smoother's (sigma = width/2 -> k_c = sqrt(2 ln 2) / sigma), so the
    two smoothers are directly comparable at any tension; their
    measured deviation is documented in
    ``tests/test_geo.py::test_tension_smoothing_parity``.  T -> 1
    weakens the k^4 (biharmonic) term toward a harmonic membrane,
    which is exactly GMT's "suppress spline overshoot" control.

    NaNs are infilled by normalized Gaussian convolution before the
    spectral filter and restored afterwards.

    Args/returns as :func:`gaussian_smooth_nan`, plus ``tension`` in
    [0, 1).
    """
    import jax.numpy as jnp
    from jax.scipy.fft import dctn, idctn

    fields = np.asarray(fields, dtype=float)
    good = np.isfinite(fields)
    # infill missing values so the spectral filter sees a complete grid
    filled = np.where(good, fields,
                      gaussian_smooth_nan_fill(lons, lats, fields,
                                               width_km))
    filled = np.where(np.isfinite(filled), filled,
                      np.nanmean(fields, axis=(1, 2), keepdims=True))

    dlat_km = abs(lats[1] - lats[0]) * DEG2KM
    dlon_km = (abs(lons[1] - lons[0]) * DEG2KM
               * np.cos(np.deg2rad(np.mean(lats))))
    B, ny, nx = filled.shape
    ky = np.pi * np.arange(ny) / (ny * dlat_km)
    kx = np.pi * np.arange(nx) / (nx * dlon_km)
    k2 = ky[:, None] ** 2 + kx[None, :] ** 2
    sigma = max(width_km / 2.0, 1e-6)
    kc2 = 2.0 * np.log(2.0) / sigma**2          # Gaussian half-power
    T = float(np.clip(tension, 0.0, 0.999))
    lam = 1.0 / ((1.0 - T) * kc2**2 + T * kc2)
    Hf = jnp.asarray(1.0 / (1.0 + lam * ((1.0 - T) * k2**2 + T * k2)))

    z = jnp.asarray(filled)
    coef = dctn(z, type=2, axes=(1, 2), norm="ortho")
    sm = idctn(coef * Hf[None], type=2, axes=(1, 2), norm="ortho")
    out = np.array(sm)
    out[~good] = np.nan
    return out


def gaussian_smooth_nan_fill(lons, lats, fields, width_km):
    """Gaussian-weighted infill values (normalized conv without the
    final NaN restore) — used to seed the spectral tension filter."""
    import jax.numpy as jnp

    z = np.asarray(fields, dtype=float)
    # reuse gaussian_smooth_nan's machinery but keep values everywhere
    good = np.isfinite(z)
    sm = _gaussian_smooth_core(lons, lats, z, width_km)
    return np.where(good, z, sm)


def mapSmooth(lons, lats, z, tension=0.0, width=50.0):
    """Drop-in for the reference's mapSmooth (model3D.py:11-14).

    ``tension=0`` (the reference's call signature default) routes to
    the Gaussian smoother; ``tension>0`` to the spline-in-tension
    spectral filter.
    """
    if tension > 0:
        zNew = tension_spline_smooth(lons, lats, np.asarray(z)[None],
                                     width, tension)[0]
    else:
        zNew = gaussian_smooth_nan(lons, lats, np.asarray(z)[None],
                                   width)[0]
    zNew[np.isnan(z)] = np.nan
    return zNew


# ---------------------------------------------------------------------------
# Great-circle sampling (geographiclib replacement, spherical earth)
# ---------------------------------------------------------------------------

def gc_inverse(lat1, lon1, lat2, lon2):
    """Distance (m) and initial azimuth (deg) along the great circle."""
    p1, p2 = np.deg2rad(lat1), np.deg2rad(lat2)
    dl = np.deg2rad(lon2 - lon1)
    d = np.arccos(np.clip(np.sin(p1) * np.sin(p2)
                          + np.cos(p1) * np.cos(p2) * np.cos(dl), -1, 1))
    az = np.arctan2(np.sin(dl) * np.cos(p2),
                    np.cos(p1) * np.sin(p2)
                    - np.sin(p1) * np.cos(p2) * np.cos(dl))
    return {"s12": d * EARTH_R_KM * 1000.0, "azi1": np.rad2deg(az)}


def gc_direct(lat1, lon1, azi1, s12_m):
    """Point at distance s12 (m) along azimuth azi1 from (lat1, lon1)."""
    p1 = np.deg2rad(lat1)
    az = np.deg2rad(azi1)
    d = s12_m / 1000.0 / EARTH_R_KM
    p2 = np.arcsin(np.sin(p1) * np.cos(d)
                   + np.cos(p1) * np.sin(d) * np.cos(az))
    l2 = np.deg2rad(lon1) + np.arctan2(
        np.sin(az) * np.sin(d) * np.cos(p1),
        np.cos(d) - np.sin(p1) * np.sin(p2))
    return {"lat2": np.rad2deg(p2), "lon2": np.rad2deg(l2)}
