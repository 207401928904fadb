"""Prior (``isgood``) building blocks, host + device implementations.

The reference expresses priors as Python checks over rebuilt grids
(``/root/reference/models.py:294-677``), including scipy local-extrema
and continuous-wavelet oscillation tests.  Here each constraint exists
twice with one set of semantics:

  * numpy host versions (used by the object API's ``isgood``);
  * jnp device versions (used by the compiled MCMC step, where the
    constraint evaluates as a boolean lane mask instead of control flow).

scipy removed ``signal.cwt``/``signal.ricker`` in 1.12, so the Ricker
CWT is implemented directly (same definition scipy used).
"""

from __future__ import annotations

import numpy as np


# ---------------------------------------------------------------------------
# host (numpy) versions
# ---------------------------------------------------------------------------

def _ricker(points, a):
    A = 2 / (np.sqrt(3 * a) * np.pi**0.25)
    t = np.arange(points) - (points - 1) / 2
    return A * (1 - (t / a) ** 2) * np.exp(-(t**2) / (2 * a**2))


def ricker_cwt(data, width):
    """Single-scale Ricker CWT row, matching scipy.signal.cwt."""
    data = np.asarray(data, dtype=float)
    N = min(10 * int(width), len(data))
    wav = _ricker(N, width)
    return np.convolve(data, wav[::-1], mode="same")


def _argrel(x, cmp):
    x = np.asarray(x)
    return np.where(cmp(x[1:-1], x[:-2]) & cmp(x[1:-1], x[2:]))[0] + 1


def local_extrema_oscillation(v, limit):
    """True if adjacent local extrema differ by less than ``limit``
    (models.py:600-609)."""
    imax = _argrel(v, np.greater)
    imin = _argrel(v, np.less)
    if len(imax) + len(imin) > 1:
        ind = np.sort(np.append(imax, imin))
        osci = np.abs(np.diff(np.asarray(v)[ind]))
        if np.any(osci > limit):
            return False
    return True


def cwt_oscillation(vsM, zM, limit=0.3):
    """CWT-based mantle oscillation prior (models.py:625-634)."""
    dz = zM[1] - zM[0]
    width = 30 // dz
    if width < 1:
        return True
    detrend = vsM - np.interp(zM, [zM[0], zM[-1]], [vsM[0], vsM[-1]])
    cwt = ricker_cwt(detrend, width)
    imax = _argrel(cwt, np.greater)
    imin = _argrel(cwt, np.less)
    ind = np.sort(np.append(imax, imin))
    if ind.size > 1 and np.any(np.abs(np.diff(cwt[ind])) > limit):
        return False
    return True


# ---------------------------------------------------------------------------
# device (jnp) versions — boolean masks, fixed shapes
# ---------------------------------------------------------------------------

def jnp_mono_increase(v, mask, eps=None):
    """all(diff(v) >= eps) over masked entries."""
    import jax.numpy as jnp
    eps = np.finfo(np.float64).eps if eps is None else eps
    dv = jnp.diff(v)
    pair = mask[1:] & mask[:-1]
    return jnp.all(jnp.where(pair, dv >= eps, True))


def jnp_group_jumps_positive(vs, grp_ids, keep=None):
    """Vs jump at every group boundary is non-negative (Shen et al. 2012
    constraint 5; models.py:585-588).

    With ``keep`` (bool mask of surviving nodes — the host path drops
    layers thinner than 0.01 km before checking, models.py:80), the
    comparison runs between consecutive *kept* nodes, exactly as on the
    host's compacted grid.
    """
    import jax.numpy as jnp
    if keep is None:
        boundary = grp_ids[1:] != grp_ids[:-1]
        return jnp.all(jnp.where(boundary, vs[1:] >= vs[:-1], True))
    pair = _adjacent_flagged_pairs(keep)     # j = next kept after i
    boundary = pair & (grp_ids[None, :] != grp_ids[:, None])
    bad = boundary & (vs[None, :] < vs[:, None])
    return ~jnp.any(bad)


def _adjacent_flagged_pairs(flag):
    """(n, n) bool: [i, j] iff i and j are flagged and j is the NEXT
    flagged position strictly after i.

    O(n^2) masked-matrix formulation (n <= ~100 node grids): with
    ``c = cumsum(flag)`` (inclusive), j is adjacent-after i exactly when
    both are flagged and ``c[j] == c[i] + 1``.  Replaces the
    associative-scan ``_prev_flagged`` (log2(n) select rounds x several
    tensors) and every dynamic gather: the whole pair check fuses into
    a couple of kernels where the scan form serialized many small
    launches per use site.
    """
    import jax.numpy as jnp
    c = jnp.cumsum(flag.astype(jnp.int32))
    return flag[:, None] & flag[None, :] & (c[None, :] == c[:, None] + 1)


def _adjacent_flagged_gap_ok(vals, flag, limit):
    """No adjacent flagged pair differs by more than ``limit``."""
    import jax.numpy as jnp
    pair = _adjacent_flagged_pairs(flag)
    bad = pair & (jnp.abs(vals[None, :] - vals[:, None]) > limit)
    return ~jnp.any(bad)


def jnp_local_extrema_oscillation(v, mask, limit):
    """Device version of local_extrema_oscillation.

    Computes the sequence of local extrema values (masked gather-free
    formulation): for each adjacent *pair* of extrema, the |difference|
    must be <= limit.  Adjacent extrema alternate max/min, so the check
    "no adjacent-extrema gap > limit" equals: for every local max M and
    the nearest local min m on either side, |M - m| <= limit.  We bound
    it conservatively with a running scan over extrema flags.
    """
    import jax.numpy as jnp

    inner = mask[1:-1] & mask[:-2] & mask[2:]
    is_max = (v[1:-1] > v[:-2]) & (v[1:-1] > v[2:]) & inner
    is_min = (v[1:-1] < v[:-2]) & (v[1:-1] < v[2:]) & inner
    is_ext = is_max | is_min
    # fewer than 2 extrema -> no adjacent pair -> vacuously True
    return _adjacent_flagged_gap_ok(v[1:-1], is_ext, limit)


def jnp_no_local_max(v, mask):
    import jax.numpy as jnp
    inner = mask[1:-1] & mask[:-2] & mask[2:]
    is_max = (v[1:-1] > v[:-2]) & (v[1:-1] > v[2:]) & inner
    return ~jnp.any(is_max)


def jnp_cwt_oscillation(v, z, mask, limit=0.3, max_width=None):
    """Device Ricker-CWT oscillation prior with a fixed kernel length.

    The kernel length is static; the width parameter itself may be
    traced — kernel *values* depend on it.  ``max_width=None`` (the
    default) uses the full signal length ``n`` as the kernel length,
    which is exactly the host convention whenever ``10*width >= n``
    (host: ``N = min(10*int(width), len(data))``, priors.py:34) — i.e.
    for any mantle layer thinner than ~300 km, since
    ``width = 30//dz`` and ``n*dz = H``.  This removes the old static
    ``max_width=32`` cap that silently truncated the kernel for fine
    grids with ``n > 320``.  For the remaining
    ``10*width < n`` regime (H > ~300 km) the zeroed-tail emulation is
    bit-exact iff ``n`` is even (the host kernel length ``10*width``
    is always even, so its taps sit on half-integer offsets; an odd
    ``n`` shifts the tap grid by 0.5).
    """
    import jax.numpy as jnp

    n = v.shape[0]
    if max_width is None:
        max_width = -(-n // 10)  # ceil: 10*max_width >= n  ->  N = n
    nz = jnp.maximum(jnp.sum(mask), 2)
    dz = (z[1] - z[0])
    width = jnp.floor(30.0 / dz)
    width = jnp.maximum(width, 1.0)

    # linear detrend between first/last masked points
    v0, v1 = v[0], v[jnp.clip(nz - 1, 0, n - 1)]
    z0, z1 = z[0], z[jnp.clip(nz - 1, 0, n - 1)]
    line = v0 + (v1 - v0) * (z - z0) / jnp.maximum(z1 - z0, 1e-9)
    detrend = jnp.where(mask, v - line, 0.0)

    # kernel length: static, capped at the signal length — jnp.convolve
    # ('same') returns max(len(v), len(kernel)) so a longer kernel would
    # change the output length; scipy.signal.cwt used the same cap
    N = min(10 * max_width, n)
    t = jnp.arange(N) - (N - 1) / 2
    A = 2 / (jnp.sqrt(3 * width) * jnp.pi**0.25)
    wav = A * (1 - (t / width) ** 2) * jnp.exp(-(t**2) / (2 * width**2))
    # zero kernel tail beyond the dynamic 10*width window, centred
    keep = jnp.abs(t) <= (5.0 * width)
    wav = jnp.where(keep, wav, 0.0)
    cwt = jnp.convolve(detrend, wav[::-1], mode="same")

    inner = mask[1:-1] & mask[:-2] & mask[2:]
    is_ext = (((cwt[1:-1] > cwt[:-2]) & (cwt[1:-1] > cwt[2:]))
              | ((cwt[1:-1] < cwt[:-2]) & (cwt[1:-1] < cwt[2:]))) & inner
    return _adjacent_flagged_gap_ok(cwt[1:-1], is_ext, limit)
