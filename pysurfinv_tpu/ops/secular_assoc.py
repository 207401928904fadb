"""Secular functions as parallel trees of propagator-matrix products.

The SURVEY §5 "long-context" formulation: the depth recursion of the
Thomson–Haskell / Dunkin secular functions (up to ~1000 sublayers,
``/root/reference/fast_surf_src/surfa.f:87``) is an associative chain of
per-layer matrix products — 5x5 for the Rayleigh reduced-Δ update
(``surfa.f:326-335``), 2x2 for the Love Haskell update
(``surfa.f:135-183``) — so it can be evaluated as a log-depth binary
product tree instead of a sequential ``lax.scan``:

    F(c, T) = closure · ( M_{L-2} @ ... @ M_1 @ M_0 ) · e_seed

Each tree level combines adjacent pairs ``M'[m] = M[2m+1] @ M[2m]``
with a per-matrix max-abs renormalisation (sign-preserving, wrapped in
``stop_gradient`` — the same AD-constant convention as the sequential
path in :mod:`pysurfinv_tpu.ops.secular`), so the result equals the
sequential recursion up to a positive per-evaluation scale; roots,
sign structure, and tangent *ratios* are identical.

Cost trade (why this is NOT the default): the tree evaluates full
matrix-matrix products — 2·n³ flops per combine vs the sequential
path's 2·n² matrix-vector per layer, i.e. 5x the flops for Rayleigh —
and materialises an (L, 5, 5) tensor per lane instead of keeping a
5-vector in registers.  At large batch the VPU is already saturated by
the lane axis, so the extra flops are pure loss; the tree wins only
when the batch is too small to fill the machine and the sequential
scan's L-step dependency chain dominates latency.  Its GPU timing
is not measured yet (ROADMAP §3); ``tests/test_secular_assoc.py``
pins root parity against the sequential path.

The per-layer matrix entries and closure rows are imported from
:mod:`pysurfinv_tpu.ops.secular` — one source of truth for the physics
(``surfa.f:185-372`` parity).
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

from pysurfinv_tpu.ops.secular import (
    ACCUR,
    TWO_PI,
    _dunkin_closure,
    _dunkin_entries,
)


def _renorm(M):
    """Sign-preserving max-abs rescale per matrix; AD constant."""
    scale = lax.stop_gradient(
        jnp.max(jnp.abs(M), axis=(-2, -1), keepdims=True))
    return M / jnp.where(scale > 0.0, scale, 1.0)


def _tree_product(M):
    """``M[n-1] @ ... @ M[0]`` by a log-depth pairwise tree.

    ``M``: (n, k, k) with n a power of two (pad with identities).
    Each level halves n; every combined product is renormalised.
    """
    n = M.shape[0]
    while n > 1:
        A, Bm = M[1::2], M[0::2]
        # A @ B written as broadcast-multiply-sum: a 5x5 (or 2x2)
        # contraction is far below the MXU tile, so XLA lowers a
        # dot_general to exactly this VPU form anyway — and jaxlib
        # 0.9.0's XLA:CPU verifier rejects the tiny batched dot under
        # nested vmap (layout assignment bug, see tests)
        M = _renorm(jnp.sum(A[..., :, :, None] * Bm[..., None, :, :],
                            axis=-2))
        n = M.shape[0]
    return M[0]


def _pad_pow2(M):
    n = M.shape[0]
    p = 1
    while p < n:
        p *= 2
    if p == n:
        return M
    eye = jnp.broadcast_to(jnp.eye(M.shape[1], dtype=M.dtype),
                           (p - n,) + M.shape[1:])
    return jnp.concatenate([M, eye], axis=0)


def _dunkin_matrix(e, liquid, apply):
    """Full 5x5 matrix of the symmetric Dunkin update (surfa.f:326-335).

    Rows mirror ``ops.secular._dunkin_update`` exactly; masked-out
    layers (padding / beyond the truncation) become the identity.
    """
    z = jnp.zeros_like(e["e11"])
    M = jnp.stack([
        jnp.stack([e["e11"], e["e12"], e["e13"], e["e14"], e["e15"]]),
        jnp.stack([e["e21"], e["e22"], e["e23"], e["e24"], -e["e14"]]),
        jnp.stack([e["e31"], e["e32"], e["e33"], -0.5 * e["e23"],
                   0.5 * e["e13"]]),
        jnp.stack([e["e41"], e["e42"], -2.0 * e["e32"], e["e22"],
                   -e["e12"]]),
        jnp.stack([e["e51"], -e["e41"], 2.0 * e["e31"], -e["e21"],
                   e["e11"]]),
    ])                                                   # (5, 5[, ...])
    del z, liquid
    eye = jnp.eye(5, dtype=M.dtype)
    if M.ndim > 2:   # vectorized over a trailing layer axis
        eye = eye[:, :, None]
    return jnp.where(apply, M, eye)


def rayleigh_secular_assoc(c, t, a, b, rho, d, mmax):
    """Tree-product evaluation of the Dunkin Rayleigh secular function.

    Same arguments and root structure as
    :func:`pysurfinv_tpu.ops.secular.rayleigh_secular`; the returned
    value differs by a positive per-evaluation scale only.
    """
    wvno = TWO_PI / (c * t)
    csq = c * c
    L = a.shape[0]
    apply_mask = jnp.arange(L - 1) < (mmax - 1)

    # entries for all layers at once: (entry, L-1) arrays
    e, _liq = _dunkin_entries(c, csq, wvno, a[:-1], b[:-1], rho[:-1],
                              d[:-1])
    M = _dunkin_matrix(e, _liq, apply_mask[None, None, :])   # (5,5,L-1)
    M = _renorm(jnp.moveaxis(M, -1, 0))                       # (L-1,5,5)
    T = _tree_product(_pad_pow2(M))

    bvec = T[:, 0]   # T @ e1
    h = mmax - 1
    return -_dunkin_closure(c, csq, a[h], b[h], rho[h], bvec)


def love_secular_assoc(c, t, b, rho, d, mmax):
    """Tree-product evaluation of the Haskell Love secular function.

    Propagation runs from the effective halfspace UP to the surface
    (``surfa.f:135-183``); with the layer matrices H_l the surface
    state is ``H_0 @ H_1 @ ... @ H_{m-2} @ s_half``, evaluated as one
    reversed product tree.  Water layers (vs = 0) are identity
    (skipped, surfa.f:150-152).
    """
    wvno = TWO_PI / (c * t)
    L = b.shape[0]
    idx = jnp.arange(L - 1)

    h = mmax - 1
    b_h = jnp.where(jnp.abs(b[h]) > ACCUR, b[h], 1.0)
    rb_h = jnp.sqrt(jnp.abs((c / b_h) ** 2 - 1.0))
    s0 = jnp.stack([jnp.ones((), b.dtype), rho[h] * b_h * b_h * rb_h])
    scale0 = lax.stop_gradient(jnp.max(jnp.abs(s0)))
    s0 = s0 / jnp.where(scale0 > 0, scale0, 1.0)

    b_m, rho_m, d_m = b[:-1], rho[:-1], d[:-1]
    water = jnp.abs(b_m) <= ACCUR
    apply = (idx <= (mmax - 2)) & ~water
    b_safe = jnp.where(water, 1.0, b_m)
    rb = jnp.sqrt(jnp.abs((c / b_safe) ** 2 - 1.0))
    hmu = rho_m * b_safe * b_safe
    q = -wvno * d_m * rb
    osc = (c > b_safe) & (rb >= 1e-20)
    ev = (c < b_safe) & (rb >= 1e-20)
    q_osc = jnp.where(osc, q, 0.0)
    q_ev = jnp.where(ev, q, 0.0)
    rb_safe = jnp.where(rb >= 1e-20, rb, 1.0)
    eq = jnp.exp(q_ev)
    shq, chq = 0.5 * (eq - 1.0 / eq), 0.5 * (eq + 1.0 / eq)
    y = jnp.where(osc, jnp.sin(q_osc) / rb_safe,
                  jnp.where(ev, shq / rb_safe, -wvno * d_m))
    z = jnp.where(osc, rb * jnp.sin(q_osc),
                  jnp.where(ev, -rb * shq, 0.0))
    cosq = jnp.where(osc, jnp.cos(q_osc), jnp.where(ev, chq, 1.0))

    H = jnp.stack([jnp.stack([cosq, -y / hmu]),
                   jnp.stack([hmu * z, cosq])])            # (2, 2, L-1)
    eye = jnp.eye(2, dtype=H.dtype)[:, :, None]
    H = jnp.where(apply[None, None, :], H, eye)
    # surface state = H_0 @ H_1 @ ... @ H_{L-2} @ s0: reverse the layer
    # axis so the tree's "apply left-to-right" order matches
    H = _renorm(jnp.moveaxis(H, -1, 0)[::-1])              # (L-1, 2, 2)
    T = _tree_product(_pad_pow2(H))
    s = T @ s0
    return -s[1]
