"""Ridge extraction: forward-backward dynamic programming on the TF plane.

Reference parity: old/ssqueezepy/ridge_extraction.py (Iatsenko et al.,
Eq. III.4 variant). Design: the sequential time recursion is a
`lax.scan` whose per-step body is a vectorized min-plus product
(min over (na, na) matrix) — replacing the numba row loops. Multi-ridge
extraction zeroes +-bw bins around each found ridge and repeats.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from .config import EPS32, EPS64

__all__ = ["extract_ridges"]


@partial(jax.jit, static_argnames=("n_ridges", "bw", "transform"))
def _extract(Tf, scales_t, penalty, eps, *, n_ridges, bw, transform):
    dtype = jnp.float64 if Tf.dtype == jnp.complex128 else jnp.float32
    scales_t = scales_t.astype(dtype)
    energy0 = jnp.abs(Tf) ** 2
    na, n_t = energy0.shape

    # penalty matrix: penalty * (s_i - s_j)^2 (log-scales for cwt)
    s = jnp.log(scales_t) if transform == "cwt" else scales_t
    pen_mat = penalty.astype(dtype) * jnp.subtract.outer(s, s) ** 2

    def one_ridge(energy):
        e = -jnp.log(energy / energy.max(axis=0) + eps)

        # forward accumulation (reference: ridge_extraction.py:169-183)
        def fw_step(carry, e_col):
            # carry: penalized energy column at t-1, shape (na,)
            pen_col = e_col + jnp.min(carry[None, :] + pen_mat, axis=1)
            return pen_col, pen_col

        pen0 = e[:, 0]
        _, pen_rest = jax.lax.scan(fw_step, pen0, e[:, 1:].T)
        pen_e = jnp.concatenate([pen0[:, None], pen_rest.T], axis=1)

        # init ridge from forward pass: argmin over freq of last... reference
        # takes argmin over the flattened (freq, time) then its time index —
        # effectively the per-time argmin of penalized energy:
        ridge_fw = jnp.argmin(pen_e, axis=0)

        # backward pass (reference: ridge_extraction.py:206-215): at each t,
        # re-pick the freq consistent with the t+1 choice; numba keeps the
        # LAST matching index, replicated here via reversed argmax.
        def bw_scan(carry, t_cols):
            pen_col_t, e_col_t1, pen_col_t1, fw_t = t_cols
            ridge_next = carry
            val = pen_col_t1[ridge_next] - e_col_t1[ridge_next]
            new_pen = pen_mat[ridge_next, :]
            cond = jnp.abs(val - (pen_col_t + new_pen)) < eps
            idx_last = (na - 1) - jnp.argmax(cond[::-1])
            ridge_t = jnp.where(jnp.any(cond), idx_last, fw_t)
            return ridge_t, ridge_t

        # scan from t = n_t-2 down to 0
        cols = (pen_e[:, :-1].T[::-1], e[:, 1:].T[::-1],
                pen_e[:, 1:].T[::-1], ridge_fw[:-1][::-1])
        _, ridges_rev = jax.lax.scan(bw_scan, ridge_fw[-1], cols)
        ridge = jnp.concatenate([ridges_rev[::-1], ridge_fw[-1:]])
        return ridge

    ridges = []
    energy = energy0
    rows = jnp.arange(na)[:, None]
    for _ in range(n_ridges):
        ridge = one_ridge(energy)
        ridges.append(ridge)
        # zero +-bw bins around the ridge (reference: :141-143)
        mask = (rows >= ridge[None, :] - bw) & (rows < ridge[None, :] + bw)
        energy = jnp.where(mask, 0.0, energy)
    return jnp.stack(ridges, axis=1)


def extract_ridges(Tf, scales, penalty=2.0, n_ridges=1, bw=15,
                   transform="cwt", get_params=False, parallel=True):
    """Track `n_ridges` maximum-energy ridges (reference parity:
    ridge_extraction.py:11-146).

    Returns ridge_idxs [n_timeshifts x n_ridges]; with `get_params`, also
    (ridge_f, ridge_e) — ridge i's energies are read AFTER ridges 0..i-1
    zeroed their bands, like the reference (ridge_extraction.py:131-143).

    Documented divergence: the +-bw zeroing clamps at row 0. The
    reference's `energy[ridx-bw : ridx+bw]` numpy slice is EMPTY when
    ridx < bw (negative start wraps past the stop), so it zeroes nothing
    there and a later ridge can re-select the same low-row component;
    the clamped mask zeroes rows 0..ridx+bw-1 as intended.
    """
    Tf = jnp.asarray(Tf)
    eps = EPS64 if Tf.dtype == jnp.complex128 else EPS32
    scales_arr = np.asarray(scales, dtype=np.float64).squeeze()

    ridge_idxs = _extract(Tf, jnp.asarray(scales_arr),
                          jnp.asarray(float(penalty)), jnp.asarray(eps),
                          n_ridges=int(n_ridges), bw=int(bw),
                          transform=transform)
    ridge_idxs = np.asarray(ridge_idxs).astype(int)
    if not get_params:
        return ridge_idxs

    n_t = ridge_idxs.shape[0]
    energy = np.abs(np.asarray(Tf)) ** 2
    ridge_f = scales_arr[ridge_idxs]
    # progressive zeroing: ridge i's energy is read from the array as
    # zeroed by ridges 0..i-1 (reference order of operations)
    ridge_e = np.empty_like(ridge_f)
    rows = np.arange(energy.shape[0])[:, None]
    tcols = np.arange(n_t)
    for i in range(ridge_idxs.shape[1]):
        ri = ridge_idxs[:, i]
        ridge_e[:, i] = energy[ri, tcols]
        mask = (rows >= ri[None, :] - bw) & (rows < ri[None, :] + bw)
        energy = np.where(mask, 0.0, energy)
    return ridge_idxs, ridge_f, ridge_e
