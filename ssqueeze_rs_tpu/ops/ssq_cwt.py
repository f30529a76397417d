"""Synchrosqueezed CWT (forward + inverse).

Pipeline (reference parity: old/ssqueezepy/_ssq_cwt.py):
    cwt(derivative=True) -> gamma = 10*eps -> fused phase+bin+scatter
    (ops/ssqueeze.py) -> Tx, with the 'trig' / 'phase' / 'numeric' difftypes
    and 'peak'/'energy'/'maximal' mapranges.

One jit program per (shape, wavelet, scales-scheme): CWT, derivative,
phase transform and reassignment all fuse. Batched input supported on any
leading dims.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ..config import EPS32, EPS64
from ..scales import process_scales, process_fs_and_t
from ..utils.pad import p2up
from ..wavelets.base import Wavelet
from ..wavelets.adm import adm_ssq
from .cwt import cwt
from .phase import phase_cwt, phase_cwt_num
from .ssqueeze import ssqueeze, check_ssqueezing_args

__all__ = ["ssq_cwt", "issq_cwt"]


def ssq_cwt(x, wavelet="gmw", scales="log-piecewise", nv=None, fs=None,
            t=None, ssq_freqs=None, padtype="reflect", squeezing="sum",
            maprange="peak", difftype="trig", difforder=None, gamma=None,
            vectorized=True, preserve_transform=None, astensor=True, order=0,
            nan_checks=None, patience=0, flipud=True, cache_wavelet=None,
            get_w=False, get_dWx=False, dtype=None):
    """Synchrosqueezed CWT (reference parity: _ssq_cwt.py:12-310).

    Returns (Tx, Wx, ssq_freqs, scales[, w][, dWx]).
    """
    difforder = check_ssqueezing_args(squeezing, maprange, wavelet, difftype,
                                      difforder, get_w, transform="cwt")
    x = jnp.asarray(x)
    N = x.shape[-1]
    dt, fs, _ = process_fs_and_t(fs, t, N)
    if nv is None and isinstance(scales, str):
        nv = 32

    wavelet = Wavelet.build(wavelet, l1_norm=True)

    # higher-order GMW path: averaged CWT, derivative via trig differentiation
    if isinstance(order, (tuple, list, range)) or order > 0:
        from .cwt import cwt_higher_order
        _, n1, _ = p2up(N)
        average = isinstance(order, (tuple, list, range))
        Wxp, scales_arr = cwt_higher_order(
            x, wavelet=wavelet, order=order, average=average, scales=scales,
            fs=fs, nv=nv, l1_norm=True, derivative=False, padtype=padtype,
            rpadded=True, nan_checks=nan_checks, dtype=dtype)
        # trigdiff on the padded transform (reference: _ssq_cwt.py:238,
        # utils/common.py:161-245) — the shared ops/diff.py helper
        from .diff import trigdiff
        dWx = trigdiff(Wxp, fs, rpadded=True, N=N, n1=n1)
        Wx = Wxp[..., n1:n1 + N]
        scales = np.asarray(scales_arr).reshape(-1, 1)
        cwt_scaletype = process_scales(scales, N, wavelet, nv=nv,
                                       get_params=True)[1]
    else:
        scales, cwt_scaletype, *_ = process_scales(scales, N, wavelet, nv=nv,
                                                   get_params=True)
        rpadded = (difftype == "numeric")
        Wx, scales_out, dWx = cwt(x, wavelet, scales=scales, fs=fs, nv=nv,
                                  l1_norm=True, derivative=True,
                                  padtype=padtype, rpadded=rpadded,
                                  nan_checks=nan_checks, dtype=dtype)

    if gamma is None:
        gamma = 10 * (EPS64 if Wx.dtype == jnp.complex128 else EPS32)

    # phase transform if requested explicitly
    if get_w:
        if difftype == "trig":
            w = phase_cwt(Wx, dWx, "trig", gamma)
        elif difftype == "phase":
            w = phase_cwt(Wx, None, "phase", gamma)
        else:  # numeric: Wx is rpadded; trim to N+8 window around signal
            if padtype is None or (isinstance(order, (tuple, list, range))
                                   or order > 0):
                # the N+8 window needs a p2up-PADDED first-order Wx; the
                # reference hits the same clamped slice silently and
                # returns truncated, misaligned output
                # (_ssq_cwt.py:230-262 + 303-306)
                raise ValueError(
                    "difftype='numeric' requires padtype != None and "
                    "order=0 (the phase window reads the padded CWT)")
            _, n1, _ = p2up(N)
            Wx = Wx[..., (n1 - 4):(n1 + N + 4)]
            w = phase_cwt_num(Wx, dt, difforder, gamma)
    else:
        w = None

    if ssq_freqs is None:
        ssq_freqs = cwt_scaletype
    was_padded = bool(padtype is not None)

    Tx, ssq_freqs = ssqueeze(Wx, w, ssq_freqs, scales, fs=fs,
                             squeezing=squeezing, maprange=maprange,
                             wavelet=wavelet, gamma=gamma,
                             was_padded=was_padded, flipud=flipud,
                             dWx=None if get_w else dWx,
                             transform="cwt")

    if difftype == "numeric":
        Wx = Wx[..., 4:-4]
        Tx = Tx[..., 4:-4]
        w = w[..., 4:-4] if w is not None else None

    scales = np.asarray(scales).squeeze()
    if get_w and get_dWx:
        return Tx, Wx, ssq_freqs, scales, w, dWx
    elif get_w:
        return Tx, Wx, ssq_freqs, scales, w
    elif get_dWx:
        return Tx, Wx, ssq_freqs, scales, dWx
    return Tx, Wx, ssq_freqs, scales


# -- inverse ----------------------------------------------------------------
def _process_component_inversion_args(cc, cw):
    # jnp (not numpy) so component inversion is trace-safe: it can run
    # under jit and inside shard_map (parallel.chunked_issq_cwt)
    if cc is None and cw is None:
        return None, None, True
    cc = jnp.asarray(cc, jnp.int32)
    cw = jnp.asarray(cw, jnp.int32)
    if cc.ndim == 1:
        cc = cc[:, None]
    if cw.ndim == 1:
        cw = cw[:, None]
    return cc, cw, False


def _invert_components(Tx, cc, cw):
    """Invert around curve bands in the TF plane; last output row is the
    residual (reference: _ssq_cwt.py:381-403).

    Device-side jnp (the reference loops components in numpy): all K
    component masks are built by one broadcast compare and applied by
    one einsum, so the inversion runs under jit, is differentiable, and
    supports leading batch dims on Tx (output (..., K+1, n_times))."""
    Tx = jnp.asarray(Tx)
    n_freqs = Tx.shape[-2]
    cc = jnp.asarray(cc, jnp.int32).T          # (K, n_times)
    cw = jnp.asarray(cw, jnp.int32).T
    rows = jnp.arange(n_freqs)[None, :, None]  # (1, n_freqs, 1)

    upper = jnp.clip(cc + cw, 0, n_freqs)
    lower = jnp.clip(cc - cw, 0, n_freqs)
    no_curve = cc == -1
    upper = jnp.where(no_curve, 0, upper)
    lower = jnp.where(no_curve, 1, lower)
    # (K, n_freqs, n_times) band masks
    mask = (rows >= lower[:, None, :]) & (rows <= upper[:, None, :])

    Txr = Tx.real
    comps = jnp.einsum("...fn,kfn->...kn", Txr, mask.astype(Txr.dtype),
                       precision=jax.lax.Precision.HIGHEST)
    # residual: rows claimed by NO component (reference keeps &= ~mask)
    remainder = ~jnp.any(mask, axis=0)
    resid = jnp.sum(Txr * remainder.astype(Txr.dtype), axis=-2)
    return jnp.concatenate([comps, resid[..., None, :]], axis=-2)


def issq_cwt(Tx, wavelet="gmw", cc=None, cw=None):
    """Inverse synchrosqueezed CWT (reference parity: _ssq_cwt.py:313-417).

    Full inversion: x = (2/Css) * sum_rows Re(Tx). With `cc`/`cw`, inverts
    per-component over curve bands; output rows are components + residual.
    """
    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)
    if full_inverse:
        x = jnp.asarray(Tx).real.sum(axis=-2)
    else:
        x = _invert_components(Tx, cc, cw)

    wavelet = Wavelet.build(wavelet)
    Css = adm_ssq(wavelet)
    return x * (2 / Css)
