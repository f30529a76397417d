"""Continuous Wavelet Transform, forward & inverse.

Design (vs reference old/ssqueezepy/_cwt.py, rust/src/spectral/cwt.rs):
  * the whole CWT is ONE batched tensor program:
        Wx = ifft(psih(scales[:,None]*xi) * fft(x_padded)[None,:])
    — a single (na, Npad) batched iFFT replaces the reference's Rayon
    per-scale loop (cwt.rs:228-310) and its thread-local FFT planners,
  * derivative CWT multiplies the same product by (i*xi/dt) — no extra
    wavelet sampling,
  * wavelet is a static (hashable) argument: psih sampling is traced into
    the jit program and fused by XLA,
  * scale planning (log/log-piecewise/linear grids, bounds) is host-side
    numpy, cached per (wavelet, N, preset).

Batched inputs: any leading dims; dim -1 is time (reference supports 1D/2D,
we support ND).
"""
from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULTS, complex_dtype
from ..scales import (process_scales, process_fs_and_t,
                      logscale_transition_idx)
from ..utils.fft import xifn
from ..utils.pad import padsignal
from ..wavelets.base import Wavelet
from ..wavelets.adm import adm_cwt, adm_ssq

__all__ = ["cwt", "icwt", "cwt_core", "cwt_higher_order", "scale_block_for"]


def _cwt_rows(xh, scales, dt, wavelet, derivative, N, n1, rpadded):
    """Wx (and dWx) rows of `scales` from the padded signal's spectrum
    xh (..., M): one batched iFFT over [spectra; derivative spectra]."""
    M = xh.shape[-1]
    with jax.named_scope("cwt_filterbank"):
        Psih = wavelet.sample(scales, M, xp=jnp, nohalf=False)
        Z = Psih.astype(xh.dtype) * xh[..., None, :]
        if derivative:
            xi = xifn(1, M, xp=jnp).astype(scales.dtype)
            Z = jnp.concatenate([Z, Z * (1j * xi / dt)], axis=-2)
    with jax.named_scope("cwt_ifft"):
        W = jnp.fft.ifft(Z, axis=-1)
    if not rpadded:
        W = W[..., n1:n1 + N]
    na = scales.shape[0]
    return W[..., :na, :], (W[..., na:, :] if derivative else None)


@partial(jax.jit, static_argnames=("wavelet", "derivative", "l1_norm", "N",
                                   "n1", "rpadded", "scale_block"))
def cwt_core(xp, scales, dt, *, wavelet: Wavelet, derivative: bool,
             l1_norm: bool, N: int, n1: int, rpadded: bool,
             scale_block=None):
    """CWT of an already-padded signal. xp: (..., M); returns (..., na, N)
    (or (..., na, M) when `rpadded`).

    `scale_block` (host-chosen, see `scale_block_for`): run the iFFT over
    blocks of that many scales in sequence (`lax.map`), so only one
    block's padded-length spectra live at a time; None = one batch."""
    with jax.named_scope("cwt_fft"):
        xh = jnp.fft.fft(xp, axis=-1).astype(complex_dtype(xp.dtype))
    na = scales.shape[0]
    if scale_block is None or scale_block >= na:
        Wx, dWx = _cwt_rows(xh, scales, dt, wavelet, derivative, N, n1,
                            rpadded)
    else:
        nb = -(-na // scale_block)
        sc = jnp.concatenate([scales, jnp.repeat(scales[-1:],
                                                 nb * scale_block - na)])
        out = jax.lax.map(
            lambda s: _cwt_rows(xh, s, dt, wavelet, derivative, N, n1,
                                rpadded), sc.reshape(nb, scale_block))

        def unblock(W):   # (nb, ..., blk, L) -> (..., na, L)
            W = jnp.moveaxis(W, 0, -3)
            return W.reshape(W.shape[:-3] + (-1, W.shape[-1]))[..., :na, :]
        Wx = unblock(out[0])
        dWx = unblock(out[1]) if derivative else None

    if not l1_norm:
        root = jnp.sqrt(scales).astype(Wx.real.dtype)[:, None]
        Wx = Wx * root
        if derivative:
            dWx = dWx * root
    return Wx, dWx


def scale_block_for(n_scales, M, batch, derivative, itemsize):
    """Scales per iFFT block so the block's spectra, their iFFT and the
    FFT library's scratch (about three arrays of (batch, rows, M)
    complex) stay within half of the device's memory limit; None (one
    block) when everything fits or the device reports no limit."""
    from ..utils.common import device_memory_limit
    limit = device_memory_limit()
    if limit is None:
        return None
    per_scale = 3 * batch * (2 if derivative else 1) * M * 2 * itemsize
    blk = max(1, int(limit // 2 // per_scale))
    if blk >= n_scales:
        return None
    return -(-n_scales // -(-n_scales // blk))   # equal blocks, least pad


def cwt(x, wavelet="gmw", scales="log-piecewise", fs=None, t=None, nv=32,
        l1_norm=True, derivative=False, padtype="reflect", rpadded=False,
        vectorized=True, astensor=True, cache_wavelet=None, order=0,
        average=None, nan_checks=None, patience=0, dtype=None):
    """Continuous Wavelet Transform (reference parity: _cwt.py:12-318).

    `vectorized`, `astensor`, `patience` and `cache_wavelet` are
    accepted for API compatibility: the transform is always a single
    vectorized program, the filterbank is sampled inside it, and XLA
    owns planning/caching.

    Returns (Wx, scales) or (Wx, scales, dWx) if `derivative`.
    """
    if isinstance(order, (tuple, list, range)) or order > 0:
        return cwt_higher_order(
            x, wavelet=wavelet, order=order, average=average, scales=scales,
            fs=fs, t=t, nv=nv, l1_norm=l1_norm, derivative=derivative,
            padtype=padtype, rpadded=rpadded, nan_checks=nan_checks,
            dtype=dtype)

    x = jnp.asarray(x)
    if nan_checks is None or nan_checks:
        x = jnp.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    dtype = dtype or DEFAULTS["dtype"]
    x = x.astype(dtype)

    N = x.shape[-1]
    dt, fs, _ = process_fs_and_t(fs, t, N)
    if not isinstance(scales, str):
        nv = None

    wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
    scales_arr = process_scales(scales, N, wavelet, nv=nv)

    if padtype is not None:
        xp, _, n1, _ = padsignal(x, padtype, get_params=True)
    else:
        xp, n1 = x, 0

    from ..utils.common import warn_hbm_budget
    batch = int(np.prod(x.shape[:-1])) if x.ndim > 1 else 1
    warn_hbm_budget(N, len(scales_arr), batch=batch, derivative=derivative,
                    what="cwt")
    block = scale_block_for(len(scales_arr), xp.shape[-1], batch, derivative,
                            np.dtype(dtype).itemsize)

    out = cwt_core(xp, jnp.asarray(scales_arr.squeeze(-1), dtype=dtype),
                   jnp.asarray(dt, dtype=dtype), wavelet=wavelet,
                   derivative=derivative, l1_norm=l1_norm, N=N, n1=n1,
                   rpadded=rpadded, scale_block=block)
    scales_out = scales_arr.squeeze()
    if derivative:
        return out[0], scales_out, out[1]
    return out[0], scales_out


def cwt_higher_order(x, wavelet="gmw", order=1, average=None, **kw):
    """CWT with higher-order GMWs; tuple `order` optionally averaged
    (reference parity: _cwt.py:515-608)."""
    if isinstance(order, (list, range)):
        order = tuple(order)
    single = not isinstance(order, tuple)
    orders = (order,) if single else order

    wavelet = Wavelet.build(wavelet, l1_norm=kw.get("l1_norm", True))
    if wavelet.name != "gmw":
        raise ValueError("`wavelet` must be GMW for higher-order transforms "
                         f"(got {wavelet.name})")
    wavopts = wavelet.config
    wavopts.pop("order", None)

    # fix scales from the zeroth-order wavelet so all orders share a grid
    scales = kw.pop("scales", "log-piecewise")
    if isinstance(scales, str):
        wav0 = Wavelet.build(("gmw", dict(order=0, **wavopts)))
        scales = process_scales(scales, np.asarray(x).shape[-1], wav0,
                                nv=kw.pop("nv", 32))
    else:
        kw.pop("nv", None)

    derivative = kw.get("derivative", False)
    Wx_all, dWx_all = [], []
    for k in orders:
        wav_k = Wavelet.build(("gmw", dict(order=int(k), **wavopts)))
        out = cwt(x, wav_k, scales=scales, **kw)
        Wx_all.append(out[0])
        if derivative:
            dWx_all.append(out[-1])

    if (average or (average is None and not single)) and len(Wx_all) > 1:
        Wx_all = jnp.mean(jnp.stack(Wx_all), axis=0)
        if derivative:
            dWx_all = jnp.mean(jnp.stack(dWx_all), axis=0)
    elif len(Wx_all) == 1:
        Wx_all = Wx_all[0]
        if derivative:
            dWx_all = dWx_all[0]

    scales_out = np.asarray(scales).squeeze()
    return ((Wx_all, scales_out, dWx_all) if derivative else
            (Wx_all, scales_out))


# -- inverse --------------------------------------------------------------------
def _icwt_norm(scaletype: str, l1_norm: bool):
    """(reference: _cwt.py:483-492)"""
    if l1_norm:
        return (lambda s: 1.0) if scaletype == "log" else (lambda s: s)
    if scaletype == "log":
        return lambda s: s**0.5
    return lambda s: s**1.5


def icwt(Wx, wavelet="gmw", scales="log-piecewise", nv=None, one_int=True,
         x_len=None, x_mean=0, padtype="reflect", rpadded=False, l1_norm=True):
    """Inverse CWT via one- or two-integral formula
    (reference parity: _cwt.py:321-492). Supports leading batch dims for
    both integral forms (the reference is 1D-only here, _cwt.py:344)."""
    Wx = jnp.asarray(Wx)
    *_, na, n = Wx.shape
    x_len = x_len or n
    if not isinstance(scales, (np.ndarray, jnp.ndarray)) and nv is None:
        nv = 32

    wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
    scales, scaletype, _, nv = process_scales(scales, x_len, wavelet, nv=nv,
                                              get_params=True)
    assert len(scales) == na, f"{len(scales)} != {na}"

    if scaletype == "log-piecewise":
        idx = logscale_transition_idx(scales)
        # x_mean added ONCE after combining the two log segments — the
        # reference passes it into both recursive calls and adds it
        # twice (_cwt.py:421-427); documented divergence (bug fix)
        kw = dict(wavelet=wavelet, one_int=one_int, x_len=x_len,
                  x_mean=0, padtype=padtype, rpadded=rpadded,
                  l1_norm=l1_norm)
        x = icwt(Wx[..., :idx, :], scales=scales[:idx], **kw)
        x = x + icwt(Wx[..., idx:, :], scales=scales[idx:], **kw)
        return x + x_mean

    scales_1d = jnp.asarray(scales.squeeze(-1), dtype=Wx.real.dtype)
    if one_int:
        x = _icwt_1int(Wx, scales_1d, scaletype, l1_norm)
    else:
        x = _icwt_2int(Wx, scales_1d, scaletype, l1_norm, wavelet, x_len,
                       padtype, rpadded)

    Cpsi = adm_ssq(wavelet) if one_int else adm_cwt(wavelet)
    if scaletype == "log":
        x = x * ((2 / Cpsi) * np.log(2 ** (1 / nv)))
    else:
        x = x * ((2 / Cpsi) * np.pi / 4)
    return x + x_mean


def _icwt_1int(Wx, scales, scaletype, l1_norm):
    """One-integral iCWT (analytic wavelets): sum over scales of
    Re(Wx)/norm (reference: _cwt.py:477-480)."""
    norm = _icwt_norm(scaletype, l1_norm)
    return (Wx.real / norm(scales[:, None])).sum(axis=-2)


def _icwt_2int(Wx, scales, scaletype, l1_norm, wavelet, x_len, padtype,
               rpadded):
    """Double-integral iCWT (reference: _cwt.py:454-474), vectorized over
    scales."""
    if not rpadded:
        Wx, n_up, n1, _ = padsignal(Wx, padtype=padtype, get_params=True)
    else:
        n_up, n1 = Wx.shape[-1], 0

    norm = _icwt_norm(scaletype, l1_norm)
    pn = (-1.0) ** jnp.arange(n_up)
    Psih = wavelet.sample(scales, n_up, xp=jnp, nohalf=True) * pn
    xa = jnp.fft.ifft(jnp.fft.fft(Wx, axis=-1) * Psih, axis=-1)
    xa = jnp.fft.ifftshift(xa, axes=-1)
    x = (xa.real / norm(scales[:, None])).sum(axis=-2)
    return x[..., n1:n1 + x_len]
