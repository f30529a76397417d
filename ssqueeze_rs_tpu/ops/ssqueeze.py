"""Synchrosqueezing engine: phase transform + analytic binning + scatter.

Redesign of the reference squeeze engine
(old/ssqueezepy/ssqueezing.py + algos.py fused kernels):

  * frequency-bin index computed ANALYTICALLY in closed form per scaletype
    (log / log-piecewise / linear) — the reference's fastest path
    (algos.py:859-984); never the O(bins^2) brute-force argmin the Rust port
    uses (rust/src/spectral/ssq_stft.rs:280-289),
  * the fused path (w=None, from dWx) computes phase, bin and scatter in one
    traced program — XLA fuses the elementwise stage into the scatter
    operand,
  * arbitrary leading batch dims: batch is folded into the time axis so ONE
    scatter covers all channels (reference loops channels,
    ssqueezing.py:209-214),
  * ssq_freqs grids & constants are host-side planning (numpy), traced in as
    scalars.

Normalization constants (reference ssqueezing.py:124-134):
  CWT log:    const = ln(2)/nv          (per-row array for log-piecewise)
  CWT linear: const = (s1 - s0)/scales  (per-row)
  STFT:       const = dssq_freq

The Rust port omits `const` entirely (rust/src/spectral/ssq_cwt.rs:125-127);
we follow ssqueezepy — documented divergence.
"""
from __future__ import annotations

from functools import partial
from types import FunctionType

import numpy as np
import jax
import jax.numpy as jnp

from ..config import EPS64
from ..scales import (process_scales, process_fs_and_t, infer_scaletype,
                      logscale_transition_idx)
from ..utils.common import WARN, NOTE, assert_is_one_of
from ..utils.pad import p2up
from ..wavelets.base import Wavelet
from ..wavelets.props import center_frequency

__all__ = ["plan_reassignment", "ssqueeze", "reassign", "compute_associated_frequencies",
           "ssq_freqrange"]



# -- binning parameter planning (host) ------------------------------------------
def _ensure_nonzero(name, x, silent=False):
    if x < EPS64:
        if not silent:
            WARN(f"computed `{name}` ({x:.2e}) is below EPS64; will set to "
                 "EPS64. Advised to check `ssq_freqs`.")
        x = EPS64
    return x


def bin_params(ssq_freqs, logscale: bool):
    """Closed-form bin-mapping constants (reference: algos.py:356-374)."""
    v = np.asarray(ssq_freqs).squeeze()
    if logscale:
        idx = logscale_transition_idx(v)
        vlmin = float(np.log2(v[0]))
        if idx is None:
            dvl = _ensure_nonzero("dvl", float(np.log2(v[1]) - np.log2(v[0])))
            return "log", dict(vlmin=vlmin, dvl=dvl)
        vlmin0, vlmin1 = vlmin, float(np.log2(v[idx - 1]))
        dvl0 = _ensure_nonzero("dvl0", float(np.log2(v[1]) - np.log2(v[0])),
                               silent=True)
        dvl1 = _ensure_nonzero("dvl1", float(np.log2(v[idx]) -
                                             np.log2(v[idx - 1])))
        return "log-piecewise", dict(vlmin0=vlmin0, vlmin1=vlmin1, dvl0=dvl0,
                                     dvl1=dvl1, idx1=idx - 1)
    dv = _ensure_nonzero("dv", float(v[1] - v[0]))
    return "lin", dict(vmin=float(v[0]), dv=dv)


def plan_reassignment(ssq_freqs, na, ssq_logscale, *, transform="cwt",
                      cwt_scaletype=None, nv=None, scales=None):
    """Shared reassignment planning (reference: ssqueezing.py:124-134 +
    algos.py:356-374): the normalization constant per scale row and the
    analytic bin-mapping plan. Single source of truth for ssqueeze(),
    the chunked_* transforms and the native oracle.

    Returns (const_arr (na,) float64, mode, params_host)."""
    if transform == "cwt":
        if cwt_scaletype[:3] == "log":
            const = np.log(2) / nv
        else:
            const = ((scales[1] - scales[0]) / scales).squeeze()
    else:
        const = float(np.asarray(ssq_freqs)[1] - np.asarray(ssq_freqs)[0])
    const_arr = np.broadcast_to(
        np.asarray(const, dtype=np.float64).squeeze(), (na,)).copy()
    mode, params_host = bin_params(ssq_freqs, ssq_logscale)
    return const_arr, mode, params_host


# -- the reassignment kernel (traced) -------------------------------------------
def _bin_index(w, mode, params, omax):
    """Analytic bin of phase value `w` (reference: algos.py:172-250)."""
    if mode == "log":
        k = jnp.round(jnp.maximum(
            (jnp.log2(w) - params["vlmin"]) / params["dvl"], 0.0))
        k = jnp.minimum(k, omax)
    elif mode == "log-piecewise":
        wl = jnp.log2(w)
        k_hi = jnp.minimum(
            jnp.round((wl - params["vlmin1"]) / params["dvl1"])
            + params["idx1"], omax)
        k_lo = jnp.maximum(
            jnp.round((wl - params["vlmin0"]) / params["dvl0"]), 0.0)
        k = jnp.where(wl > params["vlmin1"], k_hi, k_lo)
    else:  # lin
        k = jnp.round(jnp.maximum((w - params["vmin"]) / params["dv"], 0.0))
        k = jnp.minimum(k, omax)
    return k.astype(jnp.int32)


def phase_bin(Wx, w_or_dWx, const_arr, gamma, Sfs, params, *, mode, flipud,
              fused, transform, nf):
    """(k, vals): the bin k(i, j) of each entry and the value
    Wx[i, j]*const[i] the scatter adds there (0 for skipped entries).
    Arguments as `reassign`."""
    omax = nf - 1
    with jax.named_scope("ssq_phase_bin"):
        if fused:
            from .phase import _imag_ratio_over_2pi
            ratio = _imag_ratio_over_2pi(Wx, w_or_dWx)
            if transform == "stft":
                w = jnp.abs(Sfs[:, None] - ratio)
            else:
                w = jnp.abs(ratio)
            mask = jnp.abs(Wx) > gamma
        else:
            w = w_or_dWx
            mask = ~jnp.isinf(w)

        wsafe = jnp.where(mask, w, 1.0)
        k = _bin_index(wsafe, mode, params, omax)
        if flipud:
            k = omax - k

        vals = jnp.where(mask, Wx * const_arr[:, None].astype(Wx.dtype), 0.0)
        k = jnp.where(mask, k, 0)
    return k, vals


@partial(jax.jit, static_argnames=("mode", "flipud", "fused", "transform",
                                   "nf"))
def reassign(Wx, w_or_dWx, const_arr, gamma, Sfs, params, *, mode, flipud,
             fused, transform, nf):
    """Scatter Wx[i,j]*const[i] into Tx[k(i,j), j].

    Wx: (..., na, n). Returns Tx (..., nf, n). `params` is a dict of traced
    scalars. Fused: w_or_dWx is dWx and the phase transform is computed
    inline (skip where |Wx| <= gamma — reference semantics, algos.py:864);
    else w_or_dWx is the precomputed phase `w` (skip where inf).
    """
    na, n = Wx.shape[-2], Wx.shape[-1]
    k, vals = phase_bin(Wx, w_or_dWx, const_arr, gamma, Sfs, params,
                        mode=mode, flipud=flipud, fused=fused,
                        transform=transform, nf=nf)

    # fold leading batch dims into columns: one scatter for everything
    batch_shape = Wx.shape[:-2]
    B = int(np.prod(batch_shape, dtype=np.int64)) if batch_shape else 1
    vals2 = jnp.moveaxis(vals.reshape((B, na, n)), 0, -1).reshape(na, n * B)
    k2 = jnp.moveaxis(k.reshape((B, na, n)), 0, -1).reshape(na, n * B)
    cols = jnp.arange(n * B, dtype=jnp.int32)[None, :]

    with jax.named_scope("ssq_scatter"):
        Tx2 = jnp.zeros((nf, n * B), vals.dtype).at[k2, cols].add(vals2)
    Tx = jnp.moveaxis(Tx2.reshape(nf, n, B), -1, 0).reshape(
        batch_shape + (nf, n))
    return Tx


# -- associated frequencies (host planning) -------------------------------------
def _get_center_frequency(wavelet, N, maprange, dt, scale, was_padded):
    """(reference: ssqueezing.py:301-310)"""
    if was_padded:
        N = p2up(N)[0]
    kw = dict(scale=float(np.asarray(scale).squeeze()), N=N, kind=maprange)
    if maprange == "energy":
        kw["force_int"] = True
    wc = center_frequency(wavelet, **kw)
    return wc / (2 * np.pi) / dt


def ssq_freqrange(maprange, dt, N, wavelet, scales, was_padded):
    """(fm, fM) frequency range per maprange
    (reference: ssqueezing.py:228-244)."""
    if isinstance(maprange, tuple):
        fm, fM = maprange
    elif maprange == "maximal":
        dT = dt * N
        fm = 1 / dT
        fM = 1 / (2 * dt)
    elif maprange in ("peak", "energy"):
        kw = dict(wavelet=wavelet, N=N, maprange=maprange, dt=dt,
                  was_padded=was_padded)
        fm = _get_center_frequency(**kw, scale=scales[-1])
        fM = _get_center_frequency(**kw, scale=scales[0])
    return fm, fM


def _exp_fm(t, fmin, fmax):
    tmin, tmax = t.min(), t.max()
    a = (fmin**tmax / fmax**tmin) ** (1 / (tmax - tmin))
    b = fmax ** (1 / tmax) * (1 / a) ** (1 / tmax)
    return a * b**t


def compute_associated_frequencies(scales, N, wavelet, ssq_scaletype,
                                   maprange, was_padded=True, dt=1,
                                   transform="cwt"):
    """The ssq frequency grid (reference: ssqueezing.py:247-291)."""
    fm, fM = ssq_freqrange(maprange, dt, N, wavelet, scales, was_padded)
    na = len(scales)

    if ssq_scaletype == "log":
        return fm * np.power(fM / fm, np.arange(na) / (na - 1))
    elif ssq_scaletype == "log-piecewise":
        idx = logscale_transition_idx(scales)
        if idx is None:
            return fm * np.power(fM / fm, np.arange(na) / (na - 1))
        f0, f2 = fm, fM
        f1 = _get_center_frequency(wavelet, N, maprange, dt, scales[idx],
                                   was_padded)
        t1 = np.arange(0, na - idx - 1) / (na - 1)
        t2 = np.arange(na - idx - 1, na) / (na - 1)
        t1 = np.hstack([t1, t2[0]])
        sqf1 = _exp_fm(t1, f0, f1)[:-1]
        sqf2 = _exp_fm(t2, f1, f2)
        ssq_freqs = np.hstack([sqf1, sqf2])
        ssq_idx = logscale_transition_idx(ssq_freqs)
        if ssq_idx is None:
            raise Exception("couldn't find logscale transition index of "
                            "generated `ssq_freqs`")
        assert (na - ssq_idx) == idx, f"{na - ssq_idx} != {idx}"
        return ssq_freqs
    else:
        if transform == "cwt":
            return np.linspace(fm, fM, na)
        return np.linspace(0, 0.5, na) / dt


# -- argument checking (host) ---------------------------------------------------
def check_ssqueezing_args(squeezing, maprange=None, wavelet=None,
                          difftype=None, difforder=None, get_w=None,
                          transform="cwt"):
    """(reference: ssqueezing.py:314-368)"""
    if transform not in ("cwt", "stft"):
        raise ValueError(f"`transform` must be one of: cwt, stft (got "
                         f"{transform})")
    if not isinstance(squeezing, (str, FunctionType)):
        raise TypeError(f"`squeezing` must be string or function "
                        f"(got {type(squeezing)})")
    if isinstance(squeezing, str):
        assert_is_one_of(squeezing, "squeezing", ("sum", "lebesgue", "abs"))

    if maprange is not None:
        if isinstance(maprange, (tuple, list)):
            if not all(isinstance(m, (float, int)) for m in maprange):
                raise ValueError("all elements of `maprange` must be float "
                                 "or int")
        elif isinstance(maprange, str):
            assert_is_one_of(maprange, "maprange",
                             ("maximal", "peak", "energy"))
        else:
            raise TypeError(f"`maprange` must be str, tuple, or list "
                            f"(got {type(maprange)})")
        if isinstance(maprange, str) and maprange != "maximal":
            if transform != "cwt":
                NOTE("string `maprange` currently only functional with "
                     "`transform='cwt'`")
            elif wavelet is None:
                raise ValueError(f"maprange='{maprange}' requires `wavelet`")

    if difftype is not None:
        if difftype not in ("trig", "phase", "numeric"):
            raise ValueError("`difftype` must be one of: trig, phase, numeric"
                             f" (got {difftype})")
        elif difftype != "trig" and not get_w:
            raise ValueError("`difftype != 'trig'` requires `get_w = True`")

    if difforder is not None:
        if difftype != "numeric":
            WARN("`difforder` is ignored if `difftype != 'numeric'")
        elif difforder not in (1, 2, 4):
            raise ValueError(f"`difforder` must be one of: 1, 2, 4 "
                             f"(got {difforder})")
    elif difftype == "numeric":
        difforder = 4
    return difforder


# -- public engine --------------------------------------------------------------
def ssqueeze(Wx, w=None, ssq_freqs=None, scales=None, Sfs=None, fs=None,
             t=None, squeezing="sum", maprange="maximal", wavelet=None,
             gamma=None, was_padded=True, flipud=False, dWx=None,
             transform="cwt"):
    """Synchrosqueeze a CWT or STFT (reference parity: ssqueezing.py:13-224).

    Returns (Tx, ssq_freqs). When `w` is None the fused path is used
    (phase + bin + scatter in one program), requiring `dWx` and `gamma`.

    NOTE (reference-parity semantics, ssqueezing.py:197-205): with
    squeezing='lebesgue'/'abs'/callable and `w=None`, the phase transform
    is derived from the TRANSFORMED Wx — exactly as the reference's fused
    `ssqueeze_fast` does. Pass `get_w=True` upstream (two-step path) to
    compute phases from the original Wx.
    """
    if w is None and (dWx is None or gamma is None):
        raise ValueError("if `w` is None, `dWx` and `gamma` must not be.")
    if isinstance(w, np.ndarray) and (w < 0).any():
        # reference guard (ssqueezing.py): log2 of a negative phase value
        # would NaN-corrupt bin indices silently. Checked for concrete
        # host arrays only — traced/device `w` comes from our own
        # phase transforms, which emit |.| (non-negative) by design.
        raise ValueError("found negatives in `w`")
    check_ssqueezing_args(squeezing, maprange, transform=transform,
                          wavelet=wavelet)
    if scales is None and transform == "cwt":
        raise ValueError("`scales` can't be None if `transform == 'cwt'`")

    Wx = jnp.asarray(Wx)
    N = Wx.shape[-1]
    dt, _, _ = process_fs_and_t(fs, t, N)

    if transform == "cwt":
        scales, cwt_scaletype, _, nv = process_scales(scales, N,
                                                      get_params=True)
    else:
        cwt_scaletype, nv = None, None

    # ssq_freqs & scaletype
    if not isinstance(ssq_freqs, (np.ndarray, jnp.ndarray)):
        if isinstance(ssq_freqs, str):
            ssq_scaletype = ssq_freqs
        else:
            ssq_scaletype = cwt_scaletype
        if ((maprange == "maximal" or isinstance(maprange, tuple)) and
                ssq_scaletype == "log-piecewise"):
            raise ValueError("can't have `ssq_scaletype = log-piecewise` or "
                             "tuple with `maprange = 'maximal'` "
                             f"(got {maprange})")
        wavelet_b = Wavelet.build(wavelet) if wavelet is not None else None
        ssq_freqs = compute_associated_frequencies(
            scales, N, wavelet_b, ssq_scaletype, maprange, was_padded, dt,
            transform)
    elif transform == "stft":
        ssq_scaletype = "linear"
        ssq_freqs = np.asarray(ssq_freqs)
    else:
        ssq_freqs = np.asarray(ssq_freqs)
        ssq_scaletype, _ = infer_scaletype(ssq_freqs)

    # squeezing transform of Wx
    if isinstance(squeezing, FunctionType):
        Wx = squeezing(Wx)
    elif squeezing == "lebesgue":
        # documented divergence: normalize by the SCALE count (shape[-2])
        # for any batch shape. The reference's `ones/len(Wx)` divides by
        # the row count of whatever 2D slice it loops (ssqueezing.py:199),
        # which for its 3D batch loop is still n_scales — ours keeps
        # batched == per-signal results (verified in tests)
        Wx = jnp.ones(Wx.shape, dtype=Wx.dtype) / Wx.shape[-2]
    elif squeezing == "abs":
        Wx = jnp.abs(Wx).astype(Wx.dtype)

    na = Wx.shape[-2]
    const_arr, mode, params_host = plan_reassignment(
        ssq_freqs, na, ssq_scaletype.startswith("log"), transform=transform,
        cwt_scaletype=cwt_scaletype, nv=nv, scales=scales)

    rdtype = jnp.float64 if Wx.dtype == jnp.complex128 else jnp.float32
    Sfs_arr = (jnp.asarray(Sfs, dtype=rdtype) if Sfs is not None else
               jnp.zeros((na,), rdtype))
    fused = w is None
    params = {k: (jnp.asarray(v) if k != "idx1" else
                  jnp.asarray(v, jnp.int32))
              for k, v in params_host.items()}
    w_or_dWx = dWx if fused else w
    gamma_val = jnp.asarray(gamma if gamma is not None else 0.0,
                            dtype=rdtype)
    Tx = reassign(Wx, jnp.asarray(w_or_dWx), jnp.asarray(const_arr, rdtype),
                  gamma_val, Sfs_arr, params, mode=mode, flipud=flipud,
                  fused=fused, transform=transform, nf=len(ssq_freqs))

    # `scales` go high -> low (reference: ssqueezing.py:217-223)
    if (transform == "cwt" and not flipud) or flipud:
        ssq_freqs = ssq_freqs[::-1]
    return Tx, ssq_freqs
