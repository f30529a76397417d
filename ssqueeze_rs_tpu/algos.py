"""Reference `algos` public API (old/ssqueezepy/algos.py), in jnp.

The reference's hot-loop library exposes numba/CUDA kernel entry points
(`indexed_sum`, `indexed_sum_onfly`, `ssqueeze_fast`, the phase
kernels, `find_closest`, ...). In this framework those loops are
vectorized jnp programs (ops/ssqueeze.py, ops/phase.py); this module
provides the
reference's NAMES with its exact semantics so a reference user can
call the kernel layer directly.

Divergences (single JAX backend, functional arrays):
  * `out=` arguments are accepted but results are RETURNED, not written
    in place (JAX arrays are immutable); `out` values are ignored.
  * `parallel=` is accepted and ignored (XLA owns parallelization —
    reference toggle algos.py:22-29 / configs.py:127-139).
  * `_cpu`/`_gpu` pairs collapse to one implementation.

These entry points share the production transforms' jnp engine
(ops/ssqueeze.reassign).
"""
from __future__ import annotations

import math

import numpy as np
import jax.numpy as jnp

from .config import EPS32, EPS64
from .ops.phase import phase_cwt, phase_stft, _imag_ratio_over_2pi
from .ops.ssqueeze import bin_params, reassign
from .utils.closest import (find_closest, find_closest_brute,
                            find_closest_smart, find_closest_log,
                            find_closest_lin)
from .utils.common import (replace_at_inf_or_nan, replace_at_inf,
                           replace_at_nan, replace_at_value,
                           replace_under_abs)
from .wavelets.props import find_maximum, find_first_occurrence

__all__ = [
    "nCk", "indexed_sum", "indexed_sum_onfly", "ssqueeze_fast",
    "phase_cwt_cpu", "phase_cwt_gpu", "phase_stft_cpu", "phase_stft_gpu",
    "find_closest", "find_closest_brute", "find_closest_smart",
    "find_closest_log", "find_closest_lin",
    "replace_at_inf_or_nan", "replace_at_inf", "replace_at_nan",
    "replace_at_value", "replace_under_abs", "zero_denormals",
    "find_maximum", "find_first_occurrence",
]


def nCk(n, k):
    """n-Choose-k (reference: algos.py:13-19; float result — including
    its empty-reduce convention nCk(n, k>n) == 1.0)."""
    r = min(int(k), int(n) - int(k))
    if r < 0:
        return 1.0      # both reference reduce() products are empty
    return float(math.comb(int(n), r))


def indexed_sum(a, k, parallel=None):
    """out[k[i,j], j] += a[i,j] (reference: algos.py:22-41)."""
    a = jnp.asarray(a)
    k = jnp.asarray(k, jnp.int32)
    cols = jnp.arange(a.shape[1], dtype=jnp.int32)[None, :]
    return jnp.zeros_like(a).at[k, jnp.broadcast_to(cols, k.shape)].add(a)


def _const_arr(const, na):
    return np.broadcast_to(
        np.asarray(const, np.float64).squeeze(), (na,)).copy()


def indexed_sum_onfly(Wx, w, ssq_freqs, const=1, logscale=False,
                      flipud=False, out=None, parallel=None):
    """`indexed_sum` + analytic `find_closest` in one pass (reference:
    algos.py:153-250): Tx[k(w[i,j]), j] += Wx[i,j] * const[i], entries
    with inf `w` skipped. `k` uses the closed-form log /
    log-piecewise / linear bin maps. The output has Wx.shape rows and
    the bin clamp is len(Wx)-1 — the reference sizes `out` by Wx, not
    by ssq_freqs (_process_ssq_params, algos.py:51-58,111)."""
    Wx = jnp.asarray(Wx)
    mode, params = bin_params(ssq_freqs, bool(logscale))
    return reassign(Wx, jnp.asarray(w), jnp.asarray(_const_arr(
        const, Wx.shape[-2])), 0.0, None, dict(params), mode=mode,
        flipud=bool(flipud), fused=False, transform="cwt",
        nf=Wx.shape[-2])


def ssqueeze_fast(Wx, dWx, ssq_freqs, const, logscale=False, flipud=False,
                  gamma=None, out=None, Sfs=None, parallel=None):
    """Fused phase + bin + scatter (reference: algos.py:126-150):
    `indexed_sum`, `find_closest` and `phase_transform` in one loop.
    `Sfs=None` selects the CWT phase (|Im(dWx/Wx)|/2pi), else the STFT
    phase (|Sfs - Im(dSx/Sx)/2pi|); |Wx| <= gamma entries are skipped.
    Same engine as the production transforms (ops/ssqueeze.reassign)."""
    Wx = jnp.asarray(Wx)
    if gamma is None:
        gamma = 10 * (EPS64 if Wx.dtype == jnp.complex128 else EPS32)
    mode, params = bin_params(ssq_freqs, bool(logscale))
    transform = "cwt" if Sfs is None else "stft"
    Sfs_j = None if Sfs is None else jnp.asarray(Sfs)
    # output rows / bin clamp sized by Wx, like the reference's
    # _process_ssq_params (algos.py:51-58,111)
    return reassign(Wx, jnp.asarray(dWx), jnp.asarray(_const_arr(
        const, Wx.shape[-2])), float(gamma), Sfs_j, dict(params),
        mode=mode, flipud=bool(flipud), fused=True, transform=transform,
        nf=Wx.shape[-2])


def phase_cwt_cpu(Wx, dWx, gamma, parallel=None):
    """|Im(dWx/Wx)| / 2pi, inf where |Wx| < gamma (reference:
    algos.py:706-741; the (B*C - A*D)/((C^2+D^2)*2pi) arithmetic)."""
    Wx, dWx = jnp.asarray(Wx), jnp.asarray(dWx)
    w = jnp.abs(_imag_ratio_over_2pi(Wx, dWx))
    return jnp.where(jnp.abs(Wx) < gamma, jnp.inf, w)


def phase_stft_cpu(Wx, dWx, Sfs, gamma, parallel=None):
    """|Sfs - Im(dSx/Sx)/2pi|, inf where |Sx| < gamma (reference:
    algos.py:784-815)."""
    Wx, dWx = jnp.asarray(Wx), jnp.asarray(dWx)
    w = jnp.abs(jnp.asarray(Sfs)[:, None] - _imag_ratio_over_2pi(Wx, dWx))
    return jnp.where(jnp.abs(Wx) < gamma, jnp.inf, w)


# single backend: the GPU twins are the same program (reference:
# algos.py:743-781,818-857 — cupy RawModule kernels)
phase_cwt_gpu = phase_cwt_cpu
phase_stft_gpu = phase_stft_cpu


def zero_denormals(x, parallel=None):
    """Zero values within 1000x of the dtype's smallest normal
    (reference: algos.py:593-613 — a CPU-FFT slowdown guard, kept for
    parity). numpy input is modified IN PLACE like
    the reference; JAX input returns a new array."""
    # read the dtype WITHOUT np.asarray: that would fetch a device array
    # to host and break under jit
    tiny = 1000 * np.finfo(np.dtype(str(getattr(x, "dtype", None) or
                                        np.asarray(x).dtype))).tiny
    if isinstance(x, np.ndarray):
        x[(x < tiny) & (x > -tiny)] = 0
        return x
    x = jnp.asarray(x)
    return jnp.where((x < tiny) & (x > -tiny), 0, x)
