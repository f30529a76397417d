"""Plain float64 numpy references for the transforms.

Straightforward host implementations of the same semantics as the jnp
engines in `ops/`, written without them: numpy/scipy FFTs, an explicit
frame matrix and DFT for the STFT, and a `np.bincount` scatter for the
reassignment. They take the scales, ssq frequencies and windows a
transform returns as inputs, and derive the rest of the reassignment's
plan themselves in closed form (per-row weights from the scales, bins
as the nearest frequency-grid point), so a comparison checks the
program's reassignment planning as well as its device computation.
Used by `chip_smoke.py` and the tests; large transforms are computed in
row blocks to bound host memory.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from scipy import fft as sfft

__all__ = ["reflect_pad", "p2up_pad", "filterbank", "cwt", "bin_index",
           "reassign", "ssq_cwt_plan", "ssq_cwt", "column_marginal_err",
           "max_rel_err", "stft", "istft"]


_NP_PAD = {"reflect": "reflect", "symmetric": "symmetric",
           "replicate": "edge", "wrap": "wrap", "zero": "constant"}


def reflect_pad(x, n1, n2, padtype="reflect"):
    """Pad the last axis by (n1, n2); reflect = no edge repeat."""
    x = np.asarray(x)
    return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(n1, n2)],
                  mode=_NP_PAD[padtype])


def p2up_pad(N):
    """(M, n1): the centered power-of-2 pad of the reference
    (old/ssqueezepy/utils/common.py:32-51): M = 2**(1 + round(log2 N))."""
    M = int(2 ** (1 + np.round(np.log2(N))))
    return M, M - N - (M - N) // 2


def _xi(M):
    """Radian FFT grid with positive Nyquist."""
    k = np.arange(M)
    return np.where(k <= M // 2, k, k - M) * (2 * np.pi / M)


def _blocks(n, block, fn):
    """fn(i0, i1) over blocks [i0, i1) of rows or columns, on a thread
    per core (numpy and scipy.fft release the interpreter lock); fn
    writes its results in place."""
    with ThreadPoolExecutor(os.cpu_count()) as ex:
        for f in [ex.submit(fn, i0, min(i0 + block, n))
                  for i0 in range(0, n, block)]:
            f.result()


def filterbank(wavelet, scales, M, block=16):
    """psih(scale * xi) on the length-M FFT grid, (na, M) float64, with
    the Nyquist bin halved (even M)."""
    xi = _xi(M)
    scales = np.asarray(scales, np.float64).reshape(-1)
    out = np.empty((len(scales), M))

    def rows(i0, i1):
        out[i0:i1] = wavelet.psih(scales[i0:i1, None] * xi[None], np)
        if M % 2 == 0:
            out[i0:i1, M // 2] /= 2
    _blocks(len(scales), block, rows)
    return out


def cwt(x, wavelet, scales, dt=1.0, derivative=True, l1_norm=True,
        padtype="reflect", cols=None, block=8, psih=None):
    """Wx[, dWx]: (na, len(cols)) complex128 for a 1D signal, padded
    (`padtype`) to the reference's power of 2, or unpadded for None.
    `cols` (a slice of the signal's columns) limits the output; rows are
    computed `block` at a time. `psih` may pass a precomputed
    `filterbank` for the padded length."""
    x = np.asarray(x, np.float64)
    N = x.shape[-1]
    M, n1 = p2up_pad(N) if padtype is not None else (N, 0)
    c0, c1, _ = (cols or slice(0, N)).indices(N)
    keep = slice(n1 + c0, n1 + c1)
    xh = sfft.fft(reflect_pad(x, n1, M - N - n1, padtype or "zero"))
    dxi = 1j * _xi(M) / dt
    scales = np.asarray(scales, np.float64).reshape(-1)
    Wx = np.empty((len(scales), c1 - c0), np.complex128)
    dWx = np.empty_like(Wx) if derivative else None

    def rows(i0, i1):
        sc = scales[i0:i1, None]
        p = psih[i0:i1] if psih is not None else filterbank(
            wavelet, sc, M, i1 - i0)
        z = p * xh[None]
        if not l1_norm:
            z *= np.sqrt(sc)
        Wx[i0:i1] = sfft.ifft(z, workers=1)[:, keep]
        if derivative:
            z *= dxi
            dWx[i0:i1] = sfft.ifft(z, workers=1, overwrite_x=True)[:, keep]
    _blocks(len(scales), block, rows)
    return (Wx, dWx) if derivative else Wx


def bin_index(w, grid, log):
    """Index of the point of the ascending `grid` nearest to `w` (int64),
    measured in log2 when `log`, else linearly; values beyond either end
    go to the end point. The bin edges are the midpoints between
    neighbouring grid points."""
    g = np.asarray(grid, np.float64)
    if log:
        with np.errstate(divide="ignore", invalid="ignore"):
            w, g = np.log2(w), np.log2(g)
    return np.searchsorted((g[1:] + g[:-1]) / 2, w).astype(np.int64)


def reassign(Wx, dWx, const, gamma, grid, log, flipud, Sfs=None, k=None,
             block=4096):
    """Tx (nf, n) = sum over rows of Wx*const scattered to bin k(i, j),
    the point of the ascending frequency `grid` (nf points) nearest to
    the phase frequency (`bin_index`); `flipud` reverses the bins.

    CWT phase |Im(dWx/Wx)|/2pi, or |Sfs - Im(dSx/Sx)/2pi| when `Sfs` is
    given; entries with |Wx| <= gamma are skipped. Returns (Tx, k); pass
    `k` back to scatter new values through a frozen bin map. Columns are
    independent, so they are done `block` at a time."""
    Wx = np.asarray(Wx, np.complex128)
    dWx = None if k is not None else np.asarray(dWx, np.complex128)
    na, n = Wx.shape
    nf = len(grid)
    if np.any(np.diff(grid) <= 0):
        raise ValueError("`grid` must be ascending")
    const = np.asarray(const, np.float64)[:, None]
    Sfs = None if Sfs is None else np.asarray(Sfs, np.float64)[:, None]
    Tx = np.empty((nf, n), np.complex128)
    K = np.empty((na, n), np.int64) if k is None else k

    def cols(j0, j1):
        W = Wx[:, j0:j1]
        if k is None:
            dW = dWx[:, j0:j1]
            mag2 = W.real ** 2 + W.imag ** 2
            with np.errstate(divide="ignore", invalid="ignore"):
                w = (dW.imag * W.real - dW.real * W.imag) / (mag2 * 2 * np.pi)
            w = np.abs(Sfs - w) if Sfs is not None else np.abs(w)
            mask = np.abs(W) > gamma
            kb = bin_index(np.where(mask, w, 1.0), grid, log)
            if flipud:
                kb = nf - 1 - kb
            K[:, j0:j1] = np.where(mask, kb, -1)
        kb = K[:, j0:j1]
        vals = np.where(kb >= 0, W * const, 0)
        m = j1 - j0
        flat = (np.maximum(kb, 0) * m + np.arange(m)[None]).ravel()
        Tx[:, j0:j1] = (np.bincount(flat, vals.real.ravel(), nf * m) + 1j *
                        np.bincount(flat, vals.imag.ravel(), nf * m)
                        ).reshape(nf, m)
    _blocks(n, block, cols)
    return Tx, K


def ssq_cwt_plan(ssq_freqs_out, scales):
    """(const, grid, log) of the ssq_cwt reassignment, in closed form from
    the transform's returned ssq_freqs (descending) and scales: the
    ascending frequency grid, whether it is spaced in log (else
    linearly), and the per-row weight of the scale integral
    (ssqueezepy ssqueezing.py:124-134): d ln(scale) on a log grid
    (each row's own step, the first row taking the second's), else
    d(scale) / scale."""
    grid = np.asarray(ssq_freqs_out, np.float64)[::-1]
    s = np.asarray(scales, np.float64).reshape(-1)
    step = np.diff(grid)
    log = not np.allclose(step, step[0], rtol=1e-6, atol=0)
    if log:
        d = np.abs(np.diff(np.log(s)))
        const = np.concatenate([d[:1], d])
    else:
        const = np.abs(s[1] - s[0]) / s
    return const, grid, log


def ssq_cwt(x, scales, ssq_freqs_out, gamma, wavelet="gmw", cols=None,
            psih=None):
    """(Wx, dWx, Tx, k) of a 1D signal: the float64 counterpart of
    `ops.ssq_cwt` (trig phase, sum squeezing, flipud) on the given
    scales and returned ssq_freqs."""
    from .wavelets.base import Wavelet
    wav = Wavelet.build(wavelet)
    Wx, dWx = cwt(x, wav, scales, cols=cols, psih=psih)
    const, grid, log = ssq_cwt_plan(ssq_freqs_out, scales)
    Tx, k = reassign(Wx, dWx, const, gamma, grid, log, flipud=True)
    return Wx, dWx, Tx, k


def column_marginal_err(Tx, Tx_ref):
    """max_j |sum_i Tx[i, j] - sum_i Tx_ref[i, j]| / max_j |sum_i Tx_ref|.
    The column sums do not depend on which bin a value lands in, so this
    compares the reassigned mass without the last-bit bin decisions."""
    m = np.asarray(Tx).sum(axis=-2)
    m_ref = np.asarray(Tx_ref).sum(axis=-2)
    return float(np.abs(m - m_ref).max() / np.abs(m_ref).max())


def max_rel_err(a, ref):
    """max |a - ref| / max |ref|."""
    a, ref = np.asarray(a), np.asarray(ref)
    return float(np.abs(a - ref).max() / np.abs(ref).max())


def stft(x, window, n_fft, hop_len=1, fs=1.0, diff_window=None,
         modulated=True, block=8192):
    """Sx[, dSx]: (n_fft//2+1, (N-1)//hop_len + 1) complex128; reflect pad
    to N + n_fft - 1 (left ceil((n_fft-1)/2)), one frame every `hop_len`
    samples, frames ifftshifted when `modulated`; dSx uses `diff_window`
    scaled by fs."""
    x = np.asarray(x, np.float64)
    n2 = (n_fft - 1) // 2
    xp = reflect_pad(x, n_fft - 1 - n2, n2)
    frames = np.lib.stride_tricks.sliding_window_view(xp, n_fft)[::hop_len]
    N = frames.shape[0]
    wins = [np.asarray(window, np.float64)]
    if diff_window is not None:
        wins.append(np.asarray(diff_window, np.float64))
    outs = [np.empty((n_fft // 2 + 1, N), np.complex128) for _ in wins]
    for j0 in range(0, N, block):
        f = frames[j0:j0 + block]
        for o, w in zip(outs, wins):
            fw = f * w
            if modulated:
                fw = np.fft.ifftshift(fw, axes=-1)
            o[:, j0:j0 + block] = sfft.rfft(fw, axis=-1, workers=-1).T
    if diff_window is None:
        return outs[0]
    return outs[0], outs[1] * fs


def istft(Sx, window, n_fft, N, hop_len=1, modulated=True):
    """Least-squares inverse: irfft each frame, window it, overlap-add at
    `hop_len`, divide by the overlapped sum of window**2, drop the pad."""
    w = np.asarray(window, np.float64)
    frames = sfft.irfft(np.asarray(Sx, np.complex128), n=n_fft, axis=0,
                        workers=-1)
    if modulated:
        frames = np.fft.fftshift(frames, axes=0)
    n_frames = frames.shape[1]
    L = max(N, (n_frames - 1) * hop_len + 1) + n_fft - 1
    x = np.zeros(L)
    norm = np.zeros(L)
    for t in range(n_fft):
        end = t + (n_frames - 1) * hop_len + 1
        x[t:end:hop_len] += w[t] * frames[t]
        norm[t:end:hop_len] += w[t] ** 2
    x = np.where(norm > np.finfo(np.float64).tiny,
                 x / np.maximum(norm, np.finfo(np.float64).tiny), x)
    h = n_fft // 2
    return x[h:h + N]
