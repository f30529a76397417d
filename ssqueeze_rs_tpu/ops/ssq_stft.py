"""Synchrosqueezed STFT (forward + inverse).

Reference parity: old/ssqueezepy/_ssq_stft.py. The reassignment uses the
analytic linear-bin closed form (never the O(bins^2) argmin of
rust/src/spectral/ssq_stft.rs:280-289).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from ..config import EPS32, EPS64
from ..scales import process_fs_and_t, infer_scaletype
from ..utils.common import WARN
from ..utils.windows import get_window, check_nola
from .stft import stft
from .phase import phase_stft
from .ssqueeze import ssqueeze, check_ssqueezing_args
from .ssq_cwt import _process_component_inversion_args, _invert_components

__all__ = ["ssq_stft", "issq_stft", "make_Sfs"]


def make_Sfs(Sx, fs):
    """Row frequencies of Sx: linspace(0, fs/2, n_rows)
    (reference: _ssq_stft.py:249-257)."""
    n_rows = Sx.shape[-2]
    dtype = np.float32 if Sx.dtype == jnp.complex64 else np.float64
    return np.linspace(0, 0.5 * fs, n_rows, dtype=dtype)


def ssq_stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None,
             t=None, modulated=True, ssq_freqs=None, padtype="reflect",
             squeezing="sum", gamma=None, preserve_transform=None, dtype=None,
             astensor=True, flipud=False, get_w=False, get_dWx=False):
    """Synchrosqueezed STFT (reference parity: _ssq_stft.py:13-136).

    Returns (Tx, Sx, ssq_freqs, Sfs[, w][, dSx]).
    """
    _, fs, _ = process_fs_and_t(fs, t, jnp.shape(x)[-1])
    check_ssqueezing_args(squeezing)
    if (isinstance(ssq_freqs, (np.ndarray, jnp.ndarray)) and
            infer_scaletype(np.asarray(ssq_freqs))[0] != "linear"):
        raise ValueError("`ssq_freqs` must be linearly distributed for "
                         "`ssq_stft`")

    N = jnp.shape(x)[-1]
    n_fft = int(n_fft or min(N // hop_len, 512))
    Sx, dSx = stft(x, window, n_fft=n_fft, win_len=win_len, hop_len=hop_len,
                   fs=fs, padtype=padtype, modulated=modulated,
                   derivative=True, dtype=dtype)

    Sfs = make_Sfs(Sx, fs)
    if gamma is None:
        gamma = 10 * (EPS64 if Sx.dtype == jnp.complex128 else EPS32)

    w = phase_stft(Sx, dSx, Sfs, gamma) if get_w else None
    if ssq_freqs is None:
        ssq_freqs = Sfs
    Tx, ssq_freqs = ssqueeze(Sx, w, squeezing=squeezing, ssq_freqs=ssq_freqs,
                             Sfs=Sfs, flipud=flipud, gamma=gamma,
                             dWx=None if get_w else dSx,
                             maprange="maximal", transform="stft")

    if get_w and get_dWx:
        return Tx, Sx, ssq_freqs, Sfs, w, dSx
    elif get_w:
        return Tx, Sx, ssq_freqs, Sfs, w
    elif get_dWx:
        return Tx, Sx, ssq_freqs, Sfs, dSx
    return Tx, Sx, ssq_freqs, Sfs


def issq_stft(Tx, window=None, cc=None, cw=None, n_fft=None, win_len=None,
              hop_len=1, modulated=True):
    """Inverse synchrosqueezed STFT (reference parity: _ssq_stft.py:139-198).

    x = (2 / window[center]) * sum_rows Re(Tx); requires hop_len=1 and
    modulated STFT.

    NOTE (reference quirk, faithfully reproduced): the forward ssq_stft's
    Tx scales with `fs` (its reassignment constant is the ssq-frequency
    spacing in Hz, ssqueezing.py:134), while this inversion assumes the
    fs=1 normalization — reconstruct from a transform taken with fs=1,
    or divide the result by `fs`.
    """
    if not modulated:
        raise ValueError("inversion with `modulated == False` is unsupported.")
    if hop_len != 1:
        raise ValueError("inversion with `hop_len != 1` is unsupported.")

    cc, cw, full_inverse = _process_component_inversion_args(cc, cw)
    n_fft = int(n_fft or (jnp.shape(Tx)[-2] - 1) * 2)
    win_len = int(win_len or n_fft)

    window = get_window(window, win_len, n_fft=n_fft)
    check_nola(window, hop_len)
    if abs(np.argmax(window) - len(window) // 2) > 1:
        WARN("`window` maximum not centered; results may be inaccurate.")

    if full_inverse:
        x = jnp.asarray(Tx).real.sum(axis=-2)
    else:
        x = _invert_components(Tx, cc, cw)
    return x * (2 / window[len(window) // 2])
