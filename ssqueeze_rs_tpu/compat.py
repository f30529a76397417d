"""Drop-in compatibility layer for the reference's `ssqueeze._rs` module.

Mirrors the exact function signatures & return conventions of the Rust
extension (reference: src/ssqueeze/_rs.pyi, rust/src/lib.rs:22-35) so code
written against `from ssqueeze import _rs` runs unchanged:

    from ssqueeze_rs_tpu import compat as _rs
    Sx, freqs = _rs.stft(x, n_fft, hop_length, window, "reflect")

Notes on fidelity (SURVEY §7.4 — reference quirks we intentionally do NOT
replicate, documented here):
  * `_rs.stft` is unmodulated and returns freqs normalized to [0, 0.5]
    (not scaled by fs) — replicated;
  * the Rust `ssq_cwt` omits the ln2/nv normalization constant and uses
    frozen wavelet params — we use correct ssqueezepy semantics, so `Tx`
    is properly normalized (diverges from the Rust bug, matches
    ssqueezepy);
  * `icwt` here is registered (the Rust one was written but never
    exported, rust/src/lib.rs:28-32) and uses numerically-integrated
    admissibility constants rather than the Rust hardcoded 0.776/1.0;
  * `cwt_simd` is an alias of `cwt` (the Rust "SIMD" variant contains no
    SIMD, rust/src/spectral/cwt_simd.rs:13-14 — here everything is
    vectorized).
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .ops.stft import stft as _stft_fn
from .ops.cwt import cwt as _cwt, icwt as _icwt
from .ops.ssq_cwt import ssq_cwt as _ssq_cwt
from .ops.ssq_stft import ssq_stft as _ssq_stft
from .utils.fft import xifn
from .utils.pad import padsignal as _padsignal
from .wavelets.base import Wavelet
from .wavelets.gmw import morsefreq

__all__ = ["hello_from_bin", "stft", "ssq_stft", "cwt", "cwt_simd",
           "ssq_cwt", "icwt", "pad_signal", "morlet", "morlet_freq",
           "morlet_time", "gmw", "gmw_freq", "gmw_time",
           "gmw_center_frequency"]


def hello_from_bin() -> str:
    return "ssqueeze_rs_tpu (JAX/XLA backend)"


def _default_rust_scales(N, nv=32):
    """Rust default: ENDPOINT-INCLUSIVE log grid 2 -> N/2 with
    ceil(octaves*nv) points and step octaves/(num-1)
    (reference: rust/src/spectral/cwt.rs:461-489) — not a fixed
    1/nv-octave ladder; the last scale lands exactly on N/2."""
    log_min, log_max = np.log2(2.0), np.log2(N * 0.5)
    na = int(np.ceil((log_max - log_min) * nv))
    if na <= 1:
        return np.array([2.0])
    step = (log_max - log_min) / (na - 1)
    return 2.0 ** (log_min + np.arange(na) * step)


def stft(x, n_fft, hop_length, window, padtype="reflect"):
    """(Sx, freqs) with freqs = linspace(0, 0.5, n_fft//2+1)
    (reference: rust/src/spectral/stft.rs:11-95; unmodulated)."""
    window = np.asarray(window)
    Sx = _stft_fn(x, window=window, n_fft=n_fft, hop_len=hop_length,
                        win_len=len(window), padtype=padtype,
                        modulated=False, dtype="float64")
    freqs = np.linspace(0, 0.5, n_fft // 2 + 1)
    return np.asarray(Sx), freqs


def ssq_stft(x, window, n_fft=None, win_len=None, hop_len=1, fs=1.0,
             padtype="reflect", squeezing="sum", gamma=None):
    """(Tx, ssq_freqs) (reference: rust/src/spectral/ssq_stft.rs:72-313)."""
    window = np.asarray(window) if window is not None else None
    Tx, Sx, ssq_freqs, Sfs = _ssq_stft(
        x, window=window, n_fft=n_fft, win_len=win_len, hop_len=hop_len,
        fs=fs, padtype=padtype, squeezing=squeezing, gamma=gamma,
        dtype="float64")
    return np.asarray(Tx), np.asarray(ssq_freqs)


def cwt(x, wavelet="gmw", scales=None, fs=None, t=None, nv=32, l1_norm=True,
        derivative=False, padtype="reflect", rpadded=False, vectorized=True,
        patience=0):
    """(Wx, scales[, dWx]) (reference: rust/src/spectral/cwt.rs:46-144).

    Default scales follow the Rust convention (log, 2 -> N/2)."""
    N = np.asarray(x).shape[-1]
    if scales is None:
        scales = _default_rust_scales(N, nv)
    out = _cwt(x, wavelet, scales=np.asarray(scales, dtype=np.float64),
               fs=fs, t=t, nv=nv, l1_norm=l1_norm, derivative=derivative,
               padtype=padtype, rpadded=rpadded, dtype="float64")
    # the Rust extension ALWAYS returns a 3-tuple — PyO3 maps the
    # Option<dWx> to None (cwt.rs:135-143); mirror that exactly
    if derivative:
        Wx, scales_out, dWx = out
        return np.asarray(Wx), np.asarray(scales_out), np.asarray(dWx)
    Wx, scales_out = out
    return np.asarray(Wx), np.asarray(scales_out), None


# the Rust "SIMD" variant is algorithmically identical (cwt_simd.rs:52-150)
cwt_simd = cwt


def ssq_cwt(x, wavelet="gmw", scales=None, fs=None, t=None, ssq_freqs=None,
            nv=32, padtype="reflect", squeezing="sum", maprange="peak",
            difftype="trig", gamma=None, vectorized=True, flipud=True):
    """(Tx, ssq_freqs) (reference: rust/src/spectral/ssq_cwt.rs:244-493)."""
    if scales is None:
        # same endpoint grid as the Rust ssq_cwt default
        # (ssq_cwt.rs:299-325 inlines generate_log_scales)
        scales = _default_rust_scales(np.asarray(x).shape[-1], nv)
    Tx, Wx, ssq_freqs_out, _ = _ssq_cwt(
        x, wavelet, scales=scales, nv=nv, fs=fs, t=t, ssq_freqs=ssq_freqs,
        padtype=padtype, squeezing=squeezing, maprange=maprange,
        difftype=difftype, gamma=gamma, flipud=flipud, dtype="float64")
    return np.asarray(Tx), np.asarray(ssq_freqs_out)


def icwt(Wx, wavelet="gmw", scales=None, nv=None, one_int=True, x_len=None,
         x_mean=0, padtype="reflect", rpadded=False, l1_norm=True):
    """(reference: rust/src/spectral/cwt.rs:552-718 — written but never
    registered in the Rust module; registered here)."""
    if scales is None:
        scales = _default_rust_scales(np.asarray(Wx).shape[-1],
                                      nv if nv else 32)
    return np.asarray(_icwt(Wx, wavelet, scales=np.asarray(scales),
                     nv=nv, one_int=one_int, x_len=x_len,
                     x_mean=x_mean, padtype=padtype, rpadded=rpadded,
                     l1_norm=l1_norm))


def pad_signal(x, padtype="reflect", padlength=None):
    """(reference: rust/src/utils/array.rs:27-49)"""
    return np.asarray(_padsignal(jnp.asarray(x), padtype,
                                 padlength=padlength))


# -- wavelet functions (reference: rust/src/wavelets/) -------------------------
def morlet(w, mu=6.0, dtype="float64"):
    wav = Wavelet.build(("morlet", {"mu": float(mu)}))
    return np.asarray(wav(np.asarray(w, dtype=dtype)))


def morlet_freq(n=1024, scale=1.0, mu=6.0, dtype="float64"):
    wav = Wavelet.build(("morlet", {"mu": float(mu)}))
    return np.asarray(wav.sample(float(scale), int(n), xp=np, nohalf=True)
                      ).astype(dtype)


def morlet_time(n=1024, scale=1.0, mu=6.0, dtype="float64"):
    wav = Wavelet.build(("morlet", {"mu": float(mu)}))
    return np.asarray(wav.psi_time(float(scale), int(n), xp=np))


def gmw(w, gamma=3.0, beta=60.0, norm="bandpass", order=0, dtype="float64"):
    wav = Wavelet.build(("gmw", dict(gamma=float(gamma), beta=float(beta),
                                     norm=norm, order=int(order))))
    return np.asarray(wav(np.asarray(w, dtype=dtype)))


def gmw_freq(n=1024, scale=1.0, gamma=3.0, beta=60.0, norm="bandpass",
             order=0, dtype="float64"):
    wav = Wavelet.build(("gmw", dict(gamma=float(gamma), beta=float(beta),
                                     norm=norm, order=int(order))))
    return np.asarray(wav.sample(float(scale), int(n), xp=np, nohalf=True)
                      ).astype(dtype)


def gmw_time(n=1024, scale=1.0, gamma=3.0, beta=60.0, norm="bandpass",
             order=0, dtype="float64"):
    wav = Wavelet.build(("gmw", dict(gamma=float(gamma), beta=float(beta),
                                     norm=norm, order=int(order))))
    return np.asarray(wav.psi_time(float(scale), int(n), xp=np))


def gmw_center_frequency(gamma=3.0, beta=60.0, kind="peak"):
    """(reference: rust/src/wavelets/gmw.rs:226-358)"""
    wm, we = morsefreq(gamma, beta, n_out=2)
    return float(wm if kind == "peak" else we)
