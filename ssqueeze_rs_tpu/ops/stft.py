"""Short-Time Fourier Transform, forward & inverse.

Design (vs reference old/ssqueezepy/_stft.py + utils/stft_utils.py):
  * framing is a lax.scan of grouped strided row writes (no XLA gather),
  * the windowed DFT runs as ONE full-float32 (HIGHEST) MATMUL for
    float32 and n_fft <= 2048: the window, the "modulated" per-bin
    twiddle (rfft(ifftshift(v*w))[k] = e^{2pi i k s20/n} rfft(v*w)[k])
    and the derivative-window scaling are all folded into a host-built
    DFT matrix, so non-power-of-2 n_fft (the reference benchmark's 598)
    needs no Bluestein FFT. For float64 (and large n_fft) a batched
    `rfft` path is used instead,
  * inverse uses Griffin-Lim least-squares overlap-add with window^win_exp
    and the Sigma w^(exp+1) normalization (reference: _stft.py:184-256).

Windows are host numpy constants; compiled programs are cached per
(window, n_fft, hop, flags) so matrices upload once.

Orientation matches the reference: rows = frequencies, cols = time
(Sx shape (..., n_fft//2+1, n_segs)).
"""
from __future__ import annotations

from functools import lru_cache, partial

import numpy as np
import jax
import jax.numpy as jnp

from ..config import DEFAULTS
from ..scales import process_fs_and_t
from ..utils.pad import padsignal
from ..utils.windows import get_window, window_norm, check_nola

__all__ = ["stft", "istft", "stft_core", "get_window", "overlap_add",
           "MATMUL_NFFT_MAX"]

MATMUL_NFFT_MAX = 2048


def frames_T_scan(xp, n_fft: int, hop_len: int):
    """framesT[..., j, i] = xp[..., j + i*hop]; built by a scan of
    GROUPED in-place row writes (contiguous reads+writes, no XLA gather;
    an unrolled n_fft-slice stack compiles for minutes). 8 rows per scan
    step, so the sequential loop runs ceil(n_fft/8) steps."""
    G = 8
    L = xp.shape[-1]
    n_segs = (L - n_fft) // hop_len + 1
    batch = xp.shape[:-1]
    # pad so every grouped read of n_segs*hop + G - 1 stays in range
    xp = jnp.pad(xp, [(0, 0)] * len(batch) + [(0, hop_len - 1 + G)])

    def rows(j):   # (..., G, n_segs) for window offsets j..j+G-1
        seg = jax.lax.dynamic_slice_in_dim(
            xp, j, n_segs * hop_len + G - 1, axis=-1)
        outs = []
        for r in range(G):
            s = jax.lax.slice_in_dim(seg, r, r + n_segs * hop_len,
                                     axis=-1)
            if hop_len > 1:
                s = s.reshape(batch + (n_segs, hop_len))[..., 0]
            outs.append(s)
        return jnp.stack(outs, axis=-2)

    def body(buf, g):
        buf = jax.lax.dynamic_update_slice_in_dim(
            buf, rows(g * G), g * G, axis=-2)
        return buf, None

    n_groups = -(-n_fft // G)
    # zeros_like(xp): the carry keeps xp's varying mesh axes under
    # shard_map; over-allocate to a multiple of G and trim after
    init = jnp.zeros_like(xp, shape=batch + (n_groups * G, n_segs))
    framesT, _ = jax.lax.scan(body, init, jnp.arange(n_groups))
    return framesT[..., :n_fft, :]


def _dft_matrix(window, n_fft, modulated):
    """Windowed rfft matrix W[t, k] (complex128, host)."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)
    k = np.arange(n_freqs)
    w = np.asarray(window, np.float64)
    F = np.exp(-2j * np.pi * np.outer(t, k) / n_fft)
    if modulated:
        # rfft(ifftshift(v))[k] = e^{2i pi k (n//2) / n} rfft(v)[k]
        # (floor, not ceil: ifftshift rolls by -(n//2); wrong for odd n
        # otherwise — verified numerically for n = 8, 9, 599)
        F = F * np.exp(2j * np.pi * k * (n_fft // 2) / n_fft)[None, :]
    return F * w[:, None]


@lru_cache(maxsize=128)
def _stft_program(win_bytes, dwin_bytes, n_fft, hop_len, modulated,
                  derivative, dtype_str):
    """Build & jit an STFT program with the window folded in as constants."""
    window = np.frombuffer(win_bytes, dtype=np.float64)
    diff_window = (np.frombuffer(dwin_bytes, dtype=np.float64)
                   if dwin_bytes is not None else None)
    rdtype = np.dtype(dtype_str)
    use_matmul = (rdtype == np.float32 and n_fft <= MATMUL_NFFT_MAX)

    def frames_T(xp):
        with jax.named_scope("stft_frames"):
            return frames_T_scan(xp, n_fft, hop_len)

    if use_matmul:
        # every DFT bin of every frame from one matmul over the
        # scan-built frames
        n_freqs = n_fft // 2 + 1
        F1 = _dft_matrix(window, n_fft, modulated)
        mats = [F1.real, F1.imag]              # (n_fft, n_freqs) each
        if derivative:
            F2 = _dft_matrix(diff_window, n_fft, modulated)
            mats += [F2.real, F2.imag]
        # keep as numpy: converting inside `run` avoids tracer leaks when
        # the program is built within an outer jit trace
        K_np = np.concatenate(mats, axis=1).astype(rdtype)  # (n_fft, k*nf)
        K_T_np = np.ascontiguousarray(K_np.T)               # (k*nf, n_fft)

        @jax.jit
        def run(xp, fs):
            framesT = frames_T(xp)
            with jax.named_scope("stft_dft"):
                out = jnp.einsum("fk,...kn->...fn", jnp.asarray(K_T_np),
                                 framesT,
                                 precision=jax.lax.Precision.HIGHEST,
                                 preferred_element_type=jnp.float32)
            Sx = jax.lax.complex(out[..., 0:n_freqs, :],
                                 out[..., n_freqs:2 * n_freqs, :])
            if derivative:
                dSx = jax.lax.complex(
                    out[..., 2 * n_freqs:3 * n_freqs, :] * fs,
                    out[..., 3 * n_freqs:, :] * fs)
                return Sx, dSx
            return Sx, None
    else:
        win_np = window.astype(rdtype)
        dwin_np = diff_window.astype(rdtype) if derivative else None

        @jax.jit
        def run(xp, fs):
            framesT = frames_T(xp)              # (..., n_fft, n_segs)
            win_j = jnp.asarray(win_np)
            dwin_j = jnp.asarray(dwin_np) if derivative else None

            def _one(win, scale=None):
                fw = framesT * win[:, None]
                if modulated:
                    fw = jnp.fft.ifftshift(fw, axes=-2)
                with jax.named_scope("stft_dft"):
                    S = jnp.fft.rfft(fw, axis=-2)   # (..., n_freqs, n_segs)
                if scale is not None:
                    S = S * scale
                return S

            Sx = _one(win_j)
            if derivative:
                return Sx, _one(dwin_j, scale=fs)
            return Sx, None

    return run


def stft_core(xp, window, diff_window, fs, *, n_fft, hop_len, modulated,
              derivative):
    """STFT of an already-padded signal (time = last axis).

    `window`/`diff_window` are HOST numpy arrays (folded into the compiled
    program). Returns (Sx, dSx-or-None), shape (..., n_freqs, n_segs).
    """
    win_bytes = np.asarray(window, np.float64).tobytes()
    dwin_bytes = (np.asarray(diff_window, np.float64).tobytes()
                  if (derivative and diff_window is not None) else None)
    run = _stft_program(win_bytes, dwin_bytes, int(n_fft), int(hop_len),
                        bool(modulated), bool(derivative), str(xp.dtype))
    return run(xp, jnp.asarray(fs, dtype=xp.dtype))


def stft(x, window=None, n_fft=None, win_len=None, hop_len=1, fs=None, t=None,
         padtype="reflect", modulated=True, derivative=False, dtype=None):
    """Short-Time Fourier Transform (reference parity: _stft.py:13-181).

    `x`: array, time on last axis; arbitrary leading batch/channel dims.
    Returns `Sx` [(..., n_fft//2+1, n_hops)], plus `dSx` if `derivative`.

    Documented divergence: `dSx` is scaled by `fs` for BOTH modulated
    and unmodulated STFTs (d/dt = fs * d/dn holds regardless); the
    reference multiplies the derivative window by fs only inside its
    `if modulated:` branch (_stft.py:305-308), leaving the unmodulated
    derivative in per-sample units.
    """
    x = jnp.asarray(x)
    N = x.shape[-1]
    _, fs, _ = process_fs_and_t(fs, t, N)
    n_fft = int(n_fft or min(N // hop_len, 512))

    if win_len is None:
        win_len = (len(window) if isinstance(window, (np.ndarray, jnp.ndarray))
                   else n_fft)
    dtype = dtype or DEFAULTS["dtype"]
    window, diff_window = get_window(window, win_len, n_fft, derivative=True,
                                     dtype=dtype)
    check_nola(window, hop_len)

    x = x.astype(dtype)
    padlength = N + n_fft - 1
    xp = padsignal(x, padtype, padlength=padlength)

    Sx, dSx = stft_core(xp, window, diff_window, fs, n_fft=n_fft,
                        hop_len=hop_len, modulated=modulated,
                        derivative=derivative)
    return (Sx, dSx) if derivative else Sx


def overlap_add(xbuf, window, hop_len: int, n_fft: int, out_len: int,
                win_exp: int = 1):
    """Overlap-add columns of xbuf (..., n_fft, n_segs) into (..., out_len).

    Implemented as a lax.scan of n_fft strided row adds: sample positions
    t + i*hop (i over frames) form ONE contiguous column of the output
    viewed as (G, hop) — so each scan step is a dynamic-slice add, never
    an XLA scatter. Fixed t order => deterministic.
    Reference: utils/stft_utils.py:141-181.
    """
    if win_exp == 0:
        w = jnp.ones_like(window)
    elif win_exp == 1:
        w = window
    else:
        w = window ** win_exp
    batch = xbuf.shape[:-2]
    n_segs = xbuf.shape[-1]
    v = (xbuf * w[:, None]).reshape((-1, n_fft, n_segs))
    B = v.shape[0]
    hop = int(hop_len)

    if hop == 1:
        # grouped: combine 8 window offsets in registers, one slice-add
        # per group (the 1-row scan's per-step overhead dominated)
        G8 = 8
        n_groups = -(-n_fft // G8)
        pad_rows = n_groups * G8 - n_fft
        if pad_rows:
            v = jnp.pad(v, ((0, 0), (0, pad_rows), (0, 0)))
        Lacc = n_segs + G8 - 1
        Lpad = n_groups * G8 + n_segs + G8
        out = jnp.zeros_like(v, shape=(B, Lpad))   # v's mesh axes

        def body(out, g):
            t0 = g * G8
            rows8 = jax.lax.dynamic_slice_in_dim(v, t0, G8, axis=-2)
            acc = sum(jnp.pad(rows8[:, r, :], ((0, 0), (r, G8 - 1 - r)))
                      for r in range(G8))
            cur = jax.lax.dynamic_slice(out, (0, t0), (B, Lacc))
            out = jax.lax.dynamic_update_slice(out, cur + acc, (0, t0))
            return out, None

        out, _ = jax.lax.scan(body, out, jnp.arange(n_groups))
        return out[..., :out_len].reshape(batch + (out_len,))

    G = (n_fft - 1) // hop + n_segs + 1
    out2 = jnp.zeros_like(v, shape=(B, G, hop))

    def body(carry, t):
        vt = jax.lax.dynamic_index_in_dim(v, t, axis=1, keepdims=False)
        g0 = t // hop
        r = t % hop
        cur = jax.lax.dynamic_slice(carry, (0, g0, r), (B, n_segs, 1))
        carry = jax.lax.dynamic_update_slice(carry, cur + vt[:, :, None],
                                             (0, g0, r))
        return carry, None

    out2, _ = jax.lax.scan(body, out2, jnp.arange(n_fft))
    return out2.reshape((B, G * hop))[..., :out_len].reshape(
        batch + (out_len,))


@lru_cache(maxsize=64)
def _irfft_mats(n_fft: int, modulated: bool):
    """Host matrices for irfft(+fftshift) as one real matmul:
    xbuf[t] = sum_k Fr[t,k]*Re(Sx[k]) - Fs[t,k]*Im(Sx[k]).
    Keeps non-power-of-2 n_fft (the reference benchmark's 598) off
    the Bluestein FFT path."""
    n_freqs = n_fft // 2 + 1
    t = np.arange(n_fft)
    # fftshift rolls by +(n//2): out[t] = in[(t - n//2) % n], i.e. source
    # index (t + (n+1)//2) % n — ceil, wrong for odd n otherwise
    tsrc = (t + (n_fft + 1) // 2) % n_fft if modulated else t
    k = np.arange(n_freqs)
    wgt = np.full(n_freqs, 2.0)
    wgt[0] = 1.0
    if n_fft % 2 == 0:
        wgt[-1] = 1.0
    ang = 2 * np.pi * np.outer(tsrc, k) / n_fft
    Fr = (np.cos(ang) * wgt / n_fft).astype(np.float32)
    Fs = (np.sin(ang) * wgt / n_fft).astype(np.float32)
    return Fr, Fs


@partial(jax.jit, static_argnames=("n_fft", "hop_len", "N", "modulated",
                                   "win_exp"))
def istft_core(Sx, window, wn, *, n_fft, hop_len, N, modulated, win_exp):
    with jax.named_scope("istft_irfft"):
        if Sx.dtype == jnp.complex64 and n_fft <= MATMUL_NFFT_MAX:
            Fr_np, Fs_np = _irfft_mats(n_fft, modulated)
            xbuf = (jnp.einsum("tk,...kn->...tn", jnp.asarray(Fr_np),
                               Sx.real,
                               precision=jax.lax.Precision.HIGHEST) -
                    jnp.einsum("tk,...kn->...tn", jnp.asarray(Fs_np),
                               Sx.imag,
                               precision=jax.lax.Precision.HIGHEST))
        else:
            xbuf = jnp.fft.irfft(Sx, n=n_fft, axis=-2)
            if modulated:
                xbuf = jnp.fft.fftshift(xbuf, axes=-2)

    with jax.named_scope("istft_overlap_add"):
        x = overlap_add(xbuf, window, hop_len, n_fft, N + n_fft - 1,
                        win_exp)

    tiny = jnp.finfo(x.dtype).tiny
    x = jnp.where(wn > tiny, x / jnp.where(wn > tiny, wn, 1), x)

    # unpad: x[n_fft//2 : -(n_fft-1)//2]
    return x[..., n_fft // 2: (N + n_fft - 1) - (n_fft - 1) // 2]


def istft(Sx, window=None, n_fft=None, win_len=None, hop_len=1, N=None,
          modulated=True, win_exp=1):
    """Inverse STFT, Griffin-Lim least-squares for win_exp=1
    (reference parity: _stft.py:184-256). Supports leading batch dims."""
    Sx = jnp.asarray(Sx)
    n_fft = int(n_fft or (Sx.shape[-2] - 1) * 2)
    win_len = int(win_len or n_fft)
    N = int(N or hop_len * Sx.shape[-1])
    dtype = "float32" if Sx.dtype == jnp.complex64 else "float64"

    window = get_window(window, win_len, n_fft=n_fft, dtype=dtype)
    check_nola(window, hop_len)
    wn = window_norm(window, hop_len, n_fft, N, win_exp)
    return istft_core(Sx, jnp.asarray(window), jnp.asarray(wn), n_fft=n_fft,
                      hop_len=hop_len, N=N, modulated=modulated,
                      win_exp=win_exp)
