"""Sharded long-signal transforms with halo exchange between devices.

Replacement for the reference's dask `map_overlap` chunking
(tests/stft_test.py:262-269, tests/ssq_cwt_test.py:185-196; SURVEY §2.4 P9):
the time axis is sharded over a mesh axis, each shard fetches
window/wavelet halo samples from its neighbors via `lax.ppermute` (two
neighbor sends), transforms its extended segment, and trims the halo.
The collectives (`ppermute`, `all_gather`, `all_to_all` under
`shard_map`) go to the device's collective library (NCCL on GPUs). Global signal edges reflect-pad locally, matching
`boundary='reflect'`.

Exactness:
  * `chunked_stft` is BIT-EXACT vs the full-signal transform: a frame only
    needs n_fft-1 neighboring samples, all provided by the halo.
  * `chunked_cwt` / `chunked_ssq_cwt` default to a HYBRID scheme
    (`exact=True`): each scale row's discrete kernel L1 tail mass beyond
    the halo is measured host-side (`overlap_save_tail_mass`); rows whose
    tail exceeds `exact_tol` cannot be computed accurately from the local
    segment, so they are recomputed from the FULL signal — an
    `all_gather` over the time axis (the signal itself is small: N
    samples vs the na*N output), the same globally-padded CWT the
    unsharded transform runs, then a local column slice. Those rows match
    the full transform to float rounding; overlap-save rows are bounded
    by their tail mass. This beats the reference, whose dask map_overlap
    silently accepts a fixed overlap for ALL scales
    (tests/cwt_test.py:186-196). Two inherent error sources make the
    global path necessary at any feasible halo: the largest scales'
    support, AND slow ~1/t kernel tails from psih truncation at omega=pi.
    With `exact=False`: pure overlap-save, measured on N=4096/8 shards
    max rel err 0.14 (halo=64) -> 0.055 (halo=448).

Reassignment is column-local (each time column scatters independently,
reference algos.py:183-192), so synchrosqueezing after halo-trim is exact
given the CWT columns.
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..config import DEFAULTS, EPS32, EPS64
from ..scales import process_scales, process_fs_and_t
from ..utils.pad import pad_params
from ..utils.windows import get_window, window_norm, check_nola
from ..wavelets.base import Wavelet
from ..wavelets.props import time_resolution
from ..ops.stft import stft_core
from ..ops.cwt import cwt_core
from ..ops.ssqueeze import (compute_associated_frequencies,
                            plan_reassignment, reassign)

__all__ = ["chunked_stft", "chunked_cwt", "chunked_ssq_cwt",
           "chunked_ssq_stft", "chunked_istft", "chunked_icwt",
           "chunked_issq_cwt", "chunked_issq_stft", "default_cwt_halo",
           "halo_extend", "overlap_save_tail_mass"]


def shard_map(f, mesh, in_specs, out_specs):
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs)


def _clip_halo(halo, S):
    """Clip a halo to the shard length; WARN when a user-meaningful halo
    is silently reduced (the overlap-save error bound loosens)."""
    H = int(min(halo, S - 1))
    if H < int(halo):
        from ..utils.common import WARN
        WARN(f"requested halo ({int(halo)}) exceeds shard length - 1 "
             f"({S - 1}); clipping to {H} — overlap-save accuracy for the "
             "largest scales degrades (use fewer/larger shards, or "
             "exact=True which globalizes the affected rows)")
    return H


def _squeeze_Wx(squeezing, Wx):
    """The squeezing transform of Wx applied before the fused scatter
    (reference ssqueezing.py:197-205 / ops/ssqueeze.py — with
    'lebesgue'/'abs' the fused phase derives from the transformed Wx,
    matching the reference's ssqueeze_fast)."""
    from types import FunctionType
    if isinstance(squeezing, FunctionType):
        return squeezing(Wx)
    if squeezing == "lebesgue":
        return jnp.ones(Wx.shape, dtype=Wx.dtype) / Wx.shape[-2]
    if squeezing == "abs":
        return jnp.abs(Wx).astype(Wx.dtype)
    return Wx


def halo_extend(xs, axis_name: str, n_shards: int, Hl: int, Hr: int,
                boundary: str = "reflect"):
    """Extend a local time shard with `Hl`/`Hr` halo samples from neighbors.
    xs: (..., S) -> (..., Hl + S + Hr). `boundary`: what the globally
    first/last shard uses where no neighbor exists — 'reflect' (signal
    pads, matching the dask scripts' boundary='reflect') or 'zero'
    (frame halos of chunked_istft: no frames exist beyond the signal)."""
    parts = [xs]
    idx = lax.axis_index(axis_name)
    if Hl > 0:
        right_perm = [(i, i + 1) for i in range(n_shards - 1)]
        left_recv = lax.ppermute(xs[..., -Hl:], axis_name, right_perm)
        edge_left = (xs[..., 1:Hl + 1][..., ::-1] if boundary == "reflect"
                     else jnp.zeros_like(left_recv))
        left = jnp.where(idx == 0, edge_left, left_recv)
        parts.insert(0, left)
    if Hr > 0:
        left_perm = [(i + 1, i) for i in range(n_shards - 1)]
        right_recv = lax.ppermute(xs[..., :Hr], axis_name, left_perm)
        edge_right = (xs[..., -Hr - 1:-1][..., ::-1]
                      if boundary == "reflect"
                      else jnp.zeros_like(right_recv))
        right = jnp.where(idx == n_shards - 1, edge_right, right_recv)
        parts.append(right)
    return jnp.concatenate(parts, axis=-1)


def _specs(ndim_in, ndim_out, axis_name, batch_axis_name=None):
    in_spec = [None] * ndim_in
    in_spec[-1] = axis_name
    out_spec = [None] * ndim_out
    out_spec[-1] = axis_name
    if batch_axis_name is not None:
        in_spec[0] = batch_axis_name
        out_spec[0] = batch_axis_name
    return P(*in_spec), P(*out_spec)


def _check_divisible(N, n_shards, what="signal length"):
    if N % n_shards:
        raise ValueError(
            f"{what} ({N}) must be divisible by the time-mesh size "
            f"({n_shards}); pad or trim the signal")


# -- STFT ------------------------------------------------------------------
def chunked_stft(x, mesh: Mesh, window=None, n_fft=None, win_len=None,
                 hop_len=1, fs=None, modulated=True, derivative=False,
                 dtype=None, axis_name="time", batch_axis_name=None):
    """Time-sharded STFT, bit-exact vs `ops.stft` (reflect padtype).

    Halo = the global centered pad split: left n_fft//2, right
    n_fft-1-n_fft//2 — every frame sees exactly the samples the
    full-signal transform sees.
    """
    x = jnp.asarray(x)
    N = x.shape[-1]
    n_shards = mesh.shape[axis_name]
    _check_divisible(N, n_shards)
    S = N // n_shards
    if S % hop_len:
        raise ValueError(f"shard length ({S}) must be divisible by hop_len "
                         f"({hop_len})")
    _, fs, _ = process_fs_and_t(fs, None, N)
    n_fft = int(n_fft or min(N // hop_len, 512))
    if win_len is None:
        win_len = (len(window)
                   if isinstance(window, (np.ndarray, jnp.ndarray))
                   else n_fft)   # same rule as ops/stft.py:251
    dtype = dtype or DEFAULTS["dtype"]
    window, diff_window = get_window(window, win_len, n_fft, derivative=True,
                                     dtype=dtype)
    x = x.astype(dtype)

    # global padlength = N + n_fft - 1 -> n1 = ceil((n_fft-1)/2)
    _, n1, n2 = pad_params(N, N + n_fft - 1)
    Hl, Hr = n1, n2
    if max(Hl, Hr) > S - 1:
        # the halo (reflect pad + frame overlap) would need samples from
        # beyond the NEIGHBOR shard; capping would break the bit-exactness
        # contract, so refuse loudly
        raise ValueError(
            f"n_fft={n_fft} needs a {max(Hl, Hr)}-sample halo but each of "
            f"the {n_shards} time shards holds only {S} samples; lower "
            f"n_fft, use fewer time shards, or process a longer signal")

    def shard_fn(xs):
        xe = halo_extend(xs, axis_name, n_shards, Hl, Hr)
        Sx, dSx = stft_core(xe, window, diff_window, float(fs), n_fft=n_fft,
                            hop_len=hop_len, modulated=modulated,
                            derivative=derivative)
        return (Sx, dSx) if derivative else Sx

    in_spec, out_spec = _specs(x.ndim, x.ndim + 1, axis_name,
                               batch_axis_name)
    out_specs = (out_spec, out_spec) if derivative else out_spec
    fn = shard_map(shard_fn, mesh, (in_spec,), out_specs)
    return fn(x)


# -- CWT ---------------------------------------------------------------------
def default_cwt_halo(wavelet: Wavelet, max_scale: float, n_std: float = 4.0,
                     N: int = 4096) -> int:
    """Halo sized from the wavelet's time std at the largest scale.

    std_t(scale) ~ scale * std_t(scale_ref)/scale_ref samples; the halo
    covers `n_std` standard deviations (the reference dask scripts use a
    fixed conservative overlap instead — SURVEY §5)."""
    sc = wavelet.scalec_ct
    std_ref = time_resolution(wavelet, scale=sc, N=N, nondim=False)
    return int(np.ceil(n_std * std_ref * max_scale / sc))


def overlap_save_tail_mass(wavelet: Wavelet, scales, halo: int, M: int):
    """Per-scale L1 mass fraction of the discrete wavelet kernel outside
    +-halo samples, at circular length M — the quantity that bounds the
    overlap-save error of a chunked CWT row (host-side numpy).

    The kernel is the ACTUAL discrete filter the transform applies
    (ifft of the truncated psih), so this captures both large-scale
    support growth and the slow sinc-like tails of near-Nyquist rows."""
    scales = np.asarray(scales, np.float64).reshape(-1)
    out = np.empty(len(scales))
    block = max(1, (1 << 22) // max(M, 1))
    pn = (-1.0) ** np.arange(M)
    c = M // 2
    lo, hi = max(0, c - halo), min(M, c + halo + 1)
    for i0 in range(0, len(scales), block):
        sc = scales[i0:i0 + block]
        psih = np.atleast_2d(wavelet.sample(sc, M, xp=np, nohalf=False))
        a = np.abs(np.fft.ifft(psih * pn, axis=-1))
        tot = np.maximum(a.sum(-1), 1e-300)
        out[i0:i0 + len(sc)] = 1.0 - a[:, lo:hi].sum(-1) / tot
    return out


_EXACT_ROWS_CACHE: dict = {}


def _exact_rows(wavelet: Wavelet, scales_arr, H: int, M_seg: int,
                tol: float):
    """(g0, g1): the longest contiguous scale-row run whose overlap-save
    tail mass is <= tol — safe to compute from local segments. Rows
    outside [g0, g1) take the replicated global-FFT path."""
    key = (wavelet, scales_arr.tobytes(), int(H), int(M_seg), float(tol))
    if key not in _EXACT_ROWS_CACHE:
        tails = overlap_save_tail_mass(wavelet, scales_arr, H, M_seg)
        ok = tails <= tol
        best = (0, 0)
        i, n = 0, len(ok)
        while i < n:
            if ok[i]:
                j = i
                while j < n and ok[j]:
                    j += 1
                if j - i > best[1] - best[0]:
                    best = (i, j)
                i = j
            else:
                i += 1
        _EXACT_ROWS_CACHE[key] = best
    return _EXACT_ROWS_CACHE[key]


def _hybrid_cwt_shard(wavelet: Wavelet, scales_arr, dt, *, l1_norm,
                      derivative, H, S, n_shards, axis_name, exact,
                      exact_tol, dtype):
    """Build the per-shard CWT function: overlap-save for rows whose
    kernel fits the halo, replicated global FFT (all_gather over the
    time axis + local column slice) for the rest. Returns
    (shard_fn(xs) -> (Wx, dWx|None), (g0, g1))."""
    na = len(scales_arr)
    Se = S + 2 * H
    n_up, p1, _ = pad_params(Se)
    N = S * n_shards
    if exact:
        g0, g1 = _exact_rows(wavelet, scales_arr, H, n_up, exact_tol)
    else:
        g0, g1 = 0, na
    scales_loc = jnp.asarray(scales_arr[g0:g1].squeeze(-1), dtype)
    sc_glob = np.concatenate([scales_arr[:g0], scales_arr[g1:]])
    nag = len(sc_glob)
    # scale-parallel global block: shard k computes rows
    # [k*nag_s, (k+1)*nag_s) of the padded global list over the FULL
    # signal, then all_to_all redistributes rows -> local columns. Pad
    # the list to a multiple of n_shards with duplicate trailing rows
    # (dropped after the exchange) so every shard does equal work.
    pad_rows = (-nag) % n_shards
    if nag:
        sc_glob_pad = np.concatenate(
            [sc_glob, np.repeat(sc_glob[-1:], pad_rows, axis=0)])
        nag_s = len(sc_glob_pad) // n_shards
        scales_glob = jnp.asarray(sc_glob_pad.squeeze(-1), dtype)
    n_upg, n1g, n2g = pad_params(N)
    dt_j = jnp.asarray(dt, dtype)
    n_bot = g0

    def shard_fn(xs):
        Wl = dl = Wg = dg = None
        if g1 > g0:
            xe = halo_extend(xs, axis_name, n_shards, H, H)
            xp = jnp.pad(xe, [(0, 0)] * (xe.ndim - 1) +
                         [(p1, n_up - Se - p1)], mode="reflect")
            ol = cwt_core(xp, scales_loc, dt_j, wavelet=wavelet,
                          derivative=derivative, l1_norm=l1_norm, N=Se,
                          n1=p1, rpadded=False)
            Wl = ol[0][..., H:H + S]
            dl = ol[1][..., H:H + S] if derivative else None
        if nag:
            # gather the (small) signal, run the SAME globally-padded
            # CWT the unsharded transform runs — but only this shard's
            # row block — then all_to_all rows -> columns. Matches the
            # full transform to float rounding; extra compute totals one
            # unsharded pass over the global rows, split n_shards ways.
            k = lax.axis_index(axis_name)
            xg = lax.all_gather(xs, axis_name, axis=xs.ndim - 1,
                                tiled=True)
            xpg = jnp.pad(xg, [(0, 0)] * (xg.ndim - 1) + [(n1g, n2g)],
                          mode="reflect")
            sc_k = lax.dynamic_slice_in_dim(scales_glob, k * nag_s, nag_s)
            og = cwt_core(xpg, sc_k, dt_j, wavelet=wavelet,
                          derivative=derivative, l1_norm=l1_norm, N=N,
                          n1=n1g, rpadded=False)

            def to_cols(W):
                # (batch, nag_s, N) -> (batch, nag_pad, S), rows in
                # source-shard-major order = original global row order
                W = lax.all_to_all(W, axis_name, split_axis=W.ndim - 1,
                                   concat_axis=W.ndim - 2, tiled=True)
                return W[..., :nag, :]

            Wg = to_cols(og[0])
            dg = to_cols(og[1]) if derivative else None

        def combine(loc, glob):
            if glob is None:
                return loc
            bot, top = glob[..., :n_bot, :], glob[..., n_bot:, :]
            parts = [p for p in (bot, loc, top)
                     if p is not None and p.shape[-2]]
            return parts[0] if len(parts) == 1 else jnp.concatenate(
                parts, axis=-2)

        Wx = combine(Wl, Wg)
        dWx = combine(dl, dg) if derivative else None
        return Wx, dWx

    return shard_fn, (g0, g1)


def _plan_cwt(x_shape, wavelet, scales, nv, fs, l1_norm=True):
    N = x_shape[-1]
    dt, fs, _ = process_fs_and_t(fs, None, N)
    wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
    scales_arr, scaletype, _, nv_out = process_scales(scales, N, wavelet,
                                                      nv=nv, get_params=True)
    return wavelet, scales_arr, scaletype, nv_out, dt, fs


def chunked_cwt(x, mesh: Mesh, wavelet="gmw", scales="log-piecewise", nv=32,
                fs=None, l1_norm=True, derivative=False, halo=None,
                exact=True, exact_tol=1e-6, dtype=None, axis_name="time",
                batch_axis_name=None):
    """Time-sharded CWT. Scales are planned from the GLOBAL signal length
    so rows match the full-signal transform (an improvement over the
    reference's per-chunk planning, tests/cwt_test.py:69-160).

    `exact=True` (default): hybrid scheme — overlap-save for rows whose
    kernel tail beyond the halo is <= `exact_tol` (L1 fraction), the
    replicated global-FFT path for the rest (see module docstring);
    `exact=False`: pure overlap-save for every row (reference dask
    semantics)."""
    x = jnp.asarray(x)
    N = x.shape[-1]
    n_shards = mesh.shape[axis_name]
    _check_divisible(N, n_shards)
    S = N // n_shards
    dtype = dtype or DEFAULTS["dtype"]
    x = x.astype(dtype)

    wavelet, scales_arr, scaletype, nv, dt, fs = _plan_cwt(
        x.shape, wavelet, scales, nv, fs, l1_norm=l1_norm)
    if halo is None:
        halo = default_cwt_halo(wavelet, float(scales_arr.max()))
    H = _clip_halo(halo, S)

    core, _ = _hybrid_cwt_shard(
        wavelet, scales_arr, dt, l1_norm=l1_norm, derivative=derivative,
        H=H, S=S, n_shards=n_shards, axis_name=axis_name, exact=exact,
        exact_tol=exact_tol, dtype=dtype)

    def shard_fn(xs):
        Wx, dWx = core(xs)
        return (Wx, dWx) if derivative else Wx

    in_spec, out_spec = _specs(x.ndim, x.ndim + 1, axis_name,
                               batch_axis_name)
    out_specs = (out_spec, out_spec) if derivative else out_spec
    fn = shard_map(shard_fn, mesh, (in_spec,), out_specs)
    out = fn(x)
    if derivative:
        return out[0], scales_arr.squeeze(), out[1]
    return out, scales_arr.squeeze()


# -- synchrosqueezed, chunked ---------------------------------------------------
def chunked_ssq_cwt(x, mesh: Mesh, wavelet="gmw", scales="log-piecewise",
                    nv=32, fs=None, maprange="peak", squeezing="sum",
                    gamma=None, flipud=True, halo=None, exact=True,
                    exact_tol=1e-6, dtype=None, axis_name="time",
                    batch_axis_name=None):
    """Time-sharded synchrosqueezed CWT.

    CWT+derivative per shard with halo exchange (hybrid global-FFT path
    for rows exceeding the halo when `exact=True` — see chunked_cwt);
    the reassignment scatter is per-time-column (reference
    algos.py:183-192), so squeezing the trimmed local columns is exact
    given local CWT columns. All planning (scales, ssq_freqs, const,
    gamma) is global so shards agree."""
    from ..ops.ssqueeze import check_ssqueezing_args

    x = jnp.asarray(x)
    N = x.shape[-1]
    n_shards = mesh.shape[axis_name]
    _check_divisible(N, n_shards)
    S = N // n_shards
    dtype = dtype or DEFAULTS["dtype"]
    x = x.astype(dtype)

    wavelet, scales_arr, scaletype, nv, dt, fs = _plan_cwt(
        x.shape, wavelet, scales, nv, fs)
    check_ssqueezing_args(squeezing, maprange, wavelet=wavelet,
                          transform="cwt")
    if ((maprange == "maximal" or isinstance(maprange, tuple)) and
            scaletype == "log-piecewise"):
        # same guard as the unsharded ssqueeze (ops/ssqueeze.py:333-337)
        raise ValueError("can't have `ssq_scaletype = log-piecewise` or "
                         f"tuple with `maprange = 'maximal'` (got "
                         f"{maprange})")
    if halo is None:
        halo = default_cwt_halo(wavelet, float(scales_arr.max()))
    H = _clip_halo(halo, S)

    # global ssq planning (reference: ssqueezing.py:124-188)
    ssq_freqs = compute_associated_frequencies(
        scales_arr, N, wavelet, scaletype, maprange, True, dt, "cwt")
    na = len(scales_arr)
    # per-row nv inferred from the scale array, as the unsharded
    # ssqueeze plans it (log-piecewise rows carry their segment's nv)
    nv_rows = process_scales(scales_arr, N, get_params=True)[3]
    const_arr, mode, params_host = plan_reassignment(
        ssq_freqs, na, scaletype.startswith("log"), transform="cwt",
        cwt_scaletype=scaletype, nv=nv_rows, scales=scales_arr)
    params = {k: (jnp.asarray(v) if k != "idx1" else
                  jnp.asarray(v, jnp.int32)) for k, v in params_host.items()}
    rdtype = jnp.float64 if dtype in ("float64", jnp.float64) else jnp.float32
    if gamma is None:
        gamma = 10 * (EPS64 if rdtype == jnp.float64 else EPS32)
    gamma_j = jnp.asarray(gamma, rdtype)
    const_j = jnp.asarray(const_arr, rdtype)
    Sfs_j = jnp.zeros((na,), rdtype)
    nf = len(ssq_freqs)

    core, _ = _hybrid_cwt_shard(
        wavelet, scales_arr, dt, l1_norm=True, derivative=True, H=H, S=S,
        n_shards=n_shards, axis_name=axis_name, exact=exact,
        exact_tol=exact_tol, dtype=dtype)

    def shard_fn(xs):
        Wx, dWx = core(xs)
        Tx = reassign(_squeeze_Wx(squeezing, Wx), dWx, const_j, gamma_j,
                      Sfs_j, params, mode=mode, flipud=flipud, fused=True,
                      transform="cwt", nf=nf)
        return Tx, Wx

    in_spec, out_spec = _specs(x.ndim, x.ndim + 1, axis_name,
                               batch_axis_name)
    fn = shard_map(shard_fn, mesh, (in_spec,), (out_spec, out_spec))
    Tx, Wx = fn(x)
    ssq_freqs_out = ssq_freqs[::-1]  # cwt convention (ssqueezing.py:217-223)
    return Tx, Wx, ssq_freqs_out, scales_arr.squeeze()


def chunked_ssq_stft(x, mesh: Mesh, window=None, n_fft=None, win_len=None,
                     hop_len=1, fs=None, squeezing="sum", gamma=None,
                     flipud=False, dtype=None, axis_name="time",
                     batch_axis_name=None):
    """Time-sharded synchrosqueezed STFT (bit-exact STFT stage; column-local
    reassignment)."""
    from ..ops.ssqueeze import check_ssqueezing_args

    check_ssqueezing_args(squeezing, transform="stft")
    x = jnp.asarray(x)
    N = x.shape[-1]
    _, fs, _ = process_fs_and_t(fs, None, N)
    dtype = dtype or DEFAULTS["dtype"]
    n_fft = int(n_fft or min(N // hop_len, 512))
    nf = n_fft // 2 + 1

    # one dtype rule for the whole plan (a string/np/jnp dtype spelling
    # must not silently change the frequency grid precision)
    rdtype = (jnp.float64 if jnp.dtype(dtype) == jnp.float64
              else jnp.float32)
    # row grid == make_Sfs(Sx, fs) of the unsharded path
    Sfs = np.linspace(0, 0.5 * fs, nf,
                      dtype=np.float64 if rdtype == jnp.float64
                      else np.float32)
    const_arr_stft, mode, params_host = plan_reassignment(Sfs, nf, False,
                                                          transform="stft")
    params = {k: jnp.asarray(v) for k, v in params_host.items()}
    const = float(const_arr_stft[0])
    if gamma is None:
        gamma = 10 * (EPS64 if rdtype == jnp.float64 else EPS32)

    Sx, dSx = chunked_stft(x, mesh, window=window, n_fft=n_fft,
                           win_len=win_len, hop_len=hop_len, fs=fs,
                           modulated=True, derivative=True, dtype=dtype,
                           axis_name=axis_name,
                           batch_axis_name=batch_axis_name)

    # reassignment is column-local: shard_map over columns
    const_j = jnp.asarray(np.full(nf, const), rdtype)
    gamma_j = jnp.asarray(gamma, rdtype)
    Sfs_j = jnp.asarray(Sfs, rdtype)

    def squeeze_fn(Sx_l, dSx_l):
        return reassign(_squeeze_Wx(squeezing, Sx_l), dSx_l, const_j,
                        gamma_j, Sfs_j, params, mode=mode, flipud=flipud,
                        fused=True, transform="stft", nf=nf)

    in_spec, out_spec = _specs(Sx.ndim, Sx.ndim, axis_name, batch_axis_name)
    fn = shard_map(squeeze_fn, mesh, (in_spec, in_spec), out_spec)
    Tx = fn(Sx, dSx)
    ssq_freqs = Sfs[::-1] if flipud else Sfs
    return Tx, Sx, ssq_freqs, Sfs


# -- inverse transforms, sharded ------------------------------------------------
def chunked_istft(Sx, mesh: Mesh, window=None, n_fft=None, win_len=None,
                  hop_len=1, N=None, modulated=True, win_exp=1,
                  axis_name="time", batch_axis_name=None):
    """Time-sharded inverse STFT, BIT-EXACT vs `ops.stft.istft` (XLA path).

    Sharding design (SURVEY §7.1 last bullet): each shard holds S frame
    columns; it fetches Hl/Hr neighbor FRAME columns via `lax.ppermute`
    (zero columns at the global edges — no frames exist beyond the
    signal), runs the identical irfft + overlap-add locally, and keeps
    its own Sh = S*hop output samples.

    Why a frame halo rather than exchanging OLA tail partial sums: the
    overlap-add fold is ordered by WINDOW OFFSET within each output
    sample (ops/stft.overlap_add), so a boundary sample's accumulation
    interleaves frames of adjacent shards inside one fold group;
    splitting the sum into local + remote partial sums changes the
    floating-point fold order and breaks bit-exactness. With the frame
    halo, every kept sample folds over exactly the frames (and in
    exactly the order) the unsharded transform uses, so results are
    elementwise EQUAL (halo frames beyond the signal contribute literal
    +0.0 terms, the identity). The Griffin-Lim `window_norm` denominator
    is planned globally and passed in time-sharded.

    Reference behavior: old/ssqueezepy/_stft.py:184-256.
    """
    from ..ops.stft import overlap_add, _irfft_mats, MATMUL_NFFT_MAX

    Sx = jnp.asarray(Sx)
    n_fft = int(n_fft or (Sx.shape[-2] - 1) * 2)
    win_len = int(win_len or n_fft)
    n_frames = Sx.shape[-1]
    hop = int(hop_len)
    N = int(N or hop * n_frames)
    if N != hop * n_frames:
        # the shard decomposition assigns each shard exactly S*hop output
        # samples; a ragged N would mis-size the sharded window_norm and
        # fail deep inside shard_map
        raise ValueError(
            f"chunked_istft requires N == hop_len * n_frames "
            f"(= {hop * n_frames}); got N={N}. For a ragged tail use the "
            "unsharded ops.stft.istft, or trim the result.")
    n_shards = mesh.shape[axis_name]
    _check_divisible(n_frames, n_shards, "frame count")
    S = n_frames // n_shards
    Sh = S * hop
    dtype = "float32" if Sx.dtype == jnp.complex64 else "float64"

    window = get_window(window, win_len, n_fft=n_fft, dtype=dtype)
    check_nola(window, hop)
    wn = window_norm(window, hop, n_fft, N, win_exp)     # (N + n_fft - 1,)
    h = n_fft // 2
    # norm aligned to OUTPUT samples (the unsharded istft divides the OLA
    # buffer then unpads [h : h + N])
    wn_out = jnp.asarray(wn[h:h + N])

    # frame halos: output sample j needs frames f with f*hop in
    # (j + h - n_fft, j + h]
    Hl = -(-(n_fft - 1 - h) // hop)
    Hr = -(-h // hop)
    if max(Hl, Hr) > S:
        raise ValueError(
            f"n_fft={n_fft} needs a {max(Hl, Hr)}-frame halo but each of "
            f"the {n_shards} time shards holds only {S} frames; lower "
            f"n_fft or use fewer time shards")

    use_matmul = (Sx.dtype == jnp.complex64 and n_fft <= MATMUL_NFFT_MAX)
    if use_matmul:
        Fr_np, Fs_np = _irfft_mats(n_fft, modulated)
    win_np = np.asarray(window)
    tiny = float(np.finfo(dtype).tiny)

    def shard_fn(Sx_l, wn_l):
        Se = halo_extend(Sx_l, axis_name, n_shards, Hl, Hr,
                         boundary="zero")
        if use_matmul:
            xbuf = (jnp.einsum("tk,...kn->...tn", jnp.asarray(Fr_np),
                               Se.real,
                               precision=jax.lax.Precision.HIGHEST) -
                    jnp.einsum("tk,...kn->...tn", jnp.asarray(Fs_np),
                               Se.imag,
                               precision=jax.lax.Precision.HIGHEST))
        else:
            xbuf = jnp.fft.irfft(Se, n=n_fft, axis=-2)
            if modulated:
                xbuf = jnp.fft.fftshift(xbuf, axes=-2)
        n_loc = S + Hl + Hr
        ola = overlap_add(xbuf, jnp.asarray(win_np), hop, n_fft,
                          (n_loc - 1) * hop + n_fft, win_exp)
        x_l = lax.slice_in_dim(ola, Hl * hop + h, Hl * hop + h + Sh,
                               axis=-1)
        return jnp.where(wn_l > tiny, x_l / jnp.where(wn_l > tiny, wn_l, 1),
                         x_l)

    in_spec, out_spec = _specs(Sx.ndim, Sx.ndim - 1, axis_name,
                               batch_axis_name)
    wn_spec = P(axis_name)
    fn = shard_map(shard_fn, mesh, (in_spec, wn_spec), out_spec)
    return fn(Sx, wn_out.astype(dtype))


def chunked_icwt(Wx, mesh: Mesh, wavelet="gmw", scales="log-piecewise",
                 nv=None, one_int=True, x_len=None, x_mean=0,
                 l1_norm=True, axis_name="time", batch_axis_name=None):
    """Time-sharded inverse CWT (one-integral form).

    The one-integral iCWT is COLUMN-LOCAL — x[j] = (2/Cpsi) * const *
    sum_rows Re(Wx[:, j])/norm(scale) (reference _cwt.py:321-492) — so
    each shard inverts its own time columns with globally planned scales
    and admissibility constants; no halo exchange is needed and the
    result equals the unsharded `ops.cwt.icwt` exactly (identical
    per-column reduction). The two-integral form convolves per scale and
    would need the CWT halo machinery; use the unsharded `icwt` for it.
    """
    if not one_int:
        raise NotImplementedError(
            "chunked_icwt supports the one-integral form only (the "
            "two-integral form needs per-scale convolution halos); use "
            "ops.cwt.icwt(one_int=False) unsharded")
    from ..ops.cwt import icwt

    Wx = jnp.asarray(Wx)
    N = int(x_len or Wx.shape[-1])
    if N != Wx.shape[-1]:
        raise ValueError("chunked_icwt requires x_len == Wx.shape[-1] "
                         "(trimming is not time-shardable)")

    def shard_fn(W):
        return icwt(W, wavelet, scales=scales, nv=nv, one_int=True,
                    x_len=N, x_mean=x_mean, l1_norm=l1_norm)

    in_spec, out_spec = _specs(Wx.ndim, Wx.ndim - 1, axis_name,
                               batch_axis_name)
    fn = shard_map(shard_fn, mesh, (in_spec,), out_spec)
    return fn(Wx)


def chunked_issq_cwt(Tx, mesh: Mesh, wavelet="gmw", cc=None, cw=None,
                     axis_name="time", batch_axis_name=None):
    """Time-sharded inverse synchrosqueezed CWT.

    x[j] = (2/Css) * sum_rows Re(Tx[:, j]) is column-local (reference
    _ssq_cwt.py:313-417): shards invert independently, matching the
    unsharded `issq_cwt` exactly. Component inversion (cc/cw curve
    bands, (n_times, K)) is column-local too — band masks are built per
    time column — so cc/cw shard along time with Tx (the reference's
    component inversion is host-side numpy; ours is device jnp,
    ops/ssq_cwt._invert_components, so it shards and batches)."""
    from ..ops.ssq_cwt import issq_cwt

    Tx = jnp.asarray(Tx)
    in_spec, out_spec = _specs(Tx.ndim, Tx.ndim - 1, axis_name,
                               batch_axis_name)

    if cc is None and cw is None:
        fn = shard_map(lambda T: issq_cwt(T, wavelet), mesh, (in_spec,),
                       out_spec)
        return fn(Tx)

    cc = jnp.asarray(cc, jnp.int32)
    cw = jnp.asarray(cw, jnp.int32)
    if cc.ndim == 1:
        cc, cw = cc[:, None], cw[:, None]
    curve_spec = P(axis_name, None)
    # component inversion adds a (K+1) axis before time
    comp_spec = P(*out_spec[:-1], None, out_spec[-1])

    def shard_fn(T, cc_l, cw_l):
        return issq_cwt(T, wavelet, cc=cc_l, cw=cw_l)

    fn = shard_map(shard_fn, mesh, (in_spec, curve_spec, curve_spec),
                   comp_spec)
    return fn(Tx, cc, cw)


def chunked_issq_stft(Tx, mesh: Mesh, window=None, win_len=None, n_fft=None,
                      axis_name="time", batch_axis_name=None):
    """Time-sharded inverse synchrosqueezed STFT (hop_len=1, modulated —
    the reference's invertible configuration, _ssq_stft.py:139-198).
    Column-local: x[j] = sum_rows Re(Tx[:, j]) * 2 / window[center]."""
    from ..ops.ssq_stft import issq_stft

    Tx = jnp.asarray(Tx)

    def shard_fn(T):
        return issq_stft(T, window=window, win_len=win_len, n_fft=n_fft)

    in_spec, out_spec = _specs(Tx.ndim, Tx.ndim - 1, axis_name,
                               batch_axis_name)
    fn = shard_map(shard_fn, mesh, (in_spec,), out_spec)
    return fn(Tx)


# -- collective byte accounting (host-side planning) ---------------------------
def comm_report(transform: str, N: int, n_shards: int, *, batch: int = 1,
                wavelet="gmw", scales="log-piecewise", nv=32, fs=None,
                n_fft=None, win_len=None, hop_len=1, window=None,
                derivative=None, halo=None, exact=True, exact_tol=1e-6,
                dtype="float32"):
    """Bytes each device SENDS per collective for one chunked transform
    call — the comm side of the scaling-efficiency model (SURVEY §2.4
    P10; the reference's >= 90% multi-host target, BASELINE.md).

    Pure host-side planning: the byte counts are deterministic functions
    of the transform config (the same planning code the transforms run),
    so this reports exactly what `lax.ppermute`/`all_gather`/`all_to_all`
    move without instrumenting the traced path. Ring-algorithm
    accounting: an all_gather sends (n-1) shard copies per device; an
    all_to_all sends (n-1)/n of the local block.

    Returns a dict: per-collective entries (op, what, calls,
    bytes_per_device) + totals; tools/comm_model.cross_bytes turns it
    into the bytes that cross process boundaries."""
    item = np.dtype(dtype).itemsize
    citem = 2 * item
    n = int(n_shards)
    if N % n:
        raise ValueError(f"N={N} not divisible by n_shards={n}")
    S = N // n
    ent = []

    def add(op, what, calls, bytes_per_device):
        ent.append(dict(op=op, what=what, calls=int(calls),
                        bytes_per_device=int(bytes_per_device)))

    info = dict(transform=transform, N=int(N), n_shards=n, S=S,
                batch=int(batch), dtype=str(dtype))

    if transform in ("stft", "ssq_stft"):
        n_fft = int(n_fft or min(N // hop_len, 512))
        _, n1, n2 = pad_params(N, N + n_fft - 1)
        Hl, Hr = n1, n2
        add("ppermute", "signal halo (left+right)", 2,
            (Hl + Hr) * batch * item)
        info.update(halo=(Hl, Hr))
    elif transform == "istft":
        n_fft = int(n_fft)
        h = n_fft // 2
        hop = int(hop_len)
        Hl = -(-(n_fft - 1 - h) // hop)
        Hr = -(-h // hop)
        n_freqs = n_fft // 2 + 1
        add("ppermute", "frame-column halo (left+right)", 2,
            (Hl + Hr) * n_freqs * batch * citem)
        info.update(halo=(Hl, Hr))
    elif transform in ("cwt", "ssq_cwt"):
        if derivative is None:
            derivative = transform == "ssq_cwt"
        wavelet_b, scales_arr, scaletype, nv, dt, fs = _plan_cwt(
            (batch, N), wavelet, scales, nv, fs)
        if halo is None:
            halo = default_cwt_halo(wavelet_b, float(scales_arr.max()))
        H = int(min(halo, S - 1))
        na = len(scales_arr)
        Se = S + 2 * H
        n_up = pad_params(Se)[0]
        if exact:
            g0, g1 = _exact_rows(wavelet_b, scales_arr, H, n_up, exact_tol)
        else:
            g0, g1 = 0, na
        nag = na - (g1 - g0)
        nag_s = -(-nag // n) if nag else 0
        npipes = 2 if derivative else 1
        if g1 > g0:
            add("ppermute", "signal halo (left+right)", 2,
                2 * H * batch * item)
        if nag:
            add("all_gather", "full signal for global-path rows",
                1, (n - 1) * S * batch * item)
            add("all_to_all", "global-path rows -> local columns",
                npipes, ((n - 1) * nag_s * N * batch * citem) // n)
        info.update(halo=H, rows_local=g1 - g0, rows_global=nag,
                    derivative=bool(derivative))
    else:
        raise ValueError(f"unknown transform {transform!r}")

    info["collectives"] = ent
    info["total_bytes_per_device"] = sum(e["calls"] * e["bytes_per_device"]
                                         for e in ent)
    info["total_calls"] = sum(e["calls"] for e in ent)
    return info
