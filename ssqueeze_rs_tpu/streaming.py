"""Stateful streaming transforms: process an unbounded signal block-by-block.

Production-serving counterpart of `parallel.chunked` (which shards a
KNOWN-length signal across devices): here the signal arrives over time,
and a host-side context buffer plays the role of the halo exchange. Every
step runs ONE fixed-shape compiled program (no recompiles after the first
block), keeping serving latency flat.

Exactness model (same split as parallel/chunked.py:1-33):

* STFT family — a column `j` of the offline transform reads exactly
  `xp[j*hop : j*hop + n_fft]` of the reflect-padded signal
  (ops/stft.py:235-262), so carrying `n_fft - hop` raw samples of context
  between blocks reproduces the offline columns EXACTLY; the left/right
  reflect pads are synthesized from the first/last raw samples. The
  synchrosqueezing scatter is column-local (reference algos.py:183-192),
  so StreamingSSQSTFT is exact too.
* CWT family — the wavelet has infinite support; a `halo`-sample context
  bounds the error by the wavelet's L1 tail mass beyond the halo
  (`parallel.chunked.overlap_save_tail_mass`), exactly like the
  reference's dask `map_overlap` scripts approximate with a fixed
  overlap (reference tests/stft_test.py:262-269).

Latency: columns are emitted once their right context (lookahead) has
arrived — `latency_samples` on each streamer.

    s = StreamingSTFT(block=4096, n_fft=256)
    for chunk in source:          # any chunk sizes, any alignment
        cols = s.feed(chunk)      # (n_fft//2+1, k) ready columns, k >= 0
    tail = s.flush()              # remaining columns (right edge)
"""
from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .config import DEFAULTS, EPS32, EPS64
from .utils.windows import get_window, check_nola
from .utils.pad import next_power_of_2
from .ops.stft import stft_core
from .ops.ssqueeze import (plan_reassignment, reassign,
                           compute_associated_frequencies,
                           check_ssqueezing_args)
from .wavelets import Wavelet
from .scales import process_scales, process_fs_and_t
from .parallel.chunked import default_cwt_halo

__all__ = ["StreamingSTFT", "StreamingSSQSTFT", "StreamingCWT",
           "StreamingSSQCWT"]


class _SqueezeMixin:
    """Shared synchrosqueezing step pieces for the SSQ streamers.

    Follows `ops.ssqueeze.ssqueeze` exactly: the squeezing transform of
    Wx happens BEFORE the fused phase+scatter (reference `ssqueeze_fast`
    semantics — with 'lebesgue'/'abs' the phase derives from the
    transformed Wx)."""

    def _init_squeeze(self, squeezing, gamma, flipud, rdtype, const_arr,
                      mode, params_host, Sfs_row, nf, transform):
        from types import FunctionType
        check_ssqueezing_args(squeezing, transform=transform)
        if not isinstance(squeezing, (str, FunctionType)):
            raise TypeError("`squeezing` must be a string or function")
        self.squeezing = squeezing
        self.flipud = bool(flipud)
        self.nf = int(nf)
        self._transform = transform
        self._mode = mode
        self._params = {k: (jnp.asarray(v) if k != "idx1" else
                            jnp.asarray(v, jnp.int32))
                        for k, v in params_host.items()}
        if gamma is None:
            gamma = 10 * (EPS64 if rdtype == jnp.float64 else EPS32)
        self._gamma = jnp.asarray(gamma, rdtype)
        self._const = jnp.asarray(const_arr, rdtype)
        self._Sfs_j = jnp.asarray(Sfs_row, rdtype)

    def _apply_squeezing(self, Wx):
        from types import FunctionType
        if isinstance(self.squeezing, FunctionType):
            return self.squeezing(Wx)
        if self.squeezing == "lebesgue":
            return jnp.ones(Wx.shape, dtype=Wx.dtype) / Wx.shape[-2]
        if self.squeezing == "abs":
            return jnp.abs(Wx).astype(Wx.dtype)
        return Wx

    def _reassign_cols(self, Wq, dWx):
        return reassign(Wq, dWx, self._const, self._gamma, self._Sfs_j,
                        self._params, mode=self._mode, flipud=self.flipud,
                        fused=True, transform=self._transform, nf=self.nf)


class _StreamerBase:
    """Shared block/buffer machinery.

    Subclasses set: `_E` (step input length), `_advance` (samples consumed
    per step = block), `_cols_per_step`, `_prefix_len`/`_suffix_len`
    (virtual pad lengths), `_hop`, and implement `_step(xe) -> tuple of
    arrays with columns on the last axis`.
    """

    def _init_stream(self):
        self._staging = None        # raw samples until the prefix exists
        self._buf = None            # virtual padded stream, pending samples
        self._tail = None           # last raw samples (right reflect pad)
        self._n_raw = 0
        self._n_emitted = 0
        self._finished = False
        self._batch_shape = ()      # leading (channel) dims, set on feed

    @property
    def latency_samples(self) -> int:
        """Samples of lookahead a column waits for before it can be
        emitted (the right-context length)."""
        return self._suffix_len

    def _total_cols(self, n_raw: int) -> int:
        return 0 if n_raw == 0 else (n_raw - 1) // self._hop + 1

    def _append(self, buf, x):
        return x if buf is None else np.concatenate([buf, x], axis=-1)

    def _empty_out(self, outs):
        # shape-correct empty result so callers can concatenate blindly
        z = self._step_out_struct()
        empty = tuple(np.zeros(self._batch_shape + s[:-1] + (0,), d)
                      for s, d in z)
        return empty if len(empty) > 1 else empty[0]

    def _pack(self, outs):
        if not outs:
            return self._empty_out(outs)
        cat = tuple(np.concatenate(parts, axis=-1)
                    for parts in zip(*outs))
        return cat if len(cat) > 1 else cat[0]

    def feed(self, x):
        """Append raw samples; return all columns that became computable
        (columns on the last axis; multiple outputs as a tuple)."""
        if self._finished:
            raise RuntimeError("stream already flushed; call reset()")
        x = np.asarray(x)
        if x.shape[-1]:
            if self._n_raw == 0:
                self._batch_shape = x.shape[:-1]
            elif x.shape[:-1] != self._batch_shape:
                raise ValueError(
                    f"feed() channel shape changed mid-stream: "
                    f"{x.shape[:-1]} vs {self._batch_shape}")
            self._n_raw += x.shape[-1]
            keep = self._suffix_len + 1
            t = self._append(self._tail, x)
            self._tail = t[..., -keep:] if t.shape[-1] > keep else t
            if self._buf is None:
                self._staging = self._append(self._staging, x)
                need = self._prefix_len + 1
                if self._staging.shape[-1] >= need or self._prefix_len == 0:
                    pad = [(0, 0)] * (self._staging.ndim - 1) + \
                          [(self._prefix_len, 0)]
                    self._buf = np.pad(self._staging, pad, mode="reflect")
                    self._staging = None
            else:
                self._buf = self._append(self._buf, x)

        outs = []
        while self._buf is not None and self._buf.shape[-1] >= self._E:
            cols = self._jit_step(jnp.asarray(self._buf[..., :self._E]))
            outs.append(tuple(np.asarray(c) for c in cols))
            self._buf = self._buf[..., self._advance:]
            self._n_emitted += self._cols_per_step
        return self._pack(outs)

    @property
    def _jit_step(self):
        """The whole step (transform [+ squeeze] + trims) as ONE compiled
        program: eager slicing/squeezing on device arrays would add a
        dispatch each. Cached across reset()."""
        fn = self.__dict__.get("_jstep")
        if fn is None:
            fn = self.__dict__["_jstep"] = jax.jit(self._step)
        return fn

    def flush(self):
        """Terminate the stream: synthesize the right reflect pad, emit
        every remaining column, and freeze the streamer (reset() to
        reuse)."""
        if self._finished:
            raise RuntimeError("stream already flushed; call reset()")
        self._finished = True
        if self._n_raw == 0:
            return self._empty_out([])
        if self._buf is None:      # stream shorter than the prefix
            pad = [(0, 0)] * (self._staging.ndim - 1) + \
                  [(self._prefix_len, 0)]
            self._buf = np.pad(self._staging, pad, mode="reflect")
            self._staging = None
        if self._suffix_len:
            t = self._tail
            # 'reflect' handles pads wider than the source by repeated
            # reflection — the same extension padsignal applies offline,
            # so even sub-pad-length streams stay exact
            pad = [(0, 0)] * (t.ndim - 1) + [(0, self._suffix_len)]
            sfx = np.pad(t, pad, mode="reflect")[..., t.shape[-1]:]
            self._buf = self._append(self._buf, sfx)

        outs = []
        remaining = self._total_cols(self._n_raw) - self._n_emitted
        while remaining > 0:
            seg = self._buf[..., :self._E]
            if seg.shape[-1] < self._E:
                pad = [(0, 0)] * (seg.ndim - 1) + \
                      [(0, self._E - seg.shape[-1])]
                seg = np.pad(seg, pad)
            cols = self._jit_step(jnp.asarray(seg))
            k = min(remaining, self._cols_per_step)
            outs.append(tuple(np.asarray(c)[..., :k] for c in cols))
            self._buf = self._buf[..., self._advance:]
            remaining -= k
        return self._pack(outs)

    def reset(self):
        self._init_stream()


# -- STFT family (exact) ---------------------------------------------------------
class StreamingSTFT(_StreamerBase):
    """Streaming STFT, column-exact vs `ops.stft.stft` (padtype='reflect').

    `block`: samples consumed per compiled step (must divide by hop_len);
    requests of any size are buffered to blocks. One compile total.
    """

    def __init__(self, block=4096, n_fft=None, win_len=None, hop_len=1,
                 window=None, fs=None, modulated=True, derivative=False,
                 dtype=None):
        self.block = int(block)
        self.hop_len = int(hop_len)
        if self.block % self.hop_len:
            raise ValueError("block must be a multiple of hop_len")
        self.n_fft = int(n_fft or min(self.block // self.hop_len, 512))
        if self.n_fft < self.hop_len:
            raise ValueError("n_fft must be >= hop_len")
        _, self.fs, _ = process_fs_and_t(fs, None, self.block)
        self.dtype = dtype or DEFAULTS["dtype"]
        self.derivative = bool(derivative)
        self.modulated = bool(modulated)
        if win_len is None:
            win_len = (len(window)
                       if isinstance(window, (np.ndarray, jnp.ndarray))
                       else self.n_fft)
        self._window, self._dwindow = get_window(
            window, win_len, self.n_fft, derivative=True, dtype=self.dtype)
        check_nola(self._window, self.hop_len)

        pad = self.n_fft - 1                     # ops/stft.py:259-260 split
        self._prefix_len = (pad + 1) // 2        # = n1 of pad_params
        self._suffix_len = pad // 2              # = n2
        self._hop = self.hop_len
        self._advance = self.block
        self._cols_per_step = self.block // self.hop_len
        self._E = self.block - self.hop_len + self.n_fft
        self._init_stream()

    def _step_out_struct(self):
        nf = self.n_fft // 2 + 1
        cd = "complex128" if self.dtype == "float64" else "complex64"
        s = ((nf, 0), cd)
        return (s, s) if self.derivative else (s,)

    def _step(self, xe):
        Sx, dSx = stft_core(
            xe.astype(self.dtype), self._window, self._dwindow, self.fs,
            n_fft=self.n_fft, hop_len=self.hop_len,
            modulated=self.modulated, derivative=self.derivative)
        return (Sx, dSx) if self.derivative else (Sx,)


class StreamingSSQSTFT(_SqueezeMixin, _StreamerBase):
    """Streaming synchrosqueezed STFT — exact: the STFT columns are exact
    (StreamingSTFT) and the phase transform + reassignment read only their
    own column (ops/ssq_stft.py; reference algos.py:183-192). Each step is
    one fused program: STFT + derivative + squeeze.

    feed()/flush() return (Tx, Sx) column blocks; `ssq_freqs` / `Sfs` are
    the fixed row grids.
    """

    def __init__(self, block=4096, n_fft=None, win_len=None, hop_len=1,
                 window=None, fs=None, squeezing="sum", gamma=None,
                 flipud=False, dtype=None):
        self._stft = StreamingSTFT(block, n_fft=n_fft, win_len=win_len,
                                   hop_len=hop_len, window=window, fs=fs,
                                   modulated=True, derivative=True,
                                   dtype=dtype)
        nf = self._stft.n_fft // 2 + 1
        rdtype = (jnp.float64 if self._stft.dtype == "float64"
                  else jnp.float32)
        self.Sfs = np.linspace(0, 0.5 * self._stft.fs, nf,
                               dtype=(np.float64 if rdtype == jnp.float64
                                      else np.float32))
        const_arr, mode, params = plan_reassignment(
            self.Sfs, nf, False, transform="stft")
        self._init_squeeze(squeezing, gamma, flipud, rdtype,
                           np.full(nf, float(const_arr[0])), mode, params,
                           self.Sfs, nf, "stft")
        self.ssq_freqs = self.Sfs[::-1] if self.flipud else self.Sfs

        for a in ("_E", "_advance", "_cols_per_step", "_prefix_len",
                  "_suffix_len", "_hop"):
            setattr(self, a, getattr(self._stft, a))
        self._init_stream()

    @property
    def latency_samples(self):
        return self._stft.latency_samples

    def _step_out_struct(self):
        cd = ("complex128" if self._stft.dtype == "float64"
              else "complex64")
        s = ((self.nf, 0), cd)
        return (s, s)

    def _step(self, xe):
        Sx, dSx = self._stft._step(xe)
        Tx = self._reassign_cols(self._apply_squeezing(Sx), dSx)
        return Tx, Sx


# -- CWT family (halo-bounded) ---------------------------------------------------
class StreamingCWT(_StreamerBase):
    """Streaming CWT with a `halo`-sample carried context.

    Interior columns match the offline transform up to the wavelet's L1
    tail mass beyond the halo (`overlap_save_tail_mass` quantifies it;
    the default halo comes from `default_cwt_halo` at the largest scale).
    The step length `block + 2*halo` is rounded up to a power of two
    (the FFT's fastest length) — the rounding widens the halo for
    free. `plan_N` fixes the scale grid (default: `block`; pass the
    nominal recording length to reproduce an offline grid — the default
    halo is always sized from THAT grid's largest scale, then capped at
    3.5*block with a warning; `row_tail_mass` reports the per-row truth
    either way).
    """

    def __init__(self, block=8192, wavelet="gmw", scales="log-piecewise",
                 nv=32, fs=None, l1_norm=True, derivative=False, halo=None,
                 plan_N=None, dtype=None):
        self.block = int(block)
        self.dtype = dtype or DEFAULTS["dtype"]
        self.derivative = bool(derivative)
        self.l1_norm = bool(l1_norm)
        self.wavelet = Wavelet.build(wavelet, l1_norm=l1_norm)
        dt, self.fs, _ = process_fs_and_t(fs, None, self.block)
        self._dt = dt

        # provisional halo -> power-of-two step length -> widened halo
        probe_N = int(plan_N or self.block)
        scales_arr, self.scaletype, _, self.nv = process_scales(
            scales, probe_N, self.wavelet, nv=nv, get_params=True)
        if halo is None:
            halo = default_cwt_halo(self.wavelet, float(scales_arr.max()))
            # the largest scales can demand a halo many times the block
            # (their support ~ scale samples); cap the default so each
            # step stays within 8x the block, and tell the user — they
            # can pass `halo` explicitly to override either way
            cap = int(3.5 * self.block)
            if halo > cap:
                from .utils.common import WARN
                WARN(f"default CWT halo ({int(halo)}) exceeds 3.5*block; "
                     f"capping to {cap} — the largest scales' columns "
                     "carry extra tail-mass error (pass halo= or a larger "
                     "block to widen)")
                halo = cap
        E = next_power_of_2(self.block + 2 * int(halo))
        self._suffix_len = (E - self.block) // 2
        self._prefix_len = E - self.block - self._suffix_len
        self._E = E
        self.halo = min(self._prefix_len, self._suffix_len)
        # the grid is planned ONCE, at plan_N (default: block), and the
        # default halo above came from that same grid — planning at a
        # different length here would silently undersize the halo for
        # the re-planned grid's largest scales
        self.plan_N = probe_N
        self.scales = scales_arr.squeeze()
        self._tail_mass = None     # lazy: row_tail_mass property

        self._hop = 1
        self._advance = self.block
        self._cols_per_step = self.block
        self._init_stream()

    @property
    def row_tail_mass(self):
        """Per-scale-row L1 kernel mass outside the halo at the step
        length — the error bound of that row's streamed columns
        (`parallel.chunked.overlap_save_tail_mass`). Rows with mass under
        ~1e-6 are numerically indistinguishable from the offline
        transform; the smallest (near/beyond-Nyquist) scales ring over
        the whole segment and are inherently segment-length-dependent —
        the same rows chunked_cwt's exact mode routes to the global FFT."""
        if self._tail_mass is None:
            from .parallel.chunked import overlap_save_tail_mass
            self._tail_mass = overlap_save_tail_mass(
                self.wavelet, np.asarray(self.scales).reshape(-1),
                self.halo, self._E)
        return self._tail_mass

    def _step_out_struct(self):
        na = len(np.atleast_1d(self.scales))
        cd = "complex128" if self.dtype == "float64" else "complex64"
        s = ((na, 0), cd)
        return (s, s) if self.derivative else (s,)

    def _cwt_cols(self, xe):
        from .ops.cwt import cwt
        out = cwt(xe.astype(self.dtype), self.wavelet,
                  scales=np.asarray(self.scales).reshape(-1, 1),
                  fs=self.fs, l1_norm=self.l1_norm,
                  derivative=self.derivative, padtype=None,
                  dtype=self.dtype)
        lo, hi = self._prefix_len, self._prefix_len + self.block
        if self.derivative:
            Wx, _, dWx = out
            return Wx[..., lo:hi], dWx[..., lo:hi]
        Wx, _ = out
        return (Wx[..., lo:hi],)

    def _step(self, xe):
        return self._cwt_cols(xe)


class StreamingSSQCWT(_SqueezeMixin, StreamingCWT):
    """Streaming synchrosqueezed CWT: halo-bounded CWT columns + exact
    column-local reassignment (same plan as parallel.chunked_ssq_cwt).
    feed()/flush() return (Tx, Wx) column blocks."""

    def __init__(self, block=8192, wavelet="gmw", scales="log-piecewise",
                 nv=32, fs=None, maprange="peak", squeezing="sum",
                 gamma=None, flipud=True, halo=None, plan_N=None,
                 dtype=None):
        super().__init__(block, wavelet=wavelet, scales=scales, nv=nv,
                         fs=fs, l1_norm=True, derivative=True, halo=halo,
                         plan_N=plan_N, dtype=dtype)
        scales_col = np.asarray(self.scales).reshape(-1, 1)
        self.ssq_freqs = compute_associated_frequencies(
            scales_col, self.plan_N, self.wavelet, self.scaletype,
            maprange, True, self._dt, "cwt")
        na = len(scales_col)
        const_arr, mode, params = plan_reassignment(
            self.ssq_freqs, na, self.scaletype.startswith("log"),
            transform="cwt", cwt_scaletype=self.scaletype, nv=self.nv,
            scales=scales_col)
        rdtype = jnp.float64 if self.dtype == "float64" else jnp.float32
        self._init_squeeze(squeezing, gamma, flipud, rdtype, const_arr,
                           mode, params, np.zeros((na,)),
                           len(self.ssq_freqs), "cwt")
        # CWT ssq_freqs flip UNCONDITIONALLY (scales go high->low, so the
        # natural row order is descending frequency; reference
        # ssqueezing.py:217-223 and ops/ssqueeze.py:393-395)
        self.ssq_freqs = self.ssq_freqs[::-1]

    def _step_out_struct(self):
        na = len(np.atleast_1d(self.scales))
        cd = "complex128" if self.dtype == "float64" else "complex64"
        return (((self.nf, 0), cd), ((na, 0), cd))

    def _step(self, xe):
        Wx, dWx = self._cwt_cols(xe)
        Tx = self._reassign_cols(self._apply_squeezing(Wx), dWx)
        return Tx, Wx
