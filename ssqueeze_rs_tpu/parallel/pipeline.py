"""Streaming long-recording pipeline: native mmap reader -> on-device
transforms -> stacked TF outputs.

Analog of the reference's dask orchestration scripts
(tests/stft_test.py:163-269, tests/ssq_cwt_test.py:66-196): the recording
is streamed in halo-overlapped chunks (host-side C++ reader or numpy
slices), each chunk is transformed on-device with channels batched in one
tensor program (the reference loops channels in Python,
tests/ssq_cwt_test.py:125-160), halos are trimmed, and chunk outputs are
concatenated along time.

For data already resident in device memory, prefer
`parallel.chunked_*` (pure on-device halo exchange). This pipeline is for
recordings larger than HBM.
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.common import assert_is_one_of

__all__ = ["process_recording", "process_stft", "process_cwt",
           "process_ssq_cwt", "process_ssq_stft"]


def _chunk_iter_array(x, chunk_len, halo):
    """Reflect-padded halo chunks from an in-memory (C, N) array."""
    from ..io import _reflect_indices      # one reflect-index mapping
    C, N = x.shape
    start = 0
    while start < N:
        cl = min(chunk_len, N - start)
        idx = _reflect_indices(start - halo, start + cl + halo, N)
        yield start, cl, x[:, idx]
        start += chunk_len


def process_recording(source, transform="ssq_cwt", fs=1.0, n_channels=None,
                      chunk_len=1_000_000, halo=None, hop_len=1, n_fft=None,
                      window=None, wavelet="gmw", scales="log-piecewise",
                      nv=32, dtype="float32", out="numpy", prefetch=True,
                      prefetch_depth=3, columns=None, **kw):
    """Stream a long multichannel recording through a TF transform.

    `source`: path to a raw channel-major float32 file (uses the native
    mmap reader; with `prefetch`, the C++ double-buffered scheduler
    overlaps the next chunk's IO with the current chunk's device compute),
    a `.parquet`/`.pq` path or `io.ParquetRecording` (the reference's
    pyarrow data path, tests/stft_test.py:374-377; `columns` selects
    channel columns), or a (n_channels, n_samples) array.

    `out`: 'numpy' (default) fetches the full TF array; 'energy' reduces
    on device to the per-(channel, row) energy profile sum_t |out|^2 —
    a (C, n_rows) spectral summary whose fetch is tiny (useful for long
    recordings, where full-output fetches dominate wall time).

    Returns (result, meta): result has shape (C, n_rows, ~N/hop) stacked
    along time ('numpy') or (C, n_rows) ('energy'); meta holds
    frequencies/scales.
    """
    assert_is_one_of(out, "out", ("numpy", "energy"))
    assert_is_one_of(transform, "transform", ("stft", "cwt", "ssq_cwt",
                                              "ssq_stft"))
    import jax.numpy as jnp
    from ..ops.stft import stft
    from ..ops.cwt import cwt
    from ..ops.ssq_cwt import ssq_cwt
    from ..ops.ssq_stft import ssq_stft
    from ..scales import process_scales
    from ..wavelets.base import Wavelet
    from ..io import ParquetRecording

    is_path = (isinstance(source, (str, bytes)) or
               hasattr(source, "__fspath__"))
    is_parquet = isinstance(source, ParquetRecording) or (
        is_path and os.fspath(source).endswith((".parquet", ".pq")))
    if is_parquet:
        rec = (source if isinstance(source, ParquetRecording) else
               ParquetRecording(source, columns=columns))
        N = rec.n_samples
        def chunks():
            for start, chunk in rec.iter_chunks(chunk_len, halo_eff):
                yield start, chunk.shape[-1] - 2 * halo_eff, chunk
    elif is_path:
        from ..native import MappedRecording
        if n_channels is None:
            raise ValueError("n_channels required for file sources")
        rec = MappedRecording(source, n_channels=n_channels, dtype="float32")
        N = rec.n_samples
        def chunks():
            it = (rec.iter_chunks_prefetch(chunk_len, halo_eff,
                                           depth=prefetch_depth)
                  if prefetch else rec.iter_chunks(chunk_len, halo_eff))
            for start, chunk in it:
                yield start, chunk.shape[-1] - 2 * halo_eff, chunk
    else:
        x = np.atleast_2d(np.asarray(source))
        N = x.shape[-1]
        def chunks():
            yield from _chunk_iter_array(x, chunk_len, halo_eff)

    # halo: n_fft for STFT paths (the dask scripts' depth, stft_test.py:263),
    # wavelet support for CWT paths
    if transform in ("stft", "ssq_stft"):
        n_fft_eff = int(n_fft or 512)
        halo_eff = int(halo if halo is not None else n_fft_eff)
        # keep the GLOBAL frame grid aligned: halo AND chunk starts must
        # sit on hop multiples, else every chunk boundary shifts the
        # frame grid by chunk_len % hop and adds spurious frames. Halo
        # rounds UP (rounding down could drop the overlap to zero for
        # hop > n_fft); chunk_len snaps down to the hop grid.
        halo_eff = -(-halo_eff // hop_len) * hop_len
        if chunk_len % hop_len:
            chunk_len = max((chunk_len // hop_len) * hop_len, hop_len)
    else:
        ext_guess = min(chunk_len, N)
        wav = Wavelet.build(wavelet, l1_norm=kw.get("l1_norm", True))
        scales_arr = process_scales(scales, ext_guess + 0, wav, nv=nv)
        if halo is None:
            from .chunked import default_cwt_halo
            from ..utils.common import WARN
            halo_eff = default_cwt_halo(wav, float(scales_arr.max()))
            if halo_eff > chunk_len // 2:
                # the largest scales' support exceeds the chunk; cap like
                # the reference dask scripts' fixed conservative overlap
                # (SURVEY §5) — their large-scale rows are edge-approximate
                # near chunk boundaries in exactly the same way
                WARN(f"CWT halo for the largest scale ({halo_eff} samples) "
                     f"exceeds chunk_len/2; capping to {chunk_len // 2} — "
                     "large-scale rows are approximate near chunk edges "
                     "(pass `halo=` or raise `chunk_len` to control)")
                halo_eff = chunk_len // 2
        else:
            halo_eff = int(halo)

    # channel sub-batching: one chunk's transform holds a few complex64
    # (rows, ext) arrays per channel in device memory (the CWT's padded
    # spectra are blocked to half of the limit by ops.cwt); split
    # channels so a group fits the device's own limit (no split where
    # the device reports none)
    from ..utils.common import device_memory_limit
    limit = device_memory_limit()
    ext_max = min(chunk_len, N) + 2 * halo_eff
    if transform in ("stft", "ssq_stft"):
        rows = n_fft_eff // 2 + 1
        per_chan, avail = 64 * rows * (ext_max // hop_len), limit
    else:
        rows = len(scales_arr)
        per_chan = 48 * rows * ext_max
        avail = None if limit is None else limit // 2
    cbatch = (max(1, int(avail // max(per_chan, 1))) if limit is not None
              else None)

    def _apply(fn, chunk):
        C = chunk.shape[0]
        if cbatch is None or C <= cbatch:
            return fn(chunk)
        parts = [fn(chunk[c0:c0 + cbatch]) for c0 in range(0, C, cbatch)]
        return np.concatenate(parts, axis=0)

    # per-chunk transforms run under jit (cached per (shape, cl)); the
    # host planning outputs (frequencies, scales) are recorded into
    # `meta` at trace time, at full host precision
    import jax
    from functools import partial
    Hl = halo_eff
    outs, meta = [], {}

    if transform == "stft":
        @partial(jax.jit, static_argnames=("cl",))
        def jfn(ch, cl):
            S = stft(ch, window=window, n_fft=n_fft_eff, hop_len=hop_len,
                     fs=fs, dtype=dtype, **kw)
            lo = Hl // hop_len
            return S[..., lo:lo + (cl - 1) // hop_len + 1]
        meta["freqs"] = np.linspace(0, fs / 2, n_fft_eff // 2 + 1)
    elif transform == "ssq_stft":
        @partial(jax.jit, static_argnames=("cl",))
        def jfn(ch, cl):
            Tx, Sx, ssq_freqs, Sfs = ssq_stft(
                ch, window=window, n_fft=n_fft_eff, hop_len=hop_len, fs=fs,
                dtype=dtype, **kw)
            meta["ssq_freqs"] = np.asarray(ssq_freqs)
            lo = Hl // hop_len
            return Tx[..., lo:lo + (cl - 1) // hop_len + 1]
    elif transform == "cwt":
        if kw.get("derivative"):
            # the streamed output structure holds ONE array per chunk;
            # a silent 3-tuple unpack crash here helped nobody
            raise ValueError("process_recording(transform='cwt') does not "
                             "stream the derivative; call ops.cwt per "
                             "chunk for dWx")

        @partial(jax.jit, static_argnames=("cl",))
        def jfn(ch, cl):
            Wx, sc = cwt(ch, wavelet, scales=scales_arr, fs=fs, nv=None,
                         dtype=dtype, **kw)
            meta["scales"] = np.asarray(sc)
            return Wx[..., Hl:Hl + cl]
    else:  # ssq_cwt
        # plan the ssq frequency grid ONCE from the full-chunk extent:
        # otherwise a shorter final chunk would be binned on a different
        # grid than the rest and silently concatenated with them
        from ..ops.ssqueeze import compute_associated_frequencies
        from ..scales import process_fs_and_t
        dt_g = process_fs_and_t(fs, None, ext_max)[0]
        _, scaletype_g, *_ = process_scales(scales_arr, ext_max, wav,
                                            get_params=True)
        ssq_freqs_g = compute_associated_frequencies(
            scales_arr, ext_max, wav, scaletype_g,
            kw.get("maprange", "peak"), True, dt_g, "cwt")

        @partial(jax.jit, static_argnames=("cl",))
        def jfn(ch, cl):
            Tx, Wx, ssq_freqs, sc = ssq_cwt(ch, wavelet, scales=scales_arr,
                                            fs=fs, nv=None, dtype=dtype,
                                            ssq_freqs=ssq_freqs_g, **kw)
            meta["ssq_freqs"] = np.asarray(ssq_freqs)
            meta["scales"] = np.asarray(sc)
            return Tx[..., Hl:Hl + cl]

    if out == "energy":
        @partial(jax.jit, static_argnames=("cl",))
        def efn(ch, cl):
            o = jfn(ch, cl=cl)
            return jnp.sum(o.real * o.real + o.imag * o.imag, axis=-1)
    else:
        efn = jfn

    for start, cl, chunk in chunks():
        outs.append(_apply(lambda ch, cl=cl: np.asarray(efn(ch, cl=cl)),
                           chunk))

    if out == "energy":
        return np.sum(np.stack(outs), axis=0), meta
    result = np.concatenate(outs, axis=-1)
    return result, meta


# -- reference orchestration name parity ---------------------------------------
# The reference packages its out-of-core story as dask scripts named
# process_stft / process_cwt / process_ssq_cwt / process_ssq_stft
# (tests/stft_test.py:163-269, cwt_test.py:69-196, ssq_cwt_test.py:66-196,
# stft_ssq_test.py:274-281): data is (n_samples, n_channels), chunked
# along time with a reflect halo, each chunk transformed per channel and
# stacked to (freq, time, channel). These wrappers provide the same
# entry points over process_recording (channels batched in ONE tensor
# program instead of a Python loop; identical halo semantics).
def _channels_first(data):
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    return np.ascontiguousarray(data.T)


def _freq_time_chan(res):
    return np.transpose(res, (1, 2, 0))


def process_stft(data, fs=None, n_fft=1024, hop_length=256,
                 window_name="hann", chunk_len=1_000_000, **kw):
    """(n_samples, n_channels) -> (n_freqs, n_frames, n_channels) complex
    (reference: tests/stft_test.py:163-260; chunk size + halo = the dask
    scripts' map_overlap(depth={-2: n_fft}))."""
    res, _ = process_recording(_channels_first(data), transform="stft",
                               fs=float(fs or 1.0), n_fft=n_fft,
                               hop_len=hop_length, window=window_name,
                               chunk_len=chunk_len, **kw)
    return _freq_time_chan(res)


def process_cwt(data, fs=None, wavelet="gmw", scales=None, nv=32,
                derivative=False, padtype="reflect", chunk_len=100_000,
                **kw):
    """(n_samples, n_channels) -> (n_scales, n_samples, n_channels)
    complex Wx (reference: tests/cwt_test.py:69-196). `derivative` is
    accepted for signature parity; the stacked output is Wx either way
    (matching the reference's chunk stacking)."""
    res, _ = process_recording(_channels_first(data), transform="cwt",
                               fs=float(fs or 1.0), wavelet=wavelet,
                               scales=(scales if scales is not None
                                       else "log-piecewise"), nv=nv,
                               chunk_len=chunk_len, padtype=padtype, **kw)
    return _freq_time_chan(res)


def process_ssq_cwt(data, fs=None, wavelet="gmw", scales=None, nv=32,
                    padtype="reflect", squeezing="sum", maprange="peak",
                    chunk_len=100_000, **kw):
    """(n_samples, n_channels) -> ((n_freqs, n_samples, n_channels)
    complex Tx, ssq_freqs) (reference: tests/ssq_cwt_test.py:66-196)."""
    res, meta = process_recording(
        _channels_first(data), transform="ssq_cwt", fs=float(fs or 1.0),
        wavelet=wavelet, scales=(scales if scales is not None
                                 else "log-piecewise"), nv=nv,
        chunk_len=chunk_len, padtype=padtype, squeezing=squeezing,
        maprange=maprange, **kw)
    return _freq_time_chan(res), meta.get("ssq_freqs")


def process_ssq_stft(data, fs=None, n_fft=1024, hop_length=1,
                     window_name="hann", chunk_len=1_000_000, **kw):
    """(n_samples, n_channels) -> ((n_freqs, n_frames, n_channels)
    complex Tx, ssq_freqs) (reference: tests/stft_ssq_test.py:274-281)."""
    res, meta = process_recording(
        _channels_first(data), transform="ssq_stft", fs=float(fs or 1.0),
        n_fft=n_fft, hop_len=hop_length, window=window_name,
        chunk_len=chunk_len, **kw)
    return _freq_time_chan(res), meta.get("ssq_freqs")
