"""Shape-bucketed serving wrapper.

XLA compiles one program per input shape; in a serving setting where
request lengths vary, naive dispatch recompiles on nearly every request
(a compile per new length). `TransformServer` reflect-pads each
request up to a fixed bucket length and trims the output, so there is
exactly ONE compile per (bucket, channels, dtype) for the server's
lifetime.

Semantics: a request of length N returns the transform of the
bucket-padded signal trimmed back to N columns — i.e. each bucket fixes
the analysis configuration (scale grid / ssq frequency rows are the
bucket's). This matches how the reference's dask scripts process fixed
chunk sizes (tests/stft_test.py:374-377).

    server = TransformServer("ssq_cwt", fs=1000.0)
    out = server(x)          # dict: Tx, Wx, ssq_freqs, scales
"""
from __future__ import annotations

import numpy as np

from .utils.common import assert_is_one_of

__all__ = ["TransformServer", "DEFAULT_BUCKETS"]

DEFAULT_BUCKETS = (4096, 16384, 65536, 262144)


class TransformServer:
    """Bucketed jit dispatcher for the four transforms.

    `transform`: 'stft' | 'cwt' | 'ssq_cwt' | 'ssq_stft';
    `buckets`: ascending request-length capacities; `**kw` is passed to
    the underlying transform (fs, wavelet, n_fft, ...).
    """

    def __init__(self, transform="ssq_cwt", buckets=DEFAULT_BUCKETS,
                 dtype="float32", **kw):
        assert_is_one_of(transform, "transform",
                         ("stft", "cwt", "ssq_cwt", "ssq_stft"))
        self.transform = transform
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.dtype = dtype
        self.kw = dict(kw)
        if self.kw.get("rpadded"):
            # rpadded outputs keep the internal pad columns; the server's
            # contract is bucket-padded-then-trimmed SIGNAL columns, and
            # the trim arithmetic would silently keep pad regions
            raise ValueError("rpadded=True is unsupported in "
                             "TransformServer (outputs are trimmed to "
                             "request length); call the transform "
                             "directly for raw padded output")
        self._fn = None         # ONE jitted callable; jit caches per shape
        self._meta = {}         # padded length -> host planning metadata

    def bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"request length {n} exceeds the largest bucket "
                         f"({self.buckets[-1]}); add a bigger bucket or "
                         "use parallel.process_recording")

    def _build(self):
        # ONE jitted callable for every bucket/channel count: jit keys
        # its executable cache on the traced input shape, so a per-bucket
        # dict would only duplicate that cache (ADVICE r2 had the two key
        # spaces collide). Host planning outputs (scales/ssq_freqs/Sfs)
        # are stashed at TRACE time keyed by padded length — full float64
        # host precision, zero device round-trips per request.
        import jax
        from .ops.stft import stft as _stft
        from .ops.cwt import cwt as _cwt
        from .ops.ssq_cwt import ssq_cwt as _ssq_cwt
        from .ops.ssq_stft import ssq_stft as _ssq_stft

        transform, dtype, kw = self.transform, self.dtype, self.kw
        meta = self._meta

        @jax.jit
        def fn(xp):
            b = xp.shape[-1]
            if transform == "stft":
                return {"Sx": _stft(xp, dtype=dtype, **kw)}
            if transform == "cwt":
                Wx, sc = _cwt(xp, kw.get("wavelet", "gmw"),
                              **{k: v for k, v in kw.items()
                                 if k != "wavelet"}, dtype=dtype)
                meta[b] = {"scales": np.asarray(sc)}
                return {"Wx": Wx}
            if transform == "ssq_cwt":
                Tx, Wx, fr, sc = _ssq_cwt(
                    xp, kw.get("wavelet", "gmw"),
                    **{k: v for k, v in kw.items() if k != "wavelet"},
                    dtype=dtype)
                meta[b] = {"ssq_freqs": np.asarray(fr),
                           "scales": np.asarray(sc)}
                return {"Tx": Tx, "Wx": Wx}
            Tx, Sx, fr, Sfs = _ssq_stft(xp, dtype=dtype, **kw)
            meta[b] = {"ssq_freqs": np.asarray(fr), "Sfs": np.asarray(Sfs)}
            return {"Tx": Tx, "Sx": Sx}

        return fn

    def _ensure_fn(self):
        if self._fn is None:
            self._fn = self._build()
        return self._fn

    @property
    def n_compiled(self) -> int:
        # compiled PROGRAMS (one per traced input shape)
        return self._fn._cache_size() if self._fn is not None else 0

    def warmup(self, channels=(1,)):
        """Precompile every (bucket, channels) program at startup so no
        request ever pays compile latency."""
        import jax.numpy as jnp
        fn = self._ensure_fn()
        for c in channels:
            for b in self.buckets:
                x = jnp.zeros((int(c), b), dtype=self.dtype)
                for v in fn(x).values():
                    v.block_until_ready()
        return self

    def __call__(self, x):
        """x: (N,) or (channels, N) array. Returns a dict of numpy arrays."""
        import jax.numpy as jnp

        x = np.asarray(x)
        squeeze = (x.ndim == 1)
        x = np.atleast_2d(x)
        C, N = x.shape
        b = self.bucket_for(N)
        fn = self._ensure_fn()
        # reflect-pad the request up to the bucket capacity
        pad = b - N
        xp = np.pad(x, ((0, 0), (0, pad)), mode="reflect") if pad else x
        out = fn(jnp.asarray(xp, dtype=self.dtype))

        res = {}
        for k, v in out.items():
            a = np.asarray(v)[..., : self._out_cols(k, N, b, v)]
            res[k] = a[0] if squeeze else a
        res.update(self._meta.get(b, {}))
        return res

    def batch(self, xs):
        """Serve MANY requests in ONE dispatched program (dynamic
        batching). Each request (1D, possibly different lengths within
        the same bucket) is reflect-padded to the shared bucket, stacked
        on the channel axis, transformed once, and split back per
        request trimmed to its own length: one dispatch amortized over
        the batch. Returns a list of per-request dicts.
        """
        import jax.numpy as jnp

        xs = [np.asarray(x) for x in xs]
        if not xs:
            return []
        if any(x.ndim != 1 for x in xs):
            raise ValueError("batch() takes 1D requests; use __call__ "
                             "for multichannel arrays")
        b = self.bucket_for(max(len(x) for x in xs))
        # batch-size bucketing: round the request count up to a power of
        # 2 (padding with copies of the last request, outputs dropped) so
        # the compile count stays bounded — otherwise every distinct
        # queue length would pay the compile this class exists to prevent
        n = len(xs)
        nb = 1 << (n - 1).bit_length()
        fn = self._ensure_fn()
        padded = [np.pad(x, (0, b - len(x)), mode="reflect")
                  if len(x) < b else x for x in xs]
        padded += [padded[-1]] * (nb - n)
        X = np.stack(padded)
        out = fn(jnp.asarray(X, dtype=self.dtype))

        results = [dict() for _ in xs]
        for k, v in out.items():
            a = np.asarray(v)
            for i, x in enumerate(xs):
                cols = self._out_cols(k, len(x), b, v)
                results[i][k] = a[i, ..., :cols]
        for r in results:
            r.update(self._meta.get(b, {}))
        return results

    def _out_cols(self, name, N, bucket, v):
        n_out = v.shape[-1]
        if n_out == bucket:          # hop 1 / cwt: one column per sample
            return N
        # hop > 1: the transform emits one column per hop starting at
        # sample 0, so a direct transform of length N has exactly
        # (N-1)//hop + 1 columns (ops/stft.py frame count).
        hop = int(self.kw.get("hop_len", 1))
        return min(n_out, (N - 1) // hop + 1)
