"""ctypes bindings for the native host runtime (native/ssq_native.cpp).

Provides:
  * `MappedRecording` — memory-mapped multichannel recording with
    halo-overlapped chunk reads (the host-side feeder for sharded
    long-signal pipelines; replaces the reference's dask/pyarrow ingestion,
    tests/stft_test.py:374-377),
  * `reassign_cpu` — OpenMP fused reassignment oracle,
  * `tkeo_cpu` / `tkeo_modified_cpu`.

The library is built on demand (`make -C native`); every entry point
degrades gracefully to pure numpy when the .so is unavailable.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libssq_native.so"
_lib = None


def _load(build: bool = True):
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists() and build:
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
        except Exception:
            return None
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))

    lib.ssq_open.restype = ctypes.c_void_p
    lib.ssq_open.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                             ctypes.c_int32]
    lib.ssq_n_samples.restype = ctypes.c_int64
    lib.ssq_n_samples.argtypes = [ctypes.c_void_p]
    lib.ssq_close.argtypes = [ctypes.c_void_p]
    lib.ssq_read_chunk_f32.restype = ctypes.c_int
    lib.ssq_read_chunk_f32.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float)]
    lib.ssq_reassign_f64.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_double, ctypes.c_double,
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_double)]
    lib.ssq_tkeo_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    lib.ssq_tkeo_mod_f32.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float)]
    lib.ssq_prefetch_start.restype = ctypes.c_void_p
    lib.ssq_prefetch_start.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_int64, ctypes.c_int32]
    lib.ssq_prefetch_next.restype = ctypes.c_int64
    lib.ssq_prefetch_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64)]
    lib.ssq_prefetch_stop.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _fptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class MappedRecording:
    """Memory-mapped channel-major float32/float64 recording with
    halo-overlapped chunk reads (reflect boundary)."""

    def __init__(self, path, n_channels: int, dtype="float32"):
        lib = _load()
        if lib is None:
            raise RuntimeError("native library unavailable (g++/make "
                               "missing?)")
        self._lib = lib
        code = 0 if np.dtype(dtype) == np.float32 else 1
        self._h = lib.ssq_open(str(path).encode(), n_channels, code)
        if not self._h:
            raise OSError(f"could not map {path}")
        self.n_channels = n_channels
        self.n_samples = lib.ssq_n_samples(self._h)
        self.dtype = np.dtype(dtype)

    def read_chunk(self, start: int, chunk_len: int, halo_left: int = 0,
                   halo_right: int = 0) -> np.ndarray:
        """(n_channels, halo_left + chunk_len + halo_right) float32."""
        if self.dtype != np.float32:
            raise NotImplementedError("chunk reads are float32")
        ext = halo_left + chunk_len + halo_right
        out = np.empty((self.n_channels, ext), np.float32)
        rc = self._lib.ssq_read_chunk_f32(
            self._h, start, chunk_len, halo_left, halo_right,
            _fptr(out, ctypes.c_float))
        if rc != 0:
            raise RuntimeError("ssq_read_chunk_f32 failed")
        return out

    def iter_chunks(self, chunk_len: int, halo: int):
        """Yield (start, chunk_with_halos) across the recording."""
        start = 0
        while start < self.n_samples:
            cl = min(chunk_len, self.n_samples - start)
            yield start, self.read_chunk(start, cl, halo, halo)
            start += chunk_len

    def iter_chunks_prefetch(self, chunk_len: int, halo: int,
                             depth: int = 3):
        """Like `iter_chunks` but fed by the native double-buffered
        prefetch scheduler: a C++ worker thread reads + reflect-pads the
        next chunks into a `depth`-slot ring while the consumer computes —
        host IO overlaps device compute (the dask threaded-scheduler
        analog). Yields (start, chunk) with `chunk` a fresh numpy array.
        """
        if self.dtype != np.float32:
            raise NotImplementedError("prefetch reads are float32")
        lib = self._lib
        p = lib.ssq_prefetch_start(self._h, chunk_len, halo, depth)
        if not p:
            raise RuntimeError("ssq_prefetch_start failed")
        try:
            buf = ctypes.POINTER(ctypes.c_float)()
            clen = ctypes.c_int64()
            while True:
                start = lib.ssq_prefetch_next(p, ctypes.byref(buf),
                                              ctypes.byref(clen))
                if start < 0:
                    break
                # channel stride in the slot = this chunk's ext (the
                # reader packs channels contiguously per chunk)
                ext = int(clen.value) + 2 * halo
                flat = np.ctypeslib.as_array(
                    buf, shape=(self.n_channels * ext,))
                chunk = flat.reshape(self.n_channels, ext)
                # copy out so the slot can refill while the consumer runs
                yield int(start), np.array(chunk, copy=True)
        finally:
            lib.ssq_prefetch_stop(p)

    def close(self):
        if getattr(self, "_h", None):
            self._lib.ssq_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def reassign_cpu(Wx, dWx, ssq_freqs, const_arr, gamma, mode: str,
                 flipud: bool = False, Sfs=None):
    """Fused reassignment on CPU (OpenMP, column-parallel) — native oracle
    mirroring the reference's fused numba kernels."""
    from .ops.ssqueeze import bin_params

    lib = _load()
    Wx = np.ascontiguousarray(np.asarray(Wx, np.complex128))
    dWx = np.ascontiguousarray(np.asarray(dWx, np.complex128))
    na, n = Wx.shape
    nf = len(ssq_freqs)
    consts = np.ascontiguousarray(
        np.broadcast_to(np.asarray(const_arr, np.float64), (na,)))
    sfs = np.ascontiguousarray(
        np.asarray(Sfs, np.float64) if Sfs is not None
        else np.zeros(na))

    mode_str, params = bin_params(np.asarray(ssq_freqs),
                                  mode.startswith("log"))
    mode_code = {"log": 0, "log-piecewise": 1, "lin": 2}[mode_str]
    if mode_code == 0:
        p = (params["vlmin"], params["dvl"], 0.0, 0.0, 0)
    elif mode_code == 1:
        p = (params["vlmin0"], params["vlmin1"], params["dvl0"],
             params["dvl1"], int(params["idx1"]))
    else:
        p = (params["vmin"], params["dv"], 0.0, 0.0, 0)

    if lib is None:
        # fallback via the jnp engine, pinned to the CPU in float64 so it
        # stays an oracle independent of the accelerator
        import jax
        import jax.numpy as jnp
        from .ops.ssqueeze import reassign
        with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
            params_j = {k: (jnp.asarray(v) if k != "idx1" else
                            jnp.asarray(v, jnp.int32))
                        for k, v in params.items()}
            out = reassign(
                jnp.asarray(Wx), jnp.asarray(dWx), jnp.asarray(consts),
                jnp.asarray(float(gamma)), jnp.asarray(sfs), params_j,
                mode=mode_str, flipud=flipud, fused=True,
                transform="stft" if Sfs is not None else "cwt", nf=nf)
            return np.asarray(out)

    out = np.zeros((nf, n), np.complex128)
    lib.ssq_reassign_f64(
        _fptr(Wx.view(np.float64), ctypes.c_double),
        _fptr(dWx.view(np.float64), ctypes.c_double),
        _fptr(sfs, ctypes.c_double), _fptr(consts, ctypes.c_double),
        na, n, nf, mode_code, int(Sfs is not None), int(flipud),
        float(gamma), float(p[0]), float(p[1]), float(p[2]), float(p[3]),
        int(p[4]), _fptr(out.view(np.float64), ctypes.c_double))
    return out


def tkeo_cpu(x):
    lib = _load()
    x = np.ascontiguousarray(np.atleast_2d(np.asarray(x, np.float32)))
    C, n = x.shape
    if lib is None:
        return x[:, 1:-1] ** 2 - x[:, :-2] * x[:, 2:]
    out = np.empty((C, n - 2), np.float32)
    lib.ssq_tkeo_f32(_fptr(x, ctypes.c_float), C, n,
                     _fptr(out, ctypes.c_float))
    return out


def tkeo_modified_cpu(x):
    lib = _load()
    x = np.ascontiguousarray(np.atleast_2d(np.asarray(x, np.float32)))
    C, n = x.shape
    if lib is None:
        return x[:, 2:-1] * x[:, 1:-2] - x[:, 3:] * x[:, :-3]
    out = np.empty((C, n - 3), np.float32)
    lib.ssq_tkeo_mod_f32(_fptr(x, ctypes.c_float), C, n,
                         _fptr(out, ctypes.c_float))
    return out
