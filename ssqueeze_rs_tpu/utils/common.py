"""Small shared helpers (host-side).

Reference behaviors covered: old/ssqueezepy/utils/common.py (WARN, p2up, mad),
old/ssqueezepy/toolkit.py:38-42 (mad_rms).
"""
from __future__ import annotations

import logging

import numpy as np

_logger = logging.getLogger("ssqueeze_rs_tpu")
if not _logger.handlers:        # never touch the host app's root logger
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(message)s"))
    _logger.addHandler(_h)
    _logger.propagate = False


def WARN(msg: str):
    _logger.warning("WARNING: %s", msg)


def NOTE(msg: str):
    _logger.warning("NOTE: %s", msg)


def device_memory_limit():
    """Bytes this process may allocate on its first local device
    (`memory_stats()["bytes_limit"]`), or None where the device does not
    report it (the CPU backend): nothing is assumed for such a device."""
    import jax
    stats = jax.local_devices()[0].memory_stats() or {}
    return stats.get("bytes_limit")


def warn_hbm_budget(N, na, batch=1, derivative=False, what="cwt"):
    """Friendly heads-up before an opaque device OOM. A single-shot CWT
    keeps about two (na, N) complex64 arrays per channel (six for the
    synchrosqueezed path: Wx, dWx, the scatter's values, bins and Tx)
    plus the iFFT's padded-length spectra, which `ops.cwt` blocks over
    scales to at most half of the device's limit."""
    from .pad import p2up
    limit = device_memory_limit()
    if limit is None:
        return
    per = int(batch) * int(na) * 8
    spectra = 3 * per * p2up(int(N))[0] * (2 if derivative else 1)
    est = per * int(N) * (6 if derivative else 2) + min(spectra, limit / 2)
    if est > limit:
        WARN(f"single-shot {what} needs ~{est / 1e9:.0f} GB of device "
             f"memory at N={N}, na={na}, batch={batch} (the device allows "
             f"{limit / 1e9:.0f} GB); consider parallel.process_recording "
             "or parallel.chunked_cwt")


def assert_is_one_of(x, name, supported, e=ValueError):
    if x not in supported:
        raise e(f"`{name}` must be one of: {', '.join(map(str, supported))} (got {x})")


def mad(data, axis=None):
    """Mean absolute deviation. (reference: utils/common.py:297-300)"""
    data = np.asarray(data)
    return np.mean(np.abs(data - np.mean(data, axis)), axis)


def mad_rms(x, xrec):
    """Reconstruction error metric used by all inversion tests.

    mean|x - xrec| / rms(x)  (reference: old/ssqueezepy/toolkit.py:38-42)
    """
    x = np.asarray(x)
    xrec = np.asarray(xrec)
    return float(np.mean(np.abs(x - xrec)) / np.sqrt(np.mean(x**2)))


def est_riskshrink_thresh(Wx, nv):
    """RiskShrink hard-threshold estimate (reference: utils/common.py:248-276)."""
    Wx = np.asarray(Wx)
    N = Wx.shape[-1]
    Wx_fine = np.abs(Wx[..., :nv, :])
    return 1.4826 * np.sqrt(2 * np.log(N)) * mad(Wx_fine)


# -- replacers (reference: algos.py:451-557) ----------------------------------
# Vectorized (numpy/jnp `where`) instead of the reference's numba triple
# loops + CUDA kernels; dispatch on input type, pure (no in-place mutation).
def _xp_of(x):
    import jax.numpy as jnp
    import jax
    return jnp if isinstance(x, jax.Array) else np


def replace_at_inf_or_nan(x, ref=None, replacement=0.):
    """x[isinf(ref) | isnan(ref)] = replacement (ref defaults to x)."""
    xp = _xp_of(x)
    ref = x if ref is None else ref
    return xp.where(xp.isinf(ref) | xp.isnan(ref), replacement, x)


def replace_at_inf(x, ref=None, replacement=0.):
    xp = _xp_of(x)
    ref = x if ref is None else ref
    return xp.where(xp.isinf(ref), replacement, x)


def replace_at_nan(x, ref=None, replacement=0.):
    xp = _xp_of(x)
    ref = x if ref is None else ref
    return xp.where(xp.isnan(ref), replacement, x)


def replace_at_value(x, ref=None, value=0., replacement=0.):
    """Note: `value=np.nan` won't match (use `replace_at_nan`)."""
    xp = _xp_of(x)
    ref = x if ref is None else ref
    return xp.where(ref == value, replacement, x)


def replace_under_abs(x, ref=None, value=0., replacement=0., parallel=None):
    """x[|ref| < value] = replacement; `parallel` accepted for reference
    API parity (vectorization subsumes it)."""
    xp = _xp_of(x)
    ref = x if ref is None else ref
    return xp.where(xp.abs(ref) < value, replacement, x)


def find_closest_parallel_is_faster(shape, dtype="float32", trials=7,
                                    verbose=1):
    """Reference CPU-tuning helper (common.py:279-296): times
    find_closest(parallel=True) vs False. This framework has no
    parallel toggle — XLA owns parallelization — so the brute search is
    timed once for information and False is returned (there is no
    faster 'parallel' variant to pick).
    """
    from timeit import timeit

    import numpy as np

    from .closest import find_closest

    a = np.abs(np.random.randn(*shape).astype(dtype))
    v = np.random.uniform(0, len(a), len(a)).astype(dtype)
    t = timeit(lambda: find_closest(a, v), number=int(trials))
    if verbose:
        NOTE(f"find_closest: {t / trials:.3g} s/call on {shape} {dtype}; "
             "no parallel toggle exists (XLA-parallel), returning False")
    return False
