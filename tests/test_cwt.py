"""CWT forward/inverse round-trip tests (mirrors
old/tests/reconstruction_test.py:89-123)."""
import numpy as np
import pytest

from ssqueeze_rs_tpu import cwt, icwt, mad_rms, Wavelet

WAVELET = ("gmw", {"beta": 8.0})
TH = 0.1


def _t(tmin, tmax, N):
    return np.linspace(tmin, tmax, N, endpoint=False)


def echirp(N):
    t = _t(0, 10, N)
    return np.cos(2 * np.pi * 3 * np.exp(t / 3)), t


def lchirp(N):
    t = _t(0, 10, N)
    return np.cos(np.pi * t**2), t


def _freqs(N, freqs):
    from ssqueeze_rs_tpu.toolkit import cos_f
    x = cos_f(freqs, N // len(freqs))
    ts = _t(0, len(x) / N, len(x))
    return x, ts


def fast_transitions(N):
    return _freqs(N, np.array([N/100, N/200, N/3, N/20,
                               N/3 - 1, N/50, N/4, N/150]) / 8)


def low_freqs(N):
    return _freqs(N, [.3, .3, 1, 1, 2, 2])


def high_freqs(N):
    return _freqs(N, np.array([N/2, N/2 - 1, N/4, N/3]) / 4)


TEST_FNS = (echirp, lchirp, fast_transitions, low_freqs, high_freqs)


@pytest.mark.parametrize("fn", TEST_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("l1_norm", [True, False], ids=["l1", "l2"])
def test_cwt_roundtrip(fn, l1_norm):
    """(reference: reconstruction_test.py:89-107, th=.1)"""
    x, ts = fn(2048)
    scales = ("log:maximal" if fn.__name__ in ("low_freqs", "high_freqs")
              else "log")
    kw = dict(wavelet=WAVELET, scales=scales, l1_norm=l1_norm, nv=32)
    Wx, *_ = cwt(x, t=ts, dtype="float64", **kw)
    xrec = np.asarray(icwt(Wx, one_int=True, **kw))
    err = mad_rms(x, xrec)
    assert err < TH, (err, fn.__name__, l1_norm)


def test_cwt_log_piecewise_roundtrip():
    """(reference: reconstruction_test.py:111-123, th=.02)"""
    x, ts = echirp(1024)
    Wx, scales = cwt(x, "gmw", scales="log-piecewise", t=ts, dtype="float64")
    xrec = np.asarray(icwt(Wx, "gmw", scales=scales))
    err = mad_rms(x, xrec)
    assert err < 0.02, err


def test_cwt_batched_equals_loop():
    """(mirrors old/tests/fft_test.py:559-633 batched equivalence)"""
    rng = np.random.default_rng(5)
    X = rng.standard_normal((3, 512))
    Wb, scales = cwt(X, WAVELET, scales="log", dtype="float64")
    for i in range(3):
        Wi, _ = cwt(X[i], WAVELET, scales="log", dtype="float64")
        assert np.allclose(np.asarray(Wb[i]), np.asarray(Wi)), i


def test_cwt_derivative_matches_fd():
    """dWx should approximate time-derivative of Wx (interior, smooth sig)."""
    N, fs = 1024, 1024.0
    t = np.arange(N) / fs
    x = np.cos(2 * np.pi * 50 * t)
    Wx, scales, dWx = cwt(x, WAVELET, scales="log", fs=fs, derivative=True,
                          dtype="float64")
    Wx, dWx = np.asarray(Wx), np.asarray(dWx)
    fd = np.gradient(Wx, 1 / fs, axis=-1)
    mid = np.abs(Wx).max(axis=1) > 0.3 * np.abs(Wx).max()
    num = np.abs(dWx[mid][:, 100:-100] - fd[mid][:, 100:-100]).mean()
    den = np.abs(dWx[mid][:, 100:-100]).mean()
    assert num / den < 0.05, num / den


def test_cwt_two_integral_inverse():
    x, ts = echirp(1024)
    kw = dict(wavelet=WAVELET, scales="log", nv=32)
    Wx, scales = cwt(x, t=ts, dtype="float64", **kw)
    xrec = np.asarray(icwt(Wx, WAVELET, scales="log", one_int=False,
                           x_len=len(x)))
    err = mad_rms(x, xrec)
    assert err < 0.12, err


def test_cwt_higher_order():
    x, ts = echirp(1024)
    Wx0, scales = cwt(x, "gmw", scales="log", t=ts, dtype="float64")
    Wx1, _ = cwt(x, "gmw", scales="log", t=ts, order=1, dtype="float64")
    assert Wx1.shape == Wx0.shape
    Wavg, _ = cwt(x, "gmw", scales="log", t=ts, order=(0, 1), dtype="float64")
    assert Wavg.shape == Wx0.shape
    # averaged must differ from order-0 but correlate strongly
    a = np.abs(np.asarray(Wx0)).ravel()
    b = np.abs(np.asarray(Wavg)).ravel()
    assert not np.allclose(a, b)
    assert np.corrcoef(a, b)[0, 1] > 0.9


def test_icwt_two_integral_batched():
    """Batched two-integral icwt == per-row (VERDICT r1 weak #5)."""
    from ssqueeze_rs_tpu import cwt, icwt

    rng = np.random.default_rng(9)
    X = rng.standard_normal((3, 512))
    wav = ("gmw", {"beta": 8.0})
    Wx, sc = cwt(X, wav, scales="log", dtype="float64")
    xb = np.asarray(icwt(Wx, wav, scales=np.asarray(sc).reshape(-1, 1),
                         one_int=False, x_len=512))
    assert xb.shape == X.shape
    for i in range(3):
        xi = np.asarray(icwt(np.asarray(Wx)[i], wav,
                             scales=np.asarray(sc).reshape(-1, 1),
                             one_int=False, x_len=512))
        assert np.allclose(xb[i], xi, atol=1e-12)


def test_icwt_log_piecewise_x_mean_added_once():
    """x_mean is added exactly once for log-piecewise scales (the
    reference's recursion adds it per segment, _cwt.py:421-427 —
    documented divergence / bug fix, code-review r3)."""
    t = np.linspace(0, 10, 1024, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    Wx, scales = cwt(x, "gmw", scales="log-piecewise", dtype="float64")
    x0 = np.asarray(icwt(Wx, "gmw", scales="log-piecewise", x_mean=0.0))
    x5 = np.asarray(icwt(Wx, "gmw", scales="log-piecewise", x_mean=5.0))
    assert np.allclose(x5 - x0, 5.0)
