"""Synchrosqueezing round-trip tests (mirrors
old/tests/reconstruction_test.py:63-157,183-206)."""
import numpy as np
import pytest

from ssqueeze_rs_tpu import (ssq_cwt, issq_cwt, ssq_stft, issq_stft,
                             mad_rms, get_window)
from ssqueeze_rs_tpu.toolkit import lin_band, cos_f

from test_cwt import (echirp, lchirp, fast_transitions, low_freqs,
                      high_freqs, TEST_FNS)

WAVELET = ("gmw", {"beta": 8.0})
TH = 0.1


@pytest.mark.parametrize("fn", TEST_FNS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("scales", ["log", "log-piecewise", "linear"])
def test_ssq_cwt_roundtrip(fn, scales):
    """(reference: reconstruction_test.py:63-85, th=.1)"""
    x, ts = fn(2048)
    if fn.__name__ == "low_freqs":
        if scales == "linear":
            pytest.skip("'linear' can't handle low freqs for large N "
                        "(reference skip)")
        scales = f"{scales}:maximal"
    Tx, *_ = ssq_cwt(x, WAVELET, scales=scales, nv=32, t=ts, dtype="float64")
    xrec = np.asarray(issq_cwt(Tx, WAVELET))
    err = mad_rms(x, xrec)
    assert err < TH, (err, fn.__name__, scales)


def test_ssq_cwt_log_piecewise():
    """(reference: reconstruction_test.py:111-123, th=.02)"""
    x, ts = echirp(1024)
    Tx, Wx, ssq_freqs, scales, *_ = ssq_cwt(x, "gmw", scales="log-piecewise",
                                            t=ts, preserve_transform=True,
                                            dtype="float64")
    xrec = np.asarray(issq_cwt(Tx, "gmw"))
    err = mad_rms(x, xrec)
    assert err < 0.02, err


def test_component_inversion():
    """(reference: reconstruction_test.py:126-157)"""
    def echirp1(N):
        t = np.linspace(0, 10, N, False)
        return np.cos(2 * np.pi * np.exp(t / 3)), t

    N, noise_var = 2048, 6
    x, ts = echirp1(N)
    x *= (1 + .3 * cos_f([1], N))
    xo = x.copy()
    rng = np.random.RandomState(4)
    x = x + np.sqrt(noise_var) * rng.randn(len(x))

    wavelet = ("gmw", {"beta": 6.0})
    Tx, *_ = ssq_cwt(x, wavelet, scales="log:maximal", nv=32, t=ts,
                     flipud=False, dtype="float64")
    bw, slope, offset = .035, .44, .45
    Cs, freqband = lin_band(Tx, slope, offset, bw)
    xrec = np.asarray(issq_cwt(Tx, wavelet, Cs, freqband))[0]

    axof = np.abs(np.fft.rfft(xo))
    axrecf = np.abs(np.fft.rfft(xrec))
    err_sig = mad_rms(xo, xrec)
    err_spc = mad_rms(axof, axrecf)
    assert err_sig <= .40, err_sig
    assert err_spc <= .10, err_spc


def test_ssq_stft_roundtrip():
    """(reference: reconstruction_test.py:183-206, th=.1)"""
    th = 1e-1
    rng = np.random.default_rng(0)
    for N in (128, 129):
        x = rng.standard_normal(N)
        for n_fft in (120, 121):
            for window_scaling in (1.0, 0.5):
                if window_scaling == 1:
                    window = None
                else:
                    window = get_window(None, win_len=n_fft, n_fft=n_fft)
                    window = window * window_scaling
                Tx, *_ = ssq_stft(x, window=window, n_fft=n_fft,
                                  dtype="float64")
                xr = np.asarray(issq_stft(Tx, window=window, n_fft=n_fft))
                txt = f"(N, n_fft, ws) = ({N}, {n_fft}, {window_scaling})"
                assert len(x) == len(xr), txt
                mae = np.abs(x - xr).mean()
                assert mae < th, f"MAE = {mae:.2e} > {th:.0e} {txt}"


def test_ssq_cwt_batched_equals_loop():
    """(mirrors old/tests/fft_test.py:559-633)"""
    rng = np.random.default_rng(7)
    X = rng.standard_normal((2, 512))
    Txb, *_ = ssq_cwt(X, WAVELET, scales="log", dtype="float64")
    for i in range(2):
        Txi, *_ = ssq_cwt(X[i], WAVELET, scales="log", dtype="float64")
        assert np.allclose(np.asarray(Txb[i]), np.asarray(Txi),
                           atol=1e-12), i


def test_ssq_cwt_get_w_matches_fused():
    """Two-step (w precomputed) vs fused phase+bin+scatter: identical Tx
    (mirrors old/tests/fft_test.py:351-377)."""
    x, ts = echirp(512)
    Tx_fused, *_ = ssq_cwt(x, WAVELET, scales="log", t=ts, dtype="float64")
    Tx_2step, *rest = ssq_cwt(x, WAVELET, scales="log", t=ts, get_w=True,
                              dtype="float64")
    assert np.allclose(np.asarray(Tx_fused), np.asarray(Tx_2step), atol=1e-12)


def test_ssq_cwt_squeezing_modes():
    x, ts = echirp(512)
    for squeezing in ("sum", "lebesgue", "abs"):
        Tx, *_ = ssq_cwt(x, WAVELET, scales="log", t=ts, squeezing=squeezing,
                         dtype="float64")
        assert np.isfinite(np.asarray(Tx)).all(), squeezing
    # custom callable
    Tx, *_ = ssq_cwt(x, WAVELET, scales="log", t=ts,
                     squeezing=lambda W: W**2, dtype="float64")
    assert np.isfinite(np.asarray(Tx)).all()


def test_ssq_freqs_flip_consistency():
    x, ts = echirp(512)
    Tx0, _, f0, _ = ssq_cwt(x, WAVELET, scales="log", t=ts, flipud=False,
                            dtype="float64")
    Tx1, _, f1, _ = ssq_cwt(x, WAVELET, scales="log", t=ts, flipud=True,
                            dtype="float64")
    # flipud flips row placement; ssq_freqs is flipped in BOTH cases for cwt
    # (reference: ssqueezing.py:217-223)
    assert np.allclose(np.asarray(Tx0), np.asarray(Tx1)[::-1])
    assert np.allclose(f0, f1)


def test_ssq_cwt_maprange_modes():
    x, ts = echirp(1024)
    for maprange in ("peak", "energy", "maximal", (0.05, 0.5)):
        scales = "log"  # maximal+log ok; log-piecewise invalid for maximal
        Tx, *_ = ssq_cwt(x, WAVELET, scales=scales, t=ts, maprange=maprange,
                         dtype="float64")
        assert np.isfinite(np.asarray(Tx)).all(), maprange


def test_ssq_cwt_numeric_requires_padded_first_order():
    """difftype='numeric' with padtype=None or order>0 fails loudly (the
    reference silently returns truncated output — code-review r3)."""
    import pytest
    x = np.random.default_rng(0).standard_normal(256)
    with pytest.raises(ValueError, match="numeric"):
        ssq_cwt(x, difftype="numeric", get_w=True, padtype=None)
    with pytest.raises(ValueError, match="numeric"):
        ssq_cwt(x, difftype="numeric", get_w=True, order=1)
    # the supported combo still works and is exactly N wide
    Tx, Wx, *_ = ssq_cwt(x, difftype="numeric", get_w=True)
    assert Wx.shape[-1] == 256 and Tx.shape[-1] == 256


def test_ssqueeze_rejects_negative_w():
    """Reference guard: negatives in a caller-supplied `w` raise instead
    of NaN-corrupting bin indices (code-review r3)."""
    import pytest
    from ssqueeze_rs_tpu import ssqueeze
    Wx = np.ones((4, 16), dtype=np.complex128)
    w = np.full((4, 16), 0.1)
    w[2, 3] = -0.5
    with pytest.raises(ValueError, match="negatives"):
        ssqueeze(Wx, w, np.linspace(0.01, 0.5, 4), np.logspace(0, 1, 4),
                 transform="cwt")
