"""Drop-in `_rs` API surface tests (reference: src/ssqueeze/_rs.pyi)."""
import numpy as np
import pytest

from ssqueeze_rs_tpu import compat as _rs
from ssqueeze_rs_tpu import mad_rms


def test_stft_signature_and_freqs():
    x = np.random.randn(1000)
    window = np.hanning(257)[:-1]
    Sx, freqs = _rs.stft(x, 256, 64, window, "reflect")
    assert Sx.shape == (129, (1000 - 1) // 64 + 1)
    assert np.allclose(freqs, np.linspace(0, 0.5, 129))
    # unmodulated (rust semantics)
    from ssqueeze_rs_tpu import stft
    ref = np.asarray(stft(x, window=window, n_fft=256, hop_len=64,
                          modulated=False, dtype="float64"))
    assert np.allclose(Sx, ref)


def test_cwt_and_icwt_roundtrip():
    t = np.linspace(0, 10, 2048, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    # Rust PyO3 contract: ALWAYS a 3-tuple, dWx None unless derivative
    Wx, scales, dWx = _rs.cwt(x, "gmw", nv=32)
    assert dWx is None
    assert Wx.shape[1] == len(x)
    assert len(scales) == Wx.shape[0]
    # rust default grid: endpoint-inclusive log 2 -> N/2
    # (cwt.rs:461-489: num = ceil(octaves*nv), step = octaves/(num-1))
    assert np.isclose(scales[0], 2.0)
    assert np.isclose(scales[-1], len(x) / 2)
    octaves = np.log2(len(x) / 4)
    assert len(scales) == int(np.ceil(octaves * 32))
    xr = _rs.icwt(Wx, "gmw", scales=scales)
    assert mad_rms(x, xr) < 0.2

    # cwt_simd is an alias
    Wx2, _, _ = _rs.cwt_simd(x, "gmw", nv=32)
    assert np.allclose(Wx, Wx2)


def test_ssq_cwt_returns_pair():
    t = np.linspace(0, 1, 1024, endpoint=False)
    x = np.cos(2 * np.pi * 100 * t)
    Tx, ssq_freqs = _rs.ssq_cwt(x, "gmw", fs=1024.0)
    assert Tx.shape[1] == len(x)
    assert len(ssq_freqs) == Tx.shape[0]


def test_ssq_stft_returns_pair():
    x = np.random.randn(512)
    window = np.hanning(129)[:-1]
    Tx, freqs = _rs.ssq_stft(x, window, n_fft=128)
    assert Tx.shape == (65, 512)
    assert len(freqs) == 65


def test_wavelet_functions():
    w = np.linspace(0, 20, 500)
    # morlet peak near mu
    m = _rs.morlet(w, mu=6.0)
    assert abs(w[np.argmax(m)] - 6.0) < 0.1
    # gmw peak value 2 exactly at wc (L1)
    wc = _rs.gmw_center_frequency(3.0, 60.0, kind="peak")
    g_at_wc = _rs.gmw(np.array([wc]), gamma=3.0, beta=60.0)
    assert abs(g_at_wc[0] - 2.0) < 1e-9
    assert np.isclose(wc, (60.0 / 3.0) ** (1 / 3.0))

    pf = _rs.gmw_freq(n=512, scale=8.0)
    assert pf.shape == (512,)
    pt = _rs.gmw_time(n=512, scale=8.0)
    assert pt.shape == (512,)
    # time-domain wavelet is centered
    assert abs(np.argmax(np.abs(pt)) - 256) <= 1

    mt = _rs.morlet_time(n=512, scale=8.0, mu=6.0)
    assert abs(np.argmax(np.abs(mt)) - 256) <= 1


def test_pad_signal():
    x = np.arange(1.0, 5.0)
    xp = _rs.pad_signal(x, "reflect", padlength=11)
    assert len(xp) == 11


def test_hello():
    assert "JAX" in _rs.hello_from_bin()
