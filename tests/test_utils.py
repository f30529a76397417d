"""Unit tests: grids, padding, windows (reference formulas)."""
import numpy as np
import pytest

from ssqueeze_rs_tpu.utils import (xifn, p2up, padsignal, pad_params,
                                   get_window, window_norm)
from ssqueeze_rs_tpu.utils.fft import aifftshift_idx, afftshift_idx


def test_xifn_even_odd():
    # reference convention: positive Nyquist bin (wavelets.py:472-483)
    xi = xifn(1, 8)
    h = 2 * np.pi / 8
    assert np.allclose(xi, np.array([0, 1, 2, 3, 4, -3, -2, -1]) * h)
    xi = xifn(1, 9)
    h = 2 * np.pi / 9
    assert np.allclose(xi, np.array([0, 1, 2, 3, 4, -4, -3, -2, -1]) * h)
    # scale multiplies
    assert np.allclose(xifn(2.5, 16), 2.5 * xifn(1, 16))


def test_aifftshift_roundtrip():
    for N in (8, 9, 128, 129):
        x = np.random.randn(N)
        idx = aifftshift_idx(N)
        inv = afftshift_idx(N)
        assert np.allclose(x[idx][inv], x)
        # shifted xifn grid must ascend (even N; odd N inherits the
        # reference's np.fft.ifftshift quirk, wavelets.py:954 — unused in
        # practice since planning Ns are powers of 2)
        if N % 2 == 0:
            w = xifn(1, N)[idx]
            assert np.all(np.diff(w) > 0)


def test_p2up():
    # up = 2**(1 + round(log2(n))) — NOT next power of 2
    # (reference: utils/common.py:32-51)
    assert p2up(128) == (256, 64, 64)
    assert p2up(100) == (256, 78, 78)
    assert p2up(129) == (256, 64, 63)
    # n=180: log2=7.49 -> round to 7 -> up=256
    assert p2up(180)[0] == 256
    # n=182: log2=7.508 -> round to 8 -> up=512
    assert p2up(182)[0] == 512


def test_pad_params_parity():
    # even total pad: left == right; odd: left = right + 1
    for N, pl in [(128, 247), (129, 249), (128, 248), (129, 248)]:
        n_up, n1, n2 = pad_params(N, pl)
        assert n1 + n2 + N == pl
        assert n1 - n2 in (0, 1)


@pytest.mark.parametrize("padtype", ["reflect", "zero", "wrap", "replicate",
                                     "symmetric"])
def test_padsignal_modes(padtype):
    x = np.arange(1.0, 5.0)  # [1,2,3,4]
    xp = np.asarray(padsignal(x, padtype, padlength=11))
    expected = {
        "zero": [0, 0, 0, 0, 1, 2, 3, 4, 0, 0, 0],
        "reflect": [3, 4, 3, 2, 1, 2, 3, 4, 3, 2, 1],
        "replicate": [1, 1, 1, 1, 1, 2, 3, 4, 4, 4, 4],
        "wrap": [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3],
        "symmetric": [4, 3, 2, 1, 1, 2, 3, 4, 4, 3, 2],
    }[padtype]
    assert np.allclose(xp, expected), (padtype, xp)


def test_padsignal_batched():
    x = np.random.randn(3, 2, 50)
    xp = np.asarray(padsignal(x, "reflect"))
    assert xp.shape == (3, 2, 128)  # p2up(50) -> 2**(1+round(log2 50)) = 128
    x1 = np.asarray(padsignal(x[1, 1], "reflect"))
    assert np.allclose(xp[1, 1], x1)


def test_window_default_dpss_and_diff():
    w, dw = get_window(None, 64, 64, derivative=True)
    assert len(w) == 64 and len(dw) == 64
    # diff window integrates to ~0 and is odd-ish for symmetric windows
    assert abs(dw.sum()) < 1e-8

    # string window, center-padded to n_fft
    w = get_window("hann", 32, n_fft=64)
    assert len(w) == 64
    assert np.allclose(w[:16], 0)
    assert np.allclose(w[-16:], 0)


def test_window_norm_overlap():
    w = np.ones(8)
    wn = window_norm(w, hop_len=8, n_fft=8, N=32, win_exp=1)
    # non-overlapping unit windows: norm == 1 over each covered stretch
    assert np.allclose(wn[:32], 1)


def test_replacers_match_reference_semantics():
    """(reference: algos.py:451-557) vectorized replacers."""
    import jax.numpy as jnp
    from ssqueeze_rs_tpu.utils.common import (
        replace_at_inf_or_nan, replace_at_inf, replace_at_nan,
        replace_at_value, replace_under_abs)

    x = np.array([1.0, np.inf, np.nan, -np.inf, 0.5, 0.0])
    assert np.array_equal(
        replace_at_inf_or_nan(x.copy(), replacement=9.0),
        np.array([1.0, 9.0, 9.0, 9.0, 0.5, 0.0]))
    assert np.array_equal(
        np.nan_to_num(replace_at_inf(x.copy(), replacement=9.0), nan=-1),
        np.array([1.0, 9.0, -1.0, 9.0, 0.5, 0.0]))
    got = replace_at_nan(x.copy(), replacement=9.0)
    assert got[2] == 9.0 and np.isinf(got[1])
    assert np.array_equal(
        np.nan_to_num(replace_at_value(x.copy(), value=0.5,
                                       replacement=9.0), nan=-1),
        np.nan_to_num(np.array([1.0, np.inf, np.nan, -np.inf, 9.0, 0.0]),
                      nan=-1))
    y = np.array([0.1, -0.05, 2.0])
    assert np.array_equal(replace_under_abs(y, value=0.2, replacement=0.0),
                          np.array([0.0, 0.0, 2.0]))
    # ref argument + jnp dispatch
    ref = np.array([np.nan, 1.0, 1.0])
    assert np.array_equal(replace_at_nan(y, ref=ref, replacement=-1.0),
                          np.array([-1.0, -0.05, 2.0]))
    jy = replace_under_abs(jnp.asarray(y), value=0.2, replacement=0.0)
    assert np.array_equal(np.asarray(jy), np.array([0.0, 0.0, 2.0]))


def test_buffer_unbuffer_oracle_parity():
    """buffer/unbuffer vs the vendored reference (stft_utils.py:20-181)."""
    import sys, types
    _numba = types.ModuleType("numba")

    def _jit(*a, **k):
        if a and callable(a[0]):
            return a[0]

        def deco(f):
            return f
        return deco

    _numba.jit = _jit
    _numba.njit = _jit
    _numba.prange = range
    sys.modules.setdefault("numba", _numba)
    sys.path.insert(0, "/root/reference/old")
    import pytest
    ref = pytest.importorskip("ssqueezepy")
    from ssqueeze_rs_tpu.utils.windows import buffer, unbuffer

    rng = np.random.default_rng(0)
    x = rng.standard_normal(200)
    for seg_len, n_overlap, mod in [(16, 8, False), (17, 12, True),
                                    (32, 31, True)]:
        ours = buffer(x, seg_len, n_overlap, modulated=mod)
        theirs = ref.utils.buffer(x, seg_len, n_overlap, modulated=mod)
        assert np.array_equal(ours, np.asarray(theirs)), (seg_len,
                                                          n_overlap, mod)
    # example from the reference docstring
    xb = buffer(np.arange(10.0), 5, 3)
    assert np.array_equal(xb, np.array([[0, 1, 2, 3, 4],
                                        [2, 3, 4, 5, 6],
                                        [4, 5, 6, 7, 8]]).T)

    xbuf = rng.standard_normal((16, 12))
    w = np.hanning(16)
    for win_exp in (0, 1, 2):
        ours = unbuffer(xbuf, w, 4, 16, N=48, win_exp=win_exp)
        theirs = ref.utils.unbuffer(xbuf, w, 4, 16, N=48, win_exp=win_exp)
        assert np.allclose(ours, np.asarray(theirs), atol=1e-14), win_exp


def test_afftshift_oracle_parity():
    import sys
    sys.path.insert(0, "/root/reference/old")
    import pytest
    ref = pytest.importorskip("ssqueezepy")
    from ssqueeze_rs_tpu.utils.fft import afftshift, aifftshift

    rng = np.random.default_rng(0)
    for N in (16, 17):
        xh = rng.standard_normal(N) + 1j * rng.standard_normal(N)
        assert np.array_equal(afftshift(xh),
                              np.asarray(ref.wavelets.afftshift(xh))), N
        assert np.array_equal(aifftshift(xh),
                              np.asarray(ref.wavelets.aifftshift(xh))), N
        assert np.array_equal(aifftshift(afftshift(xh)), xh), N


def test_window_norm_vectorized_matches_direct():
    """The per-residue prefix-sum path (used when max_hops > 4096) equals
    the direct shift-add loop; cache returns consistent results."""
    from ssqueeze_rs_tpu.utils.windows import window_norm, get_window

    def direct(window, hop, n_fft, N, win_exp):
        wn = np.zeros(N + n_fft - 1, dtype=np.float64)
        wpow = window.astype(np.float64) ** (win_exp + 1)
        for i in range((len(wn) - n_fft) // hop + 1):
            wn[i * hop:i * hop + n_fft] += wpow
        return wn.astype(window.dtype)

    for hop, n_fft, N, exp in [(1, 64, 300000, 1), (3, 64, 20000, 2),
                               (7, 128, 500000, 1), (64, 256, 9000, 0)]:
        w = get_window("hann", n_fft, n_fft, dtype="float64")
        got = window_norm(w, hop, n_fft, N, exp)
        want = direct(w, hop, n_fft, N, exp)
        assert np.allclose(got, want, rtol=1e-12,
                           atol=1e-12 * want.max()), (hop, n_fft, N)
        # second call hits the cache with the same values
        assert np.array_equal(window_norm(w, hop, n_fft, N, exp), got)


def test_fft_global_object_parity(tmp_path):
    """Reference FFT/FFT_GLOBAL surface (fft_utils.py:40-216): stateful
    backend object with patience/planning_timelimit knobs; patience >= 1
    enables the persistent XLA cache (the wisdom analog)."""
    import jax
    from ssqueeze_rs_tpu.utils import FFT, FFT_GLOBAL

    rng = np.random.default_rng(5)
    x = rng.standard_normal(64)

    # method surface delegates to the XLA backend
    assert np.allclose(np.asarray(FFT_GLOBAL.fft(x)), np.fft.fft(x),
                       atol=1e-10)
    assert np.allclose(np.asarray(FFT_GLOBAL.rfft(x)), np.fft.rfft(x),
                       atol=1e-10)
    Xr = np.fft.rfft(x)
    assert np.allclose(np.asarray(FFT_GLOBAL.irfft(Xr, n=64)), x,
                       atol=1e-10)
    assert np.allclose(np.asarray(FFT_GLOBAL.ifft(np.fft.fft(x))), x,
                       atol=1e-10)
    assert np.array_equal(np.asarray(FFT_GLOBAL.fftshift(x)),
                          np.fft.fftshift(x))

    # reference patience semantics: tuple sets planning_timelimit too;
    # invalid values raise
    f = FFT(verbose=0, wisdom_dir=str(tmp_path / "wisdom"))
    assert f.patience == 0 and f.planning_timelimit == 120
    f.patience = (1, 30)
    assert f.patience == 1 and f.planning_timelimit == 30
    with pytest.raises(ValueError):
        f.patience = 7
    with pytest.raises(ValueError):
        f.patience = (0, 10)

    # patience >= 1 turned on the persistent compilation cache at
    # wisdom_dir (the wisdom analog)
    assert f._cache_dir is not None
    assert jax.config.jax_compilation_cache_dir == f._cache_dir
    assert f.save_wisdom() == f._cache_dir
    assert isinstance(f.threads, int) and f.threads >= 1
    assert FFT(verbose=0, threads=3).threads == 3


@pytest.mark.parametrize("env_set", [False, True], ids=["unset", "set"])
def test_persistent_cache_dir(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is set in code;
    unset, the cache goes to one fixed directory inside the checkout."""
    import os
    import jax
    from ssqueeze_rs_tpu import config

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert config._CHECKOUT_CACHE_DIR == os.path.join(root, ".jax_cache")
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    monkeypatch.setattr(config, "_CHECKOUT_CACHE_DIR", str(tmp_path / "c"))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "e"))
        got = config.enable_persistent_cache(directory=str(tmp_path / "x"))
        assert got == str(tmp_path / "e")
        assert all(k != "jax_compilation_cache_dir" for k, _ in calls)
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        got = config.enable_persistent_cache()
        assert got == str(tmp_path / "c")
        assert ("jax_compilation_cache_dir", got) in calls
    assert os.path.isdir(got)
