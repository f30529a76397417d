"""Multi-device sharding tests on an 8-device virtual CPU mesh.

The reference never tests multi-node (it has none); these validate the
halo-exchange semantics this build adds (SURVEY §4 implication).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ssqueeze_rs_tpu import stft, cwt, ssq_cwt, ssq_stft
from ssqueeze_rs_tpu.parallel import (make_mesh, shard_batch, chunked_stft,
                                      chunked_cwt, chunked_ssq_cwt,
                                      chunked_ssq_stft)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


@pytest.fixture(scope="module")
def mesh():
    return make_mesh((1, 8), ("data", "time"))


@pytest.fixture(scope="module")
def mesh2x4():
    return make_mesh((2, 4), ("data", "time"))


def test_chunked_stft_bit_exact(mesh):
    """Sharded STFT == single-device STFT, bit-for-bit."""
    rng = np.random.default_rng(0)
    N = 2048
    x = rng.standard_normal(N)
    kw = dict(window="hann", n_fft=256, hop_len=64, dtype="float64")
    ref = np.asarray(stft(x, modulated=True, **kw))
    out = np.asarray(chunked_stft(x, mesh, modulated=True, **kw))
    assert out.shape == ref.shape
    assert np.array_equal(out, ref), np.abs(out - ref).max()


def test_chunked_stft_derivative_bit_exact(mesh):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(1024)
    kw = dict(window="hann", n_fft=128, hop_len=16, fs=500.0,
              dtype="float64")
    Sr, dSr = stft(x, derivative=True, **kw)
    So, dSo = chunked_stft(x, mesh, derivative=True, **kw)
    assert np.array_equal(np.asarray(So), np.asarray(Sr))
    assert np.array_equal(np.asarray(dSo), np.asarray(dSr))


def test_chunked_cwt_interior_accuracy(mesh):
    """Hybrid chunked CWT (default exact=True): matches the full
    transform to <1e-5 on ALL rows — rows whose kernel exceeds the halo
    take the replicated global-FFT path (VERDICT r1 #3; beats the
    reference's silent fixed-overlap approximation,
    tests/cwt_test.py:186-196)."""
    rng = np.random.default_rng(2)
    N = 4096
    t = np.arange(N) / N
    x = np.cos(2 * np.pi * 64 * t) + 0.5 * np.cos(2 * np.pi * 300 * t)
    wav = ("gmw", {"beta": 8.0})
    Wr, scales = cwt(x, wav, scales="log", dtype="float64")
    Wo, scales_o = chunked_cwt(x, mesh, wavelet=wav, scales="log",
                               dtype="float64")
    assert np.allclose(scales, scales_o)
    Wr, Wo = np.asarray(Wr), np.asarray(Wo)
    assert Wo.shape == Wr.shape
    err = np.abs(Wo - Wr)
    ref_mag = np.abs(Wr).max()
    assert err.max() / ref_mag < 1e-5, err.max() / ref_mag

    # pure overlap-save (exact=False): the documented edge tolerance
    Wo2, _ = chunked_cwt(x, mesh, wavelet=wav, scales="log",
                         dtype="float64", exact=False)
    err2 = np.abs(np.asarray(Wo2) - Wr)
    assert err2.max() / ref_mag < 5e-2, err2.max() / ref_mag
    assert err2[: len(scales) // 2].max() / ref_mag < 1e-4


def test_chunked_ssq_cwt_runs_and_inverts(mesh):
    from ssqueeze_rs_tpu import issq_cwt, mad_rms
    N = 2048
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    wav = ("gmw", {"beta": 8.0})
    Tx, Wx, ssq_freqs, scales = chunked_ssq_cwt(
        x, mesh, wavelet=wav, scales="log", fs=N / 10, dtype="float64")
    xrec = np.asarray(issq_cwt(Tx, wav))
    err = mad_rms(x, xrec)
    assert err < 0.12, err


def test_chunked_ssq_cwt_matches_full(mesh):
    """Tx from sharded pipeline ~ single-device ssq_cwt (same planning)."""
    N = 2048
    t = np.linspace(0, 10, N, endpoint=False)
    x = np.cos(2 * np.pi * 3 * np.exp(t / 3))
    wav = ("gmw", {"beta": 8.0})
    fs = N / 10
    Tr, *_ = ssq_cwt(x, wav, scales="log", fs=fs, dtype="float64")
    To, *_ = chunked_ssq_cwt(x, mesh, wavelet=wav, scales="log", fs=fs,
                             dtype="float64")
    Tr, To = np.asarray(Tr), np.asarray(To)
    assert To.shape == Tr.shape
    # bin indices are sensitive to ulp-level Wx differences (mass moves one
    # row), so compare marginals + reconstructions, not elementwise Tx
    col_r = np.abs(Tr).sum(axis=0)
    col_o = np.abs(To).sum(axis=0)
    # (256-sample chunks cap the halo at S-1; largest-scale wavelets span
    # more — this is the documented overlap-save edge tolerance, which
    # shrinks as chunk length grows)
    assert np.abs(col_o - col_r).mean() / col_r.mean() < 5e-2
    from ssqueeze_rs_tpu import issq_cwt, mad_rms
    xr_full = np.asarray(issq_cwt(Tr, wav))
    xr_shard = np.asarray(issq_cwt(To, wav))
    assert mad_rms(xr_full, xr_shard) < 5e-2


def test_chunked_ssq_stft_matches_full(mesh):
    rng = np.random.default_rng(3)
    N = 1024
    x = rng.standard_normal(N)
    kw = dict(n_fft=128, fs=1000.0, dtype="float64")
    Tr, Sr, *_ = ssq_stft(x, **kw)
    To, So, *_ = chunked_ssq_stft(x, mesh, **kw)
    assert np.array_equal(np.asarray(So), np.asarray(Sr))
    assert np.allclose(np.asarray(To), np.asarray(Tr), atol=1e-12)


def test_batch_and_time_sharding(mesh2x4):
    """2-way batch x 4-way time: batched chunked ssq_cwt equals per-row."""
    rng = np.random.default_rng(4)
    B, N = 2, 1024
    X = rng.standard_normal((B, N))
    wav = ("gmw", {"beta": 8.0})
    Xs = shard_batch(X, mesh2x4, "data")
    Tb, Wb, fb, sb = chunked_ssq_cwt(Xs, mesh2x4, wavelet=wav, scales="log",
                                     dtype="float64",
                                     batch_axis_name="data")
    Tb = np.asarray(Tb)
    for i in range(B):
        Ti, *_ = chunked_ssq_cwt(X[i], make_mesh((1, 4), ("data", "time")),
                                 wavelet=wav, scales="log", dtype="float64")
        assert np.allclose(Tb[i], np.asarray(Ti[0] if Ti.ndim == 3 else Ti),
                           atol=1e-12), i


def test_distributed_helpers_single_process():
    """Multi-host glue degrades cleanly to single-process (P10 analog)."""
    from jax.sharding import PartitionSpec as P
    from ssqueeze_rs_tpu.parallel import (initialize, make_host_chip_mesh,
                                          global_from_local, is_distributed)

    initialize()                       # no coordinator -> no-op
    assert not is_distributed()

    mesh = make_host_chip_mesh()       # 1 host x 8 local devices
    assert mesh.devices.shape == (1, 8)
    assert mesh.axis_names == ("data", "time")

    mesh2 = make_host_chip_mesh(time_parallel=4)
    assert mesh2.devices.shape == (2, 4)

    x = np.arange(32, dtype=np.float32).reshape(4, 8)
    gx = global_from_local(x, mesh2, P("data", None))
    assert gx.shape == (4, 8)
    assert np.array_equal(np.asarray(gx), x)

    with pytest.raises(ValueError):
        make_host_chip_mesh(time_parallel=3)


def test_chunked_ssq_cwt_on_host_chip_mesh():
    """End-to-end sharded ssq_cwt over the host-major mesh layout."""
    from ssqueeze_rs_tpu.parallel import make_host_chip_mesh

    mesh = make_host_chip_mesh(time_parallel=4)   # (2, 4)
    rng = np.random.default_rng(3)
    X = rng.standard_normal((2, 2048))
    Xs = shard_batch(np.asarray(X), mesh, "data")
    Tx, Wx, fr, sc = chunked_ssq_cwt(Xs, mesh, fs=1.0,
                                     batch_axis_name="data")
    Tx1, Wx1, fr1, sc1 = ssq_cwt(X, "gmw", scales=np.asarray(sc).reshape(-1, 1),
                                 fs=1.0)
    # interior columns match the unsharded transform (halo-limited edges)
    sl = slice(256, -256)
    a, b = np.asarray(Wx)[..., sl], np.asarray(Wx1)[..., sl]
    assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 5e-2


def test_chunked_cwt_halo_convergence(mesh):
    """Overlap-save error decreases monotonically with halo width —
    quantitative validation of the halo model (SURVEY §5: the reference's
    fixed dask overlap has the same tradeoff, unmeasured)."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(4096)
    Wx_full, sc = cwt(x, "gmw", scales="log", dtype="float64")
    errs = []
    for halo in (64, 128, 256, 448):
        Wx_c, _ = chunked_cwt(x[None], mesh, scales="log", halo=halo,
                              dtype="float64", exact=False)
        e = (np.abs(np.asarray(Wx_c)[0] - np.asarray(Wx_full)).max()
             / np.abs(np.asarray(Wx_full)).max())
        errs.append(e)
    assert all(a >= b for a, b in zip(errs, errs[1:])), errs
    # convergence halves the error; exactness is NOT reachable for the
    # default gmw (beta=60): (a) the largest scales' support exceeds any
    # feasible halo, and (b) near-Nyquist scales are frequency-truncated
    # at omega=pi, giving sinc-like ~1/t time tails that decay slowly —
    # segment-wise processing of those rows is inherently ~1% at any
    # reasonable halo (the reference's fixed dask overlap shares both
    # effects, unmeasured)
    assert errs[-1] < errs[0] / 2, errs


# -- sharded inverse transforms (round 3) -----------------------------------
def test_chunked_istft_bit_exact(mesh):
    """chunked_istft == unsharded istft ELEMENTWISE over hop/win_exp/
    modulated grids (frame-halo exchange preserves the OLA fold order;
    parallel/chunked.py::chunked_istft design note)."""
    from ssqueeze_rs_tpu import istft
    from ssqueeze_rs_tpu.parallel import chunked_istft

    rng = np.random.default_rng(7)
    N = 1024
    x = np.asarray(rng.standard_normal(N), np.float64)
    for n_fft, hop, win_exp, modulated in [(64, 1, 1, True),
                                           (64, 4, 1, True),
                                           (65, 1, 0, True),
                                           (64, 2, 2, False)]:
        Sx = stft(x, n_fft=n_fft, hop_len=hop, modulated=modulated,
                  dtype="float64")
        want = np.asarray(istft(Sx, n_fft=n_fft, hop_len=hop,
                                modulated=modulated, win_exp=win_exp))
        got = np.asarray(chunked_istft(Sx, mesh, n_fft=n_fft, hop_len=hop,
                                       modulated=modulated,
                                       win_exp=win_exp))
        assert got.shape == want.shape
        assert np.array_equal(got, want), (
            n_fft, hop, win_exp, modulated,
            float(np.abs(got - want).max()))


def test_chunked_istft_roundtrip_and_batch(mesh2x4):
    """Sharded forward -> sharded inverse round trip, batched over the
    data axis, recovers the signal (float64, hop=1)."""
    from ssqueeze_rs_tpu import istft
    from ssqueeze_rs_tpu.parallel import (chunked_stft, chunked_istft,
                                          shard_batch)
    from ssqueeze_rs_tpu.toolkit import mad_rms

    rng = np.random.default_rng(8)
    B, N = 2, 512
    X = np.asarray(rng.standard_normal((B, N)), np.float64)
    Xs = shard_batch(jnp.asarray(X), mesh2x4, "data")
    kw = dict(n_fft=64, hop_len=1, dtype="float64")
    Sx = chunked_stft(Xs, mesh2x4, batch_axis_name="data", **kw)
    xr = np.asarray(chunked_istft(Sx, mesh2x4, n_fft=64, hop_len=1,
                                  batch_axis_name="data"))
    assert xr.shape == (B, N)
    for i in range(B):
        assert mad_rms(X[i], xr[i]) < 1e-12


def test_chunked_icwt_matches_unsharded(mesh):
    """chunked_icwt equals the unsharded one-integral icwt (column-local
    reduction) and round-trips the signal."""
    from ssqueeze_rs_tpu import icwt
    from ssqueeze_rs_tpu.parallel import chunked_icwt
    from ssqueeze_rs_tpu.toolkit import mad_rms

    rng = np.random.default_rng(9)
    N = 1024
    t = np.arange(N) / N
    x = (np.cos(2 * np.pi * 40 * t) +
         0.4 * np.asarray(rng.standard_normal(N))).astype(np.float64)
    wav = ("gmw", {"beta": 8.0})
    Wx, scales = cwt(x, wav, scales="log", nv=16, dtype="float64")
    want = np.asarray(icwt(np.asarray(Wx), wav, scales="log", nv=16))
    got = np.asarray(chunked_icwt(Wx, mesh, wavelet=wav, scales="log",
                                  nv=16))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    assert mad_rms(x, got) < 0.05   # reference-style round-trip sanity

    with pytest.raises(NotImplementedError):
        chunked_icwt(Wx, mesh, wavelet=wav, scales="log", nv=16,
                     one_int=False)


def test_chunked_issq_matches_unsharded(mesh):
    """chunked_issq_cwt / chunked_issq_stft equal their unsharded
    counterparts (column-local row sums)."""
    from ssqueeze_rs_tpu import issq_cwt, issq_stft
    from ssqueeze_rs_tpu.parallel import (chunked_issq_cwt,
                                          chunked_issq_stft)

    rng = np.random.default_rng(10)
    N = 512
    t = np.arange(N) / N
    x = np.cos(2 * np.pi * 30 * t) + 0.1 * rng.standard_normal(N)
    wav = ("gmw", {"beta": 8.0})

    Tx, *_ = ssq_cwt(x, wav, scales="log", nv=16, dtype="float64")
    want = np.asarray(issq_cwt(np.asarray(Tx), wav))
    got = np.asarray(chunked_issq_cwt(Tx, mesh, wavelet=wav))
    assert np.array_equal(got, want)

    Ts, *_ = ssq_stft(x, n_fft=64, dtype="float64")
    want_s = np.asarray(issq_stft(np.asarray(Ts), n_fft=64))
    got_s = np.asarray(chunked_issq_stft(Ts, mesh, n_fft=64))
    assert np.array_equal(got_s, want_s)


def test_chunked_issq_component_inversion(mesh):
    """Sharded component inversion (cc/cw bands shard along time with
    Tx); equals the unsharded jnp inversion and the former host-numpy
    reference semantics."""
    from ssqueeze_rs_tpu import issq_cwt
    from ssqueeze_rs_tpu.parallel import chunked_issq_cwt
    from ssqueeze_rs_tpu.toolkit import lin_band

    rng = np.random.default_rng(11)
    N = 512
    t = np.arange(N) / N
    x = np.cos(2 * np.pi * 40 * t) + 0.5 * rng.standard_normal(N)
    wav = ("gmw", {"beta": 6.0})
    Tx, *_ = ssq_cwt(x, wav, scales="log:maximal", nv=16, flipud=False,
                     dtype="float64")
    Cs, freqband = lin_band(Tx, 0.4, 0.4, 0.05)

    want = np.asarray(issq_cwt(np.asarray(Tx), wav, Cs, freqband))
    got = np.asarray(chunked_issq_cwt(Tx, mesh, wavelet=wav, cc=Cs,
                                      cw=freqband))
    assert got.shape == want.shape == (2, N)   # 1 component + residual
    assert np.array_equal(got, want)

    # host-numpy oracle of the reference's per-component loop
    # (_ssq_cwt.py:381-403)
    Txn = np.asarray(Tx)
    cc = np.asarray(Cs).reshape(-1, 1)
    cw = np.asarray(freqband).reshape(-1, 1)
    rows = np.arange(Txn.shape[0])[:, None]
    up = np.clip(cc[:, 0] + cw[:, 0], 0, Txn.shape[0])
    lo = np.clip(cc[:, 0] - cw[:, 0], 0, Txn.shape[0])
    nocurve = cc[:, 0] == -1
    up = np.where(nocurve, 0, up)
    lo = np.where(nocurve, 1, lo)
    m = (rows >= lo[None, :]) & (rows <= up[None, :])
    from ssqueeze_rs_tpu.wavelets.adm import adm_ssq
    from ssqueeze_rs_tpu.wavelets.base import Wavelet
    Css = adm_ssq(Wavelet.build(wav))
    np.testing.assert_allclose(got[0],
                               (Txn.real * m).sum(0) * 2 / Css,
                               rtol=1e-12)


def test_chunked_squeezing_modes_match_unsharded(mesh):
    """squeezing='lebesgue'/'abs' on the chunked ssq transforms matches
    the unsharded transforms (was silently 'sum' — code-review r3)."""
    N = 1024
    t = np.arange(N) / 1000.0
    x = np.cos(2 * np.pi * 100.0 * t)

    for sq in ("lebesgue", "abs"):
        Tx_ref, *_ = ssq_stft(x, n_fft=128, fs=1000.0, squeezing=sq)
        Tx, _, _, _ = chunked_ssq_stft(x, mesh, n_fft=128, fs=1000.0,
                                       squeezing=sq)
        bar = 5e-6 * np.abs(np.asarray(Tx_ref)).max()
        assert np.allclose(np.asarray(Tx), np.asarray(Tx_ref),
                           atol=bar), ("stft", sq)

    # 'abs' phases derive from |Wx| (reference ssqueeze_fast semantics):
    # near-gamma cells bin-flip under the hybrid path's ~1e-5 rounding,
    # so compare with a generous explicit gamma (stable binning) and on
    # interior row marginals
    g = 1e-3
    Tc_ref, *_ = ssq_cwt(x, fs=1000.0, nv=16, squeezing="abs", gamma=g)
    Tc, _, _, _ = chunked_ssq_cwt(x, mesh, fs=1000.0, nv=16,
                                  squeezing="abs", gamma=g)
    Tc_sum, _, _, _ = chunked_ssq_cwt(x, mesh, fs=1000.0, nv=16,
                                      squeezing="sum", gamma=g)
    m = np.abs(np.asarray(Tc))[:, 128:-128].sum(axis=1)
    m_ref = np.abs(np.asarray(Tc_ref))[:, 128:-128].sum(axis=1)
    # noise-floor large-scale rows carry ~1e-2-of-max deficits at this
    # tiny sharded config for EVERY squeezing mode (measured 2.6e-3 for
    # 'sum'); the bar checks 'abs' tracks the unsharded 'abs' as well as
    # 'sum' tracks unsharded 'sum'
    assert np.abs(m - m_ref).max() < 2e-2 * m_ref.max()
    assert not np.allclose(np.asarray(Tc), np.asarray(Tc_sum),
                           atol=1e-8 * np.abs(np.asarray(Tc_sum)).max())

    import pytest
    with pytest.raises(Exception):
        chunked_ssq_cwt(x, mesh, fs=1000.0, squeezing="bogus")
    with pytest.raises(ValueError, match="maximal"):
        chunked_ssq_cwt(x, mesh, fs=1000.0, maprange="maximal")


def test_chunked_istft_ragged_N_rejected(mesh):
    """N != hop*n_frames fails loudly with guidance, not a shard_map
    shape error (code-review r3)."""
    import pytest
    from ssqueeze_rs_tpu.parallel import chunked_istft
    Sx = jnp.zeros((65, 128), dtype=jnp.complex128)
    with pytest.raises(ValueError, match="hop_len \\* n_frames"):
        chunked_istft(Sx, mesh, n_fft=128, hop_len=2, N=255)


def test_comm_report_byte_accounting():
    """comm_report counts are exact functions of the planning (hand-
    derived here for stft/istft; structural invariants for the cwt
    hybrid), and tools/comm_model.cross_bytes is monotone in P."""
    from ssqueeze_rs_tpu.parallel import comm_report

    # stft: ppermute of (Hl + Hr) signal samples, Hl+Hr = n_fft - 1
    r = comm_report("stft", 65536, 8, n_fft=512, hop_len=4)
    (pp,) = r["collectives"]
    assert pp["op"] == "ppermute" and pp["calls"] == 2
    assert pp["bytes_per_device"] == (512 - 1) * 4
    assert r["total_bytes_per_device"] == 2 * (512 - 1) * 4

    # istft: frame-column halo, complex64 columns
    r = comm_report("istft", 65536, 8, n_fft=256, hop_len=4)
    (pp,) = r["collectives"]
    Hl, Hr = r["halo"]
    n_freqs = 256 // 2 + 1
    assert pp["bytes_per_device"] == (Hl + Hr) * n_freqs * 8

    # ssq_cwt hybrid: halo ppermute + signal all_gather + W all_to_all
    r = comm_report("ssq_cwt", 65536, 8, scales="log", nv=8)
    ops = {e["op"]: e for e in r["collectives"]}
    assert set(ops) == {"ppermute", "all_gather", "all_to_all"}
    S = 65536 // 8
    assert ops["ppermute"]["bytes_per_device"] == 2 * r["halo"] * 4
    assert ops["all_gather"]["bytes_per_device"] == 7 * S * 4
    nag = r["rows_global"]
    nag_s = -(-nag // 8)
    assert ops["all_to_all"]["calls"] == 2        # Wx + dWx pipelines
    assert ops["all_to_all"]["bytes_per_device"] == \
        (7 * nag_s * 65536 * 8) // 8
    assert r["rows_local"] + r["rows_global"] > 0

    # exact=False: no global path, only the halo exchange
    r2 = comm_report("ssq_cwt", 65536, 8, scales="log", nv=8, exact=False)
    assert [e["op"] for e in r2["collectives"]] == ["ppermute"]

    import importlib.util as _iu
    import os as _os
    spec = _iu.spec_from_file_location(
        "comm_model", _os.path.join(_os.path.dirname(__file__), "..",
                                    "tools", "comm_model.py"))
    cm = _iu.module_from_spec(spec)
    spec.loader.exec_module(cm)
    xs = [cm.cross_bytes(r, P) for P in (1, 2, 4, 8)]
    assert xs[0] == 0 and xs[1] < xs[2] < xs[3]
