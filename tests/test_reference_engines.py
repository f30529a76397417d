"""The jnp engines against independent float64 references.

Reassignment against the native OpenMP oracle and the numpy bincount
reference; CWT and STFT/iSTFT against numpy/scipy FFT implementations
(`ssqueeze_rs_tpu.reference`); gradients through cwt, stft and ssq_cwt
against central finite differences of the reference loss.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ssqueeze_rs_tpu import cwt, stft, istft, ssq_cwt, Wavelet, native
from ssqueeze_rs_tpu import reference as R
from ssqueeze_rs_tpu.ops.ssqueeze import reassign, bin_params
from ssqueeze_rs_tpu.utils.windows import get_window

NA, N = 24, 300
GRIDS = {
    "log": np.geomspace(0.01, 0.5, 40),
    "log-piecewise": np.concatenate([np.geomspace(0.01, 0.1, 30,
                                                  endpoint=False),
                                     np.geomspace(0.1, 0.5, 10)]),
    "lin": np.linspace(0.01, 0.5, 40),
}


def _tf_pair(rng, batch):
    """Wx with concentrated phases (dWx ~ 2*pi*i*f*Wx plus noise)."""
    shape = batch + (NA, N)
    Wx = rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    f = rng.uniform(0.005, 0.6, shape)
    dWx = 2j * np.pi * f * Wx + 0.05 * (rng.standard_normal(shape) +
                                        1j * rng.standard_normal(shape))
    return Wx, dWx


@pytest.mark.parametrize("masked", [False, True], ids=["all", "gamma"])
@pytest.mark.parametrize("batch", [(), (2, 3)], ids=["1d", "b2x3"])
@pytest.mark.parametrize("transform", ["cwt", "stft"])
@pytest.mark.parametrize("flipud", [False, True])
@pytest.mark.parametrize("mode", list(GRIDS))
def test_reassign_matches_native_and_numpy(mode, flipud, transform, batch,
                                           masked):
    rng = np.random.default_rng(len(mode) + 7 * flipud + 3 * len(batch))
    ssq_freqs = GRIDS[mode]
    nf = len(ssq_freqs)
    Wx, dWx = _tf_pair(rng, batch)
    const = rng.uniform(0.5, 2.0, NA)
    gamma = float(np.median(np.abs(Wx))) if masked else 1e-12
    Sfs = np.linspace(0, 0.5, NA) if transform == "stft" else None
    got_mode, params = bin_params(ssq_freqs, mode.startswith("log"))
    assert got_mode == mode

    params_j = {k: (jnp.asarray(v) if k != "idx1" else
                    jnp.asarray(v, jnp.int32)) for k, v in params.items()}
    Tx = np.asarray(reassign(
        jnp.asarray(Wx), jnp.asarray(dWx), jnp.asarray(const),
        jnp.asarray(gamma), jnp.asarray(Sfs if Sfs is not None else
                                        np.zeros(NA)),
        params_j, mode=mode, flipud=flipud, fused=True,
        transform=transform, nf=nf))
    assert Tx.shape == batch + (nf, N)
    for i in np.ndindex(*batch):
        nat = native.reassign_cpu(Wx[i], dWx[i], ssq_freqs, const, gamma,
                                  mode, flipud=flipud, Sfs=Sfs)
        ref, k = R.reassign(Wx[i], dWx[i], const, gamma, ssq_freqs,
                            mode != "lin", flipud, Sfs=Sfs)
        assert R.max_rel_err(Tx[i], nat) < 1e-12
        assert R.max_rel_err(Tx[i], ref) < 1e-12
        assert (k < 0).any() == masked


@pytest.mark.parametrize("batch", [(), (2,)], ids=["1d", "b2"])
@pytest.mark.parametrize("l1_norm", [True, False], ids=["l1", "l2"])
@pytest.mark.parametrize("derivative", [False, True])
@pytest.mark.parametrize("n, padtype", [(1000, "reflect"), (1000, "zero"),
                                        (1000, None), (1024, None)])
def test_cwt_matches_numpy(n, padtype, derivative, l1_norm, batch):
    """Padded lengths: 2048 (p2up of 1000), 1000 (unpadded, not a power
    of 2) and 1024 (unpadded power of 2)."""
    rng = np.random.default_rng(n + len(batch))
    x = rng.standard_normal(batch + (n,))
    out = cwt(x, "gmw", scales="log", fs=2.0, padtype=padtype,
              derivative=derivative, l1_norm=l1_norm, dtype="float64")
    sc = np.asarray(out[1])
    wav = Wavelet.build("gmw", l1_norm=l1_norm)
    for i in np.ndindex(*batch):
        ref = R.cwt(x[i], wav, sc, dt=0.5, derivative=derivative,
                    l1_norm=l1_norm, padtype=padtype)
        if derivative:
            assert R.max_rel_err(np.asarray(out[2])[i], ref[1]) < 1e-12
            ref = ref[0]
        assert R.max_rel_err(np.asarray(out[0])[i], ref) < 1e-12


@pytest.mark.parametrize("batch", [(), (2,)], ids=["1d", "b2"])
@pytest.mark.parametrize("derivative", [False, True])
@pytest.mark.parametrize("block", [1, 5, 7])
def test_cwt_scale_blocks_match_numpy(block, derivative, batch):
    """cwt_core's blocked iFFT (lax.map over blocks of scales, the last
    block padded) gives the same rows as the float64 reference."""
    from ssqueeze_rs_tpu.ops.cwt import cwt_core
    from ssqueeze_rs_tpu.utils.pad import padsignal
    rng = np.random.default_rng(block)
    n = 700
    x = rng.standard_normal(batch + (n,))
    wav = Wavelet.build("gmw")
    sc = np.geomspace(2.0, 80.0, 17)
    xp, _, n1, _ = padsignal(jnp.asarray(x), "reflect", get_params=True)
    W, dW = cwt_core(xp, jnp.asarray(sc), jnp.asarray(1.0), wavelet=wav,
                     derivative=derivative, l1_norm=True, N=n, n1=n1,
                     rpadded=False, scale_block=block)
    assert W.shape == batch + (len(sc), n)
    for i in np.ndindex(*batch):
        ref = R.cwt(x[i], wav, sc, derivative=derivative)
        if derivative:
            assert R.max_rel_err(np.asarray(dW)[i], ref[1]) < 1e-12
            ref = ref[0]
        assert R.max_rel_err(np.asarray(W)[i], ref) < 1e-12


@pytest.mark.parametrize("limit, M, batch, expect", [
    (None, 1 << 22, 1, None),   # no limit reported: one batch
    (64e9, 1 << 18, 8, None),   # 8 x 160k signals: everything fits
    (64e9, 1 << 22, 1, 106),    # 2M-sample chunk: 32 GB / 201 MB = 158
                                # scales, balanced to 3 blocks of 106
    (8e9, 1 << 22, 1, 19),
    (1e6, 1 << 22, 1, 1),       # never below one scale
])
def test_scale_block_follows_device_limit(monkeypatch, limit, M, batch,
                                          expect):
    """317 scales with derivative, float32: three copies of a block's
    spectra fit half of the device's memory limit, and the blocks are
    balanced so the last one needs the least padding."""
    from ssqueeze_rs_tpu.ops.cwt import scale_block_for
    import ssqueeze_rs_tpu.utils.common as common
    monkeypatch.setattr(common, "device_memory_limit", lambda: limit)
    assert scale_block_for(317, M, batch, True, 4) == expect


@pytest.mark.parametrize("batch", [(), (2,)], ids=["1d", "b2"])
@pytest.mark.parametrize("modulated", [True, False])
@pytest.mark.parametrize("hop", [1, 3])
@pytest.mark.parametrize("n_fft", [63, 128, 2050])
def test_stft_istft_match_numpy(n_fft, hop, modulated, batch):
    """float32: n_fft <= 2048 takes the HIGHEST-precision DFT matmul,
    2050 the rfft branch; float64 always the rfft branch."""
    rng = np.random.default_rng(n_fft + hop)
    n = 3000
    x = rng.standard_normal(batch + (n,))
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float64")
    kw = dict(n_fft=n_fft, hop_len=hop, modulated=modulated)
    S32, dS32 = stft(x, dtype="float32", derivative=True, fs=3.0, **kw)
    S64 = np.asarray(stft(x, dtype="float64", **kw))
    x32 = np.asarray(istft(S32, N=n, **kw))
    for i in np.ndindex(*batch):
        Sr, dSr = R.stft(x[i], win, n_fft, hop_len=hop, fs=3.0,
                         diff_window=dwin, modulated=modulated)
        assert R.max_rel_err(np.asarray(S32)[i], Sr) < 2e-6
        assert R.max_rel_err(np.asarray(dS32)[i], dSr) < 2e-6
        assert R.max_rel_err(S64[i], Sr) < 1e-12
        xr = R.istft(Sr, win, n_fft, n, hop_len=hop, modulated=modulated)
        assert R.max_rel_err(xr, x[i]) < 1e-12
        assert R.max_rel_err(x32[i], xr) < 2e-6


def _fd(loss, x, v, eps=1e-5):
    return (loss(x + eps * v) - loss(x - eps * v)) / (2 * eps)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("transform", ["cwt", "stft", "ssq_cwt"])
def test_grad_matches_finite_difference(transform, seed):
    """jax.grad of sum|out|^2 against a central difference of the float64
    reference loss. For ssq_cwt the reference holds its bin map fixed:
    round/where carry no derivative, which is the gradient JAX defines."""
    rng = np.random.default_rng(seed)
    n = 512
    t = np.arange(n) / n
    x = np.cos(2 * np.pi * 40 * t) + 0.2 * rng.standard_normal(n)
    v = rng.standard_normal(n)
    wav = Wavelet.build("gmw")
    if transform == "stft":
        win = get_window(None, 64, 64, dtype="float64")

        def dev(z):
            return jnp.sum(jnp.abs(stft(z, n_fft=64, dtype="float64")) ** 2)

        def ref(z):
            return np.sum(np.abs(R.stft(z, win, 64)) ** 2)
    elif transform == "cwt":
        sc = np.asarray(cwt(x, "gmw", scales="log", dtype="float64")[1])

        def dev(z):
            return jnp.sum(jnp.abs(cwt(z, "gmw", scales="log",
                                       dtype="float64")[0]) ** 2)

        def ref(z):
            return np.sum(np.abs(R.cwt(z, wav, sc, derivative=False)) ** 2)
    else:
        Tx, _, fr, sc = ssq_cwt(x, "gmw", scales="log", dtype="float64")
        const, grid, log = R.ssq_cwt_plan(fr, sc)
        gamma = 10 * np.finfo(np.float64).eps
        *_, Tr, k = R.ssq_cwt(x, sc, fr, gamma)
        assert R.max_rel_err(np.asarray(Tx), Tr) < 1e-10

        def dev(z):
            return jnp.sum(jnp.abs(ssq_cwt(z, "gmw", scales="log",
                                           dtype="float64")[0]) ** 2)

        def ref(z):
            Wz = R.cwt(z, wav, sc, derivative=False)
            return np.sum(np.abs(R.reassign(Wz, None, const, gamma, grid,
                                            log, True, k=k)[0]) ** 2)
    g = np.asarray(jax.grad(dev)(jnp.asarray(x)))
    fd = _fd(ref, x, v)
    assert abs(g @ v - fd) / abs(fd) < 1e-7, (g @ v, fd)


@pytest.mark.parametrize("path", ["one_card", "chunked"])
@pytest.mark.parametrize("scaletype", ["log", "log-piecewise", "linear"])
def test_ssq_cwt_plan_matches_closed_form(scaletype, path):
    """The program's reassignment planning (per-row weights from the
    scale grid, bins from the ssq frequency grid) against the
    reference's own closed form, in float64. One card: Tx elementwise.
    Sharded (`chunked_ssq_cwt`, whose Wx differs from one card's near
    shard edges): Tx's column sums, which only the weights decide,
    against the weighted column sums of its own Wx."""
    from ssqueeze_rs_tpu.parallel import make_mesh, chunked_ssq_cwt
    n = 2048
    t = np.arange(n) / n
    x = (np.cos(2 * np.pi * (20 + 150 * t) * t) +
         0.1 * np.random.default_rng(5).standard_normal(n))
    gamma = 10 * np.finfo(np.float64).eps
    kw = dict(scales=scaletype, dtype="float64")
    if path == "one_card":
        Tx, _, fr, sc = ssq_cwt(x, "gmw", **kw)
        *_, Tr, _ = R.ssq_cwt(x, sc, fr, gamma)
        assert R.max_rel_err(np.asarray(Tx), Tr) < 1e-10
        return
    Tx, Wx, fr, sc = chunked_ssq_cwt(x, make_mesh((1, 4), ("data", "time")),
                                     wavelet="gmw", **kw)
    const, grid, log = R.ssq_cwt_plan(fr, sc)
    assert log == (scaletype != "linear")
    Wx = np.asarray(Wx)
    col_ref = (const[:, None] * np.where(np.abs(Wx) > gamma, Wx, 0)).sum(0)
    assert R.max_rel_err(np.asarray(Tx).sum(0), col_ref) < 1e-10


@pytest.mark.parametrize("log", [True, False], ids=["log", "lin"])
def test_reference_bins_are_nearest_grid_point(log):
    """The reference's bins against a brute-force nearest grid point
    (in log2 or linearly), including values beyond both ends."""
    rng = np.random.default_rng(11)
    grid = (np.concatenate([np.geomspace(0.01, 0.1, 20, endpoint=False),
                            np.geomspace(0.1, 0.5, 6)]) if log else
            np.linspace(0.0, 0.5, 26))
    w = rng.uniform(0.001, 0.7, 5000)
    f = np.log2 if log else (lambda v: v)
    brute = np.abs(f(w)[:, None] - f(grid)[None]).argmin(1)
    assert np.array_equal(R.bin_index(w, grid, log), brute)
