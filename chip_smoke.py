"""Run the main path once on the GPU at the reference's full size and check
every result against a float64 host reference.

    python chip_smoke.py           # one card: phases 1-6 below
    python chip_smoke.py --multi   # four cards: the sharded path only

Phases (one card; N = 160,000 float32 samples, default GMW with its
~300 log-piecewise scale rows, n_fft = 598 — the reference's benchmark,
old/README.md:47-54):
  1. forward   ssq_cwt, cwt, stft (hop 1), ssq_stft
  2. inverse   icwt, issq_cwt, istft, issq_stft with round-trip mad_rms
  3. batch     ssq_cwt on 8 x 160k
  4. serve     TransformServer("ssq_cwt") on requests of mixed lengths
  5. grad      jax.grad of sum|Tx|^2 through ssq_cwt
  6. record    parallel.process_recording of (4, 2,000,000), chunk 1e6,
               out="energy"
With --multi: chunked_ssq_cwt of 1 x 1,000,000 on a (data 1 x time 4)
mesh, and chunked_stft / istft / ssq_stft / issq_stft of 2 x 160,000 on a
(2 x 2) mesh, each against the same transform on one card.

References (`ssqueeze_rs_tpu.reference`) are float64 numpy/scipy on the
host; they take the returned scales and frequencies and plan the
reassignment themselves (closed-form weights, nearest-grid bins).
Device transforms are float32; every float32 matmul they contain
runs at Precision.HIGHEST. Tolerances and why:
  * Wx, Sx: max|dev - ref| / max|ref| <= 1e-5 (float32 FFT/DFT rounding);
  * Tx: the bin of each value depends on the last bits of the phase and
    the scatter sums in no fixed order, so Tx is compared by its column
    sums (which no bin decision changes) to 1e-4, and by the per-row sums
    of |Tx| (which a bin flip moves between neighbour rows) to 1e-3;
  * inverses: round trips against the signal itself, at the reference's
    own bars (old/tests/reconstruction_test.py), plus agreement with the
    float64 inverse of the float64 reference transform;
  * grad: directional derivatives against a central finite difference
    of the float64 loss with the bin map held fixed (round/where carry no
    derivative, so that is the gradient JAX defines) to 1e-2, since the
    float32 and float64 bin maps differ in a few values; and g.x = 2L
    (the loss is quadratic in x for fixed bins) to 1e-4.

Exits nonzero, printing no result, when JAX's default device is not a GPU
(no CPU fallback) or when any phase fails. Prints each phase's checks,
its times (the first call, then the median, min and max of warm calls,
each ended by `block_until_ready`), `peak_bytes_in_use`, and the card's
name and power limit; the last stdout line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from dataclasses import dataclass
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
GAMMA = 10 * float(np.finfo(np.float32).eps)   # float32 default gamma


@dataclass(frozen=True)
class Sizes:
    N: int = 160_000
    n_fft: int = 598
    batch: int = 8
    serve: tuple = (3_000, 12_000, 15_000, 60_000)
    rec: tuple = (4, 2_000_000)
    chunk: int = 1_000_000
    multi_N: int = 1_000_000
    multi_stft: tuple = (2, 160_000)


FULL = Sizes()


class Failed(Exception):
    pass


class Phase:
    """Collects one phase's checks; `done()` raises if any failed."""

    def __init__(self, name):
        self.name, self.bad, self.t0 = name, [], time.perf_counter()
        print(f"== {name}", flush=True)

    def check(self, what, err, tol, how):
        ok = bool(np.isfinite(err) and err <= tol)
        print(f"   {'ok  ' if ok else 'FAIL'} {what}: {err:.3e} "
              f"(tol {tol:.0e}; {how})", flush=True)
        if not ok:
            self.bad.append(what)

    def truth(self, what, cond):
        print(f"   {'ok  ' if cond else 'FAIL'} {what}", flush=True)
        if not cond:
            self.bad.append(what)

    def done(self):
        print(f"   phase wall time {time.perf_counter() - self.t0:.2f} s; "
              f"peak_bytes_in_use {_peak_bytes()}", flush=True)
        if self.bad:
            raise Failed(f"{self.name}: {', '.join(self.bad)}")


def _peak_bytes():
    import jax
    st = jax.local_devices()[0].memory_stats() or {}
    return st.get("peak_bytes_in_use", "n/a")


def timed(label, fn, *args, reps=5):
    """The first call of fn (compile + run), then `reps` warm calls, each
    ended by block_until_ready; prints the first time and the warm
    median with its spread. Returns the last call's result."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        del out
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    ms = np.asarray(ts) * 1e3
    print(f"   time {label}: first {first:.3f} s, warm median "
          f"{np.median(ms):.3f} ms (min {ms.min():.3f}, max {ms.max():.3f};"
          f" {reps} calls)", flush=True)
    return out


def signal(rng, N, fs=1.0):
    """Two tones, a linear chirp and white noise (seeded)."""
    t = np.arange(N) / fs
    T = N / fs
    x = (np.cos(2 * np.pi * 0.05 * fs * t) +
         0.8 * np.cos(2 * np.pi * 0.21 * fs * t) +
         0.6 * np.cos(2 * np.pi * (0.01 * fs + 0.15 * fs * t / (2 * T)) * t)
         + 0.1 * rng.standard_normal(N))
    return x.astype(np.float32)


def stft_ref(x, n_fft):
    """float64 (Sx, dSx, Tx, Sfs, window) of a 1D signal (hop 1, fs 1)."""
    from ssqueeze_rs_tpu import reference as R
    from ssqueeze_rs_tpu.utils.windows import get_window
    win, dwin = get_window(None, n_fft, n_fft, derivative=True,
                           dtype="float64")
    Sx, dSx = R.stft(x, win, n_fft, diff_window=dwin)
    nf = n_fft // 2 + 1
    Sfs = np.linspace(0, 0.5, nf)          # bin frequencies = ssq grid
    Tx, _ = R.reassign(Sx, dSx, np.full(nf, Sfs[1]), GAMMA, Sfs, False,
                       flipud=False, Sfs=Sfs)
    return Sx, dSx, Tx, Sfs, win


def row_l1_err(Tx, Tx_ref):
    """sum_i |r_i - r_ref_i| / sum r_ref with r_i = sum_j |Tx[i, j]|."""
    r = np.abs(np.asarray(Tx)).sum(-1)
    r_ref = np.abs(Tx_ref).sum(-1)
    return float(np.abs(r - r_ref).sum() / r_ref.sum())


def check_ssq(ph, tag, Wx, Tx, ref):
    from ssqueeze_rs_tpu import reference as R
    ph.check(f"{tag} Wx", R.max_rel_err(Wx, ref[0]), 1e-5,
             "f32 vs f64, rel. to max|Wx|")
    ph.check(f"{tag} Tx column sums", R.column_marginal_err(Tx, ref[2]),
             1e-4, "f32 vs f64, rel. to max column sum")
    ph.check(f"{tag} Tx row sums of |Tx|", row_l1_err(Tx, ref[2]), 1e-3,
             "f32 vs f64, L1 over rows; bin flips move mass one row")


# -- phases ---------------------------------------------------------------------
def phase_forward_inverse(S, rng, state):
    import jax.numpy as jnp
    from ssqueeze_rs_tpu import (ssq_cwt, cwt, stft, ssq_stft, icwt,
                                 issq_cwt, istft, issq_stft, mad_rms,
                                 Wavelet, native, reference as R)
    from ssqueeze_rs_tpu.wavelets import adm_ssq

    ph = Phase(f"1. forward transforms, N={S.N}, n_fft={S.n_fft}")
    x = signal(rng, S.N)
    xj = jnp.asarray(x)
    Tx, Wx, ssq_freqs, scales = timed("ssq_cwt", ssq_cwt, xj)
    Wc, _ = timed("cwt", cwt, xj)
    Sx = timed("stft", lambda v: stft(v, n_fft=S.n_fft, hop_len=1), xj)
    Ts, Ss, *_ = timed("ssq_stft", lambda v: ssq_stft(v, n_fft=S.n_fft), xj)
    print(f"   {len(scales)} scale rows; Tx {Tx.shape}, Sx {Sx.shape}",
          flush=True)
    dev = dict(Tx=Tx, Wc=Wc, Sx=Sx, Ts=Ts)     # inverse inputs stay on device
    Tx, Wx, Wc, Sx, Ts, Ss = (np.asarray(a) for a in (Tx, Wx, Wc, Sx, Ts,
                                                      Ss))
    t0 = time.perf_counter()
    ref = R.ssq_cwt(x, scales, ssq_freqs, GAMMA)
    sref = stft_ref(x, S.n_fft)
    print(f"   float64 references: {time.perf_counter() - t0:.1f} s",
          flush=True)
    const, grid, log = R.ssq_cwt_plan(ssq_freqs, scales)
    nat = native.reassign_cpu(ref[0], ref[1], grid, const, GAMMA,
                              "log" if log else "lin", flipud=True)
    ph.check("numpy reassign == native reassign_cpu",
             R.max_rel_err(ref[2], nat), 1e-12,
             "f64 vs f64; nearest-grid bins vs the program's bin plan")
    ph.truth("all outputs finite", all(np.isfinite(a).all() for a in
                                       (Tx, Wx, Wc, Sx, Ts, Ss)))
    check_ssq(ph, "ssq_cwt", Wx, Tx, ref)
    ph.check("cwt Wx", R.max_rel_err(Wc, ref[0]), 1e-5,
             "f32 vs f64, rel. to max|Wx|")
    ph.check("stft Sx", R.max_rel_err(Sx, sref[0]), 1e-5,
             "f32 HIGHEST matmul vs f64 FFT, rel. to max|Sx|")
    ph.check("ssq_stft Sx", R.max_rel_err(Ss, sref[0]), 1e-5,
             "f32 vs f64, rel. to max|Sx|")
    ph.check("ssq_stft Tx column sums", R.column_marginal_err(Ts, sref[2]),
             1e-4, "f32 vs f64, rel. to max column sum")
    ph.check("ssq_stft Tx row sums of |Tx|", row_l1_err(Ts, sref[2]), 1e-3,
             "f32 vs f64, L1 over rows")
    ph.done()
    state.update(x=x, scales=scales, ssq_freqs=ssq_freqs, ref=ref)

    ph = Phase("2. inverse transforms")
    xi = timed("icwt", lambda W: icwt(W, "gmw", scales=scales), dev["Wc"])
    ph.check("icwt round trip mad_rms", mad_rms(x, np.asarray(xi)), 0.1,
             "vs the signal; reference bar th=.1")
    xs = np.asarray(timed("issq_cwt", lambda T: issq_cwt(T, "gmw"),
                          dev["Tx"]))
    ph.check("issq_cwt round trip mad_rms", mad_rms(x, xs), 0.1,
             "vs the signal; reference bar th=.1")
    xs_ref = ref[2].real.sum(0) * (2 / adm_ssq(Wavelet.build("gmw")))
    ph.check("issq_cwt vs f64 inverse of f64 Tx", R.max_rel_err(xs, xs_ref),
             1e-4, "rel. to max|x|")
    xt = np.asarray(timed("istft", lambda A: istft(A, n_fft=S.n_fft, N=S.N),
                          dev["Sx"]))
    ph.check("istft round trip mad_rms", mad_rms(x, xt), 1e-5,
             "vs the signal; exact least-squares inverse")
    ph.check("istft vs f64 inverse of f64 Sx",
             R.max_rel_err(xt, R.istft(sref[0], sref[4], S.n_fft, S.N)),
             1e-5, "rel. to max|x|")
    xq = np.asarray(timed("issq_stft",
                          lambda T: issq_stft(T, n_fft=S.n_fft), dev["Ts"]))
    ph.check("issq_stft round trip mad_rms", mad_rms(x, xq), 0.1,
             "vs the signal; reference bar th=.1")
    xq_ref = sref[2].real.sum(0) * (2 / sref[4][len(sref[4]) // 2])
    ph.check("issq_stft vs f64 inverse of f64 Tx", R.max_rel_err(xq, xq_ref),
             1e-4, "rel. to max|x|")
    ph.done()


def phase_batch(S, rng, state):
    import jax.numpy as jnp
    from ssqueeze_rs_tpu import ssq_cwt, reference as R
    ph = Phase(f"3. batched ssq_cwt, {S.batch} x {S.N}")
    X = np.stack([signal(rng, S.N) for _ in range(S.batch)])
    Tx, Wx, fr, sc = timed("ssq_cwt batch", ssq_cwt, jnp.asarray(X))
    ph.truth(f"shape {Tx.shape}", Tx.shape == (S.batch, len(fr), S.N))
    for b in sorted({0, S.batch - 1}):
        check_ssq(ph, f"signal {b}", np.asarray(Wx[b]), np.asarray(Tx[b]),
                  R.ssq_cwt(X[b], sc, fr, GAMMA))
    ph.truth("all finite", bool(jnp.isfinite(Tx).all() &
                                jnp.isfinite(Wx).all()))
    ph.done()


def phase_serve(S, rng, state):
    from ssqueeze_rs_tpu import reference as R
    from ssqueeze_rs_tpu.serve import TransformServer
    ph = Phase(f"4. TransformServer('ssq_cwt'), lengths {S.serve}")
    server = TransformServer("ssq_cwt")
    reqs = [signal(rng, n) for n in S.serve]
    outs = []
    for x in reqs:
        t0 = time.perf_counter()
        outs.append(server(x))
        print(f"   request N={len(x)} -> bucket {server.bucket_for(len(x))}:"
              f" {time.perf_counter() - t0:.3f} s", flush=True)
    t0 = time.perf_counter()
    server(reqs[-1])
    print(f"   repeat N={len(reqs[-1])}: {time.perf_counter() - t0:.3f} s",
          flush=True)
    n_buckets = len({server.bucket_for(len(x)) for x in reqs})
    print(f"   n_compiled {server.n_compiled}", flush=True)
    ph.truth(f"n_compiled == {n_buckets} buckets",
             server.n_compiled == n_buckets)
    ph.truth("response shapes", all(
        o["Tx"].shape == (len(o["ssq_freqs"]), len(x)) and
        o["Wx"].shape == (len(o["scales"]), len(x))
        for o, x in zip(outs, reqs)))
    # the server transforms the bucket-padded signal and trims to N
    i = 1 if len(reqs) > 1 else 0
    x, o = reqs[i], outs[i]
    b = server.bucket_for(len(x))
    xb = np.pad(x, (0, b - len(x)), mode="reflect") if b > len(x) else x
    check_ssq(ph, f"request N={len(x)}", o["Wx"], o["Tx"],
              R.ssq_cwt(xb, o["scales"], o["ssq_freqs"], GAMMA,
                          cols=slice(0, len(x))))
    ph.done()


def phase_grad(S, rng, state):
    import jax
    import jax.numpy as jnp
    from ssqueeze_rs_tpu import ssq_cwt, Wavelet, reference as R
    ph = Phase(f"5. jax.grad of sum|Tx|^2 through ssq_cwt, N={S.N}")
    x, scales, fr = state["x"], state["scales"], state["ssq_freqs"]
    Wr, _, Tr, k = state["ref"]

    def loss(v):
        return jnp.sum(jnp.abs(ssq_cwt(v)[0]) ** 2)

    L, g = timed("value_and_grad", jax.jit(jax.value_and_grad(loss)),
                 jnp.asarray(x))
    g = np.asarray(g, np.float64)
    ph.truth("gradient finite", bool(np.isfinite(g).all()))
    # with the bin map fixed the loss is quadratic in x, so g.x = 2L with
    # the device's own bins
    ph.check("grad.x vs 2 * loss", abs(g @ x - 2 * float(L)) / (2 * float(L)),
             1e-4, "f32, device bins on both sides")
    const, grid, log = R.ssq_cwt_plan(fr, scales)
    wav = Wavelet.build("gmw")
    for j in range(2):
        v = rng.standard_normal(S.N)
        Tv, _ = R.reassign(R.cwt(v, wav, scales, derivative=False), None,
                           const, 0.0, grid, log, True, k=k)
        eps = 1e-3
        fd = (np.sum(np.abs(Tr + eps * Tv) ** 2) -
              np.sum(np.abs(Tr - eps * Tv) ** 2)) / (2 * eps)
        ph.check(f"direction {j}: grad.v vs finite difference",
                 abs(g @ v - fd) / abs(fd), 1e-2,
                 "f32 grad vs f64 central difference with the f64 bins "
                 "held fixed; the few values binned differently in f32 "
                 "send their cotangent to a neighbour row")
    ph.done()


def phase_record(S, rng, state):
    from ssqueeze_rs_tpu import Wavelet, reference as R
    from ssqueeze_rs_tpu.parallel import process_recording
    from ssqueeze_rs_tpu.parallel.chunked import default_cwt_halo
    C, N = S.rec
    ph = Phase(f"6. process_recording ssq_cwt ({C}, {N}), chunk {S.chunk},"
               " out='energy'")
    X = np.stack([signal(rng, N) for _ in range(C)])
    E, meta = timed("process_recording", lambda v: process_recording(
        v, chunk_len=S.chunk, out="energy"), X, reps=3)
    sc, fr = meta["scales"], meta["ssq_freqs"]
    ph.truth(f"energy shape {E.shape}, finite, positive",
             E.shape == (C, len(fr)) and np.isfinite(E).all() and
             (E.sum(-1) > 0).all())
    # float64 reference of the same chunking: reflect halo, trimmed
    wav = Wavelet.build("gmw")
    halo = min(default_cwt_halo(wav, float(sc.max())), S.chunk // 2)
    ext = min(S.chunk, N) + 2 * halo
    t0 = time.perf_counter()
    M, _ = R.p2up_pad(ext)
    psih = R.filterbank(wav, sc, M)
    for c in sorted({0, C - 1}):
        xp = R.reflect_pad(X[c], halo, halo)
        E_ref = 0.0
        for start in range(0, N, S.chunk):
            cl = min(S.chunk, N - start)
            seg = xp[start:start + cl + 2 * halo]
            if len(seg) != ext:
                raise Failed("reference chunking assumes equal chunks")
            *_, Tx, _ = R.ssq_cwt(seg, sc, fr, GAMMA, cols=slice(halo, halo + cl),
                                    psih=psih)
            E_ref = E_ref + (np.abs(Tx) ** 2).sum(-1)
            del Tx
        ph.check(f"channel {c} row energies", float(
            np.abs(E[c] - E_ref).sum() / E_ref.sum()), 1e-3,
            "f32 vs f64, L1 over rows; bin flips move energy one row")
    print(f"   float64 reference: {time.perf_counter() - t0:.1f} s",
          flush=True)
    ph.done()


def phase_multi(S, rng, state):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh
    from ssqueeze_rs_tpu import (ssq_cwt, stft, istft, ssq_stft, issq_stft,
                                 mad_rms, reference as R)
    from ssqueeze_rs_tpu.parallel import (chunked_ssq_cwt, chunked_stft,
                                          chunked_istft, chunked_ssq_stft,
                                          chunked_issq_stft)
    devs = np.asarray(jax.devices()[:4])
    ph = Phase(f"multi a. chunked_ssq_cwt 1 x {S.multi_N}, mesh (1, 4)")
    mesh = Mesh(devs.reshape(1, 4), ("data", "time"))
    x = jnp.asarray(signal(rng, S.multi_N))
    Tx, Wx, fr, sc = timed("chunked_ssq_cwt",
                           lambda v: chunked_ssq_cwt(v, mesh), x)
    Tx, Wx = np.asarray(Tx), np.asarray(Wx)
    T1, W1, fr1, sc1 = timed("ssq_cwt on one card", ssq_cwt, x)
    print(f"   one-card peak_bytes_in_use {_peak_bytes()}", flush=True)
    T1, W1 = np.asarray(T1), np.asarray(W1)
    ph.truth("same scales and ssq_freqs", np.allclose(sc, sc1, rtol=1e-12)
             and np.allclose(fr, fr1, rtol=1e-12))
    ph.check("Wx sharded vs one card", R.max_rel_err(Wx, W1), 1e-5,
             "f32, rel. to max|Wx|; hybrid overlap-save rows within "
             "exact_tol=1e-6 tail mass")
    ph.check("Tx column sums", R.column_marginal_err(Tx, T1), 1e-4,
             "f32, rel. to max column sum")
    ph.check("Tx row sums of |Tx|", row_l1_err(Tx, T1), 1e-3,
             "f32, L1 over rows")
    ph.done()

    C, N = S.multi_stft
    ph = Phase(f"multi b. chunked STFT family {C} x {N}, n_fft={S.n_fft},"
               " mesh (2, 2)")
    mesh = Mesh(devs.reshape(2, 2), ("data", "time"))
    X = jnp.asarray(np.stack([signal(rng, N) for _ in range(C)]))
    kw = dict(n_fft=S.n_fft, batch_axis_name="data")
    Sx = np.asarray(timed("chunked_stft",
                          lambda v: chunked_stft(v, mesh, **kw), X))
    S1 = np.asarray(timed("stft on one card",
                          lambda v: stft(v, n_fft=S.n_fft), X))
    print(f"   stft sharded == one card bitwise: {np.array_equal(Sx, S1)}",
          flush=True)
    ph.check("stft Sx sharded vs one card", R.max_rel_err(Sx, S1), 1e-6,
             "f32, rel. to max|Sx|")
    xr = np.asarray(timed("chunked_istft", lambda A: chunked_istft(
        A, mesh, **kw), jnp.asarray(S1)))
    x1 = np.asarray(timed("istft on one card", lambda A: istft(
        A, n_fft=S.n_fft, N=N), jnp.asarray(S1)))
    ph.check("istft sharded vs one card", R.max_rel_err(xr, x1), 1e-6,
             "f32, rel. to max|x|")
    ph.check("istft round trip mad_rms", mad_rms(np.asarray(X), xr), 1e-5,
             "vs the signal")
    Tq, Sq, *_ = timed("chunked_ssq_stft", lambda v: chunked_ssq_stft(
        v, mesh, **kw), X)
    T1, S1q, *_ = timed("ssq_stft on one card",
                        lambda v: ssq_stft(v, n_fft=S.n_fft), X)
    Tq, T1 = np.asarray(Tq), np.asarray(T1)
    ph.check("ssq_stft Sx sharded vs one card",
             R.max_rel_err(Sq, S1q), 1e-6, "f32, rel. to max|Sx|")
    ph.check("ssq_stft Tx column sums", R.column_marginal_err(Tq, T1), 1e-4,
             "f32, rel. to max column sum")
    xq = np.asarray(timed("chunked_issq_stft", lambda T: chunked_issq_stft(
        T, mesh, n_fft=S.n_fft, batch_axis_name="data"), jnp.asarray(T1)))
    xq1 = np.asarray(issq_stft(jnp.asarray(T1), n_fft=S.n_fft))
    ph.check("issq_stft sharded vs one card", R.max_rel_err(xq, xq1), 1e-6,
             "f32, rel. to max|x|")
    ph.done()


SINGLE = (phase_forward_inverse, phase_batch, phase_serve, phase_grad,
          phase_record)


def run(phases, S, seed=0):
    """Run `phases` in order; returns the names of those that failed."""
    rng = np.random.default_rng(seed)
    state, failed = {}, []
    for fn in phases:
        try:
            fn(S, rng, state)
        except Exception as e:      # report every phase, then fail overall
            if not isinstance(e, Failed):
                traceback.print_exc()
            print(f"   PHASE FAILED: {e}", flush=True)
            failed.append(fn.__name__)
    return failed


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the sharded path on four cards")
    args = ap.parse_args(argv)

    try:
        import ssqueeze_rs_tpu
    except ImportError as e:
        print(f"chip_smoke: the package is missing: {e}", file=sys.stderr)
        return 2
    if Path(ssqueeze_rs_tpu.__file__).resolve().parent.parent != HERE:
        print("chip_smoke: ssqueeze_rs_tpu is not the checkout beside this "
              "script", file=sys.stderr)
        return 2
    import jax
    from ssqueeze_rs_tpu.config import enable_persistent_cache
    from ssqueeze_rs_tpu.utils.device import device_summary, card_line

    dev = device_summary()
    if dev["platform"] != "gpu":
        print(f"chip_smoke: no GPU (JAX's default device is "
              f"{dev['platform']}); nothing measured", file=sys.stderr)
        return 2
    if args.multi and dev["count"] < 4:
        print(f"chip_smoke --multi: needs 4 GPUs, found {dev['count']}",
              file=sys.stderr)
        return 2
    print(f"cache: {enable_persistent_cache()}", flush=True)
    print(f"jax {jax.__version__}; {dev}", flush=True)
    t0 = time.perf_counter()
    failed = run((phase_multi,) if args.multi else SINGLE, FULL)
    print(f"total {time.perf_counter() - t0:.1f} s; "
          f"peak_bytes_in_use {_peak_bytes()}", flush=True)
    print(card_line(), flush=True)
    if failed:
        print(f"chip_smoke: failed phases: {', '.join(failed)}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
