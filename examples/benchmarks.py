"""Replicate the reference benchmark table on one GPU, plus batched configs.

Reference configs (old/examples/benchmarks.py:80-126, old/README.md:40-54):
output (300, len(x)) rows, float32, padding on, N in {10k, 160k}, for
cwt / stft / ssq_cwt / ssq_stft. Reference numbers below are the
published GTX 1070 GPU column (old/README.md:47-54).

Beyond the reference table (the reference has no batched numbers;
BASELINE.json's north star is 64-channel throughput):
  * a batch of 16 10k-signals in ONE dispatched program,
  * batched 160k ssq_cwt/cwt at batch 4/8 -> MSamples/s,
  * 160k ssq_cwt / ssq_stft on structured signals (tone, chirp).

Each cell is the median of several calls, each ended by
`block_until_ready`. Prints the card's name and power limit, one line per
cell, and a JSON summary as the last line. Exits nonzero without a GPU.

Run: python examples/benchmarks.py   (from the repo root)
"""
import json
import sys

import numpy as np

sys.path.insert(0, ".")

REF_GPU_S = {  # old/README.md:47-54
    (10_000, "cwt"): 0.00393,
    (10_000, "stft"): 0.00534,
    (10_000, "ssq_cwt"): 0.00941,
    (10_000, "ssq_stft"): 0.0278,
    (160_000, "cwt"): 0.0367,
    (160_000, "stft"): 0.0643,
    (160_000, "ssq_cwt"): 0.0856,
    (160_000, "ssq_stft"): 0.159,
}


def main():
    import jax
    import jax.numpy as jnp
    from ssqueeze_rs_tpu import ssq_cwt, cwt, stft, ssq_stft, Wavelet
    from ssqueeze_rs_tpu.config import enable_persistent_cache
    from ssqueeze_rs_tpu.scales import process_scales
    from ssqueeze_rs_tpu.utils.device import (require_gpu, device_summary,
                                              card_line, time_call)

    require_gpu()
    enable_persistent_cache()
    card = card_line()
    print(card, flush=True)
    n_rows = 300
    n_fft = n_rows * 2 - 2
    wavelet = Wavelet.build("gmw")
    rng = np.random.default_rng(0)
    results = {"device": device_summary(), "card": card, "n_rows": n_rows,
               "cells_s": {}}

    def fns(scales, **kw):
        return {
            "cwt": jax.jit(lambda x: cwt(x, wavelet, scales=scales,
                                         dtype="float32")[0]),
            "stft": jax.jit(lambda x: stft(x, n_fft=n_fft, hop_len=1,
                                           dtype="float32")),
            "ssq_cwt": jax.jit(lambda x: ssq_cwt(
                x, wavelet, scales=scales, fs=1.0, dtype="float32",
                **kw)[0]),
            "ssq_stft": jax.jit(lambda x: ssq_stft(
                x, n_fft=n_fft, dtype="float32")[0]),
        }

    def record(key, t, per=1, ref=None):
        results["cells_s"][key] = t
        line = f"{key}: {t / per * 1e3:8.3f} ms/transform"
        if ref is not None:
            line += f"  (ref GTX 1070 {ref * 1e3:.2f} ms)"
        print(f"{line}  [{card}]", flush=True)

    # -- reference table: single-signal latency ----------------------------
    for N in (10_000, 160_000):
        x = jnp.asarray(rng.standard_normal(N), dtype=jnp.float32)
        scales = process_scales("log-piecewise", N, wavelet)[:n_rows]
        for name, fn in fns(scales).items():
            t, _ = time_call(fn, x, reps=10)
            record(f"{N // 1000}k-{name}", t, ref=REF_GPU_S[(N, name)])

    # -- batch-16 10k signals, one dispatch --------------------------------
    N, B = 10_000, 16
    X = jnp.asarray(rng.standard_normal((B, N)), dtype=jnp.float32)
    scales = process_scales("log-piecewise", N, wavelet)[:n_rows]
    for name, fn in fns(scales).items():
        t, _ = time_call(fn, X, reps=5)
        record(f"10k-{name}-b{B}", t, per=B, ref=REF_GPU_S[(N, name)])

    # -- batched 160k: throughput at batch 4 / 8 ---------------------------
    N = 160_000
    scales = process_scales("log-piecewise", N, wavelet)[:n_rows]
    for B in (4, 8):
        X = jnp.asarray(rng.standard_normal((B, N)), dtype=jnp.float32)
        f = fns(scales)
        for name in ("cwt", "ssq_cwt"):
            t, _ = time_call(f[name], X, reps=3)
            record(f"160k-{name}-b{B}", t, per=B)

    # -- 160k structured signals -------------------------------------------
    tt = np.arange(N) / N
    sigs = {
        "tone": (np.cos(2 * np.pi * (N / 64) * tt), None),
        "tone-g1e3": (np.cos(2 * np.pi * (N / 64) * tt), 1e-3),
        "chirp-g1e3": (np.cos(2 * np.pi * ((N / 1024) * tt + (N / 8 - N
                       / 1024) / 2 * tt * tt)), 1e-3),
    }
    for name, (sig, gamma) in sigs.items():
        x = jnp.asarray(sig, dtype=jnp.float32)
        f = fns(scales, **({} if gamma is None else {"gamma": gamma}))
        for tr in ("ssq_cwt", "ssq_stft"):
            t, _ = time_call(f[tr], x, reps=5)
            record(f"160k-{tr}[{name}]", t, ref=REF_GPU_S[(N, tr)])

    print(json.dumps(results))


if __name__ == "__main__":
    main()
