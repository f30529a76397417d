"""Benchmark: ssq_cwt throughput on one GPU, replicating the reference's
headline config (old/examples/benchmarks.py:80-126): N=160000 float32,
~300 scale rows, default GMW, maprange='peak'.

Prints the card (`nvidia-smi` name and power limit) and the per-cell
times on stderr, then ONE JSON line on stdout:
  {"metric": ..., "value": ..., "unit": "MSamples/s", "vs_baseline": ...,
   "device": {...}, "card": ...}

Baseline: reference GPU (GTX 1070) 160k-ssq_cwt = 0.0856 s
          -> 1.869 MSamples/s (old/README.md:53; BASELINE.md).

Each cell is the median of several calls, each ended by
`block_until_ready`; the compiling first call is not counted. Exits
nonzero when JAX finds no GPU.
"""
import json
import sys

import numpy as np

BASELINE = {  # seconds, reference GPU (old/README.md:47-54)
    "160k-cwt": 0.0367,
    "160k-stft": 0.0643,
    "160k-ssq_cwt": 0.0856,
    "160k-ssq_stft": 0.159,
}
BASELINE_MSPS = 160000 / BASELINE["160k-ssq_cwt"] / 1e6


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
    print(card, file=sys.stderr)

    N = 160000
    n_rows = 300
    n_fft = n_rows * 2 - 2
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(N), dtype=jnp.float32)
    x_tone = jnp.asarray(np.cos(2 * np.pi * (N / 64) * np.arange(N) / N),
                         dtype=jnp.float32)

    wavelet = Wavelet.build("gmw")
    scales = process_scales("log-piecewise", N, wavelet)[:n_rows]

    cells = {
        "160k-ssq_cwt": (jax.jit(lambda x: ssq_cwt(
            x, wavelet, scales=scales, fs=1.0, dtype="float32")[0]), x),
        "160k-cwt": (jax.jit(lambda x: cwt(
            x, wavelet, scales=scales, dtype="float32")[0]), x),
        "160k-stft": (jax.jit(lambda x: stft(
            x, n_fft=n_fft, hop_len=1, dtype="float32")), x),
        "160k-ssq_stft": (jax.jit(lambda x: ssq_stft(
            x, n_fft=n_fft, dtype="float32")[0]), x),
        "160k-ssq_cwt_tone_g1e3": (jax.jit(lambda x: ssq_cwt(
            x, wavelet, scales=scales, fs=1.0, gamma=1e-3,
            dtype="float32")[0]), x_tone),
    }
    times = {}
    for name, (fn, arg) in cells.items():
        times[name], _ = time_call(fn, arg, reps=10)
        print(f"{name}: {times[name] * 1e3:.3f} ms  [{card}]",
              file=sys.stderr, flush=True)

    msps = N / times["160k-ssq_cwt"] / 1e6
    print(json.dumps({
        "metric": "ssq_cwt_160k_throughput",
        "value": msps,
        "unit": "MSamples/s",
        "vs_baseline": msps / BASELINE_MSPS,
        "cells_s": times,
        "n_rows": len(scales),
        "device": device_summary(),
        "card": card,
    }))


if __name__ == "__main__":
    main()
