"""BASELINE north star: ssq_cwt over 1 h of 1 kHz x 64-channel audio.

Streams a channel-major raw recording through `process_recording`
(native mmap + C++ double-buffered prefetch -> chunked on-device
transforms with channel sub-batching) and reports MSamples/s.

    python examples/production_64ch.py            # full 1 h x 64 ch
    python examples/production_64ch.py --small    # 1 min x 8 ch (CI)

The reference's corresponding path is the dask map_overlap script over
a parquet electrophysiology file (tests/ssq_cwt_test.py:352-380), which
it never benchmarks.
"""
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    small = "--small" in sys.argv
    fs = 1000.0
    C = 8 if small else 64
    N = int(60 * fs) if small else int(3600 * fs)
    path = "/tmp/ssq_prod_recording.f32"

    # synthesize: per-channel chirp + tone + noise, streamed to disk
    print(f"synthesizing {C} ch x {N} samples "
          f"({C * N * 4 / 1e9:.2f} GB) ...", flush=True)
    rng = np.random.default_rng(0)
    with open(path, "wb") as f:
        for c in range(C):
            t = np.arange(N) / fs
            x = (np.sin(2 * np.pi * (20 + 5 * c) * t) +
                 0.5 * np.sin(2 * np.pi * (100 + 170 * t / t[-1]) * t) +
                 0.1 * rng.standard_normal(N))
            f.write(x.astype(np.float32).tobytes())
        del t, x

    from ssqueeze_rs_tpu.parallel import process_recording

    # 'energy' reduces on device to the (C, rows) spectral profile:
    # the full TF fetch (~16 B/sample) otherwise dominates wall time
    mode = "energy" if "--energy" in sys.argv else "numpy"
    chunk_len = 250_000 if small else 1_000_000
    t0 = time.perf_counter()
    result, meta = process_recording(
        path, transform="ssq_cwt", fs=fs, n_channels=C,
        chunk_len=chunk_len, scales="log-piecewise", dtype="float32",
        out=mode)
    dt = time.perf_counter() - t0
    msps = C * N / dt / 1e6
    rows = result.shape[-2] if mode == "numpy" else result.shape[-1]
    print(f"ssq_cwt[{mode}] {C} ch x {N} samples ({rows} rows): "
          f"{dt:.1f} s -> {msps:.2f} MSamples/s", flush=True)
    print(f"output {result.shape}, ssq_freqs "
          f"[{meta['ssq_freqs'].min():.3f}, {meta['ssq_freqs'].max():.1f}]")
    os.remove(path)
    return msps


if __name__ == "__main__":
    main()
