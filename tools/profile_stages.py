"""Per-stage device time of the four forward transforms on one GPU.

For ssq_cwt, cwt, stft (hop 1), ssq_stft and istft at the reference's
benchmark size (N = 160,000 float32, default GMW, n_fft = 598), prints
the warm wall time (median of `block_until_ready` calls), then traces a
few calls with `jax.profiler` and sums the GPU kernels' durations per
(HLO module, HLO op). The device's idle share is 1 - busy / warm: the
busy time per traced call over the untraced warm median (tracing itself
widens the gaps between kernels, so the traced window overstates it).
Also times, in the same process: the reassignment scatter on complex64
against two float32 scatters, on the bin maps of ssq_cwt of a tone and
of the chip_smoke signal as well as on uniformly random bins; the STFT
on its matmul and its rfft engine; and a large copy (the achievable
memory bandwidth).

Run: python tools/profile_stages.py [--out stages.json]
"""
import argparse
import glob
import json
import os
import sys
import tempfile
from collections import defaultdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def reduce_trace(path):
    """Sum GPU kernel durations per (hlo_module, hlo_op) in one
    .xplane.pb; busy = union of kernel intervals per device plane."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    groups = defaultdict(lambda: [0.0, 0, set()])
    spans = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                st = dict(ev.stats)
                key = (str(st.get("hlo_module", "?")),
                       str(st.get("hlo_op", ev.name)))
                g = groups[key]
                g[0] += ev.duration_ns
                g[1] += 1
                g[2].add(ev.name[:80])
                spans.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy = 0.0
    if spans:
        spans.sort()
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        window = spans[-1][1] - spans[0][0]
    else:
        window = 0.0
    rows = sorted(((k[0], k[1], v[0], v[1], sorted(v[2]))
                   for k, v in groups.items()), key=lambda r: -r[2])
    return {"busy_ns": busy, "window_ns": window,
            "kernels": [dict(module=m, op=o, total_ns=t, count=c,
                             names=n[:3]) for m, o, t, c, n in rows]}


def trace(fn, arg, reps=3):
    import jax
    d = tempfile.mkdtemp(prefix="ssq_trace_")
    with jax.profiler.trace(d):
        for _ in range(reps):
            jax.block_until_ready(fn(arg))
    files = glob.glob(os.path.join(d, "plugins", "profile", "*",
                                   "*.xplane.pb"))
    out = reduce_trace(files[0])
    out["reps"] = reps
    return out


N = 160_000          # the reference's benchmark length
N_FFT = 598
COPY_BYTES = 4 << 30  # read once and written once by the bandwidth probe


def scatter_operands(x):
    """(k, vals, nf): the bin map and the values ssq_cwt's scatter adds
    for signal x, from the transform's own phase-and-bin stage, and the
    number of bins."""
    import jax
    import jax.numpy as jnp
    from ssqueeze_rs_tpu import ssq_cwt
    from ssqueeze_rs_tpu.scales import process_scales
    from ssqueeze_rs_tpu.ops.ssqueeze import plan_reassignment, phase_bin
    _, Wx, fr, sc, dWx = ssq_cwt(x, get_dWx=True)
    sc, stype, na, nv = process_scales(sc, len(x), get_params=True)
    const, mode, params = plan_reassignment(
        np.asarray(fr)[::-1], na, True, transform="cwt", cwt_scaletype=stype,
        nv=nv, scales=sc)
    gamma = 10 * float(np.finfo(np.float32).eps)
    k, vals = jax.jit(lambda W, dW: phase_bin(
        W, dW, jnp.asarray(const, jnp.float32), gamma,
        jnp.zeros((na,), jnp.float32), params, mode=mode, flipud=True,
        fused=True, transform="cwt", nf=len(fr)))(Wx, dWx)
    return k, vals, len(fr)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the full summary as JSON")
    args = ap.parse_args()

    import importlib
    import jax
    import jax.numpy as jnp
    from ssqueeze_rs_tpu import ssq_cwt, cwt, stft, ssq_stft, istft
    from ssqueeze_rs_tpu.config import enable_persistent_cache
    from ssqueeze_rs_tpu.utils.device import (require_gpu, device_summary,
                                              card_line, time_call)

    stft_mod = importlib.import_module("ssqueeze_rs_tpu.ops.stft")
    require_gpu()
    enable_persistent_cache()
    card = card_line()
    n_fft = N_FFT
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(N), jnp.float32)
    res = {"device": device_summary(), "card": card, "N": N,
           "n_fft": n_fft, "transforms": {}, "ab": {}}

    cells = {
        "ssq_cwt": lambda v: ssq_cwt(v)[0],
        "cwt": lambda v: cwt(v)[0],
        "stft": lambda v: stft(v, n_fft=n_fft, hop_len=1),
        "ssq_stft": lambda v: ssq_stft(v, n_fft=n_fft)[0],
        "istft": lambda S: istft(S, n_fft=n_fft, N=N),
    }
    Sx = jax.block_until_ready(cells["stft"](x))
    for name, fn in cells.items():
        arg = Sx if name == "istft" else x
        t, ts = time_call(fn, arg, reps=10)
        r = trace(fn, arg)
        busy = r["busy_ns"] / r["reps"] / 1e9
        r.update(warm_s=t, warm_all_s=ts, idle_share=1 - busy / t)
        res["transforms"][name] = r
        print(f"== {name}: warm {t * 1e3:.3f} ms (min {min(ts) * 1e3:.3f},"
              f" max {max(ts) * 1e3:.3f}); busy {busy * 1e3:.3f} ms/call; "
              f"idle share {1 - busy / t:.3f} (traced window "
              f"{r['window_ns'] / r['reps'] / 1e6:.3f} ms/call)  [{card}]",
              flush=True)
        for k in r["kernels"][:12]:
            print(f"   {k['total_ns'] / r['reps'] / 1e6:9.3f} ms/call "
                  f"x{k['count'] // r['reps']:<4} {k['module']}:{k['op']} "
                  f"{k['names'][:1]}", flush=True)

    # A/B: complex64 scatter vs two float32 scatters, on the bin maps the
    # reassignment really sees (a tone concentrates every column's mass in
    # a few bins; the chip_smoke signal is two tones, a chirp and noise)
    # and on uniformly random bins
    from chip_smoke import signal
    ops = {"tone": scatter_operands(jnp.asarray(
               np.cos(2 * np.pi * 0.05 * np.arange(N)), jnp.float32)),
           "chip_smoke_signal": scatter_operands(jnp.asarray(
               signal(np.random.default_rng(0), N)))}
    na, nf = ops["tone"][1].shape[0], ops["tone"][2]
    ops["random"] = (
        jnp.asarray(rng.integers(0, nf, (na, N)), jnp.int32),
        jnp.asarray(rng.standard_normal((na, N)) +
                    1j * rng.standard_normal((na, N)), jnp.complex64), nf)
    cols = jnp.arange(N, dtype=jnp.int32)[None, :]

    @jax.jit
    def scatter_c64(k, vals):
        return jnp.zeros((nf, N), jnp.complex64).at[k, cols].add(vals)

    @jax.jit
    def scatter_2xf32(k, vals):
        z = jnp.zeros((nf, N), jnp.float32)
        return jax.lax.complex(z.at[k, cols].add(vals.real),
                               z.at[k, cols].add(vals.imag))

    for bins, (k, vals, _) in ops.items():
        counts = np.bincount(np.asarray(k).ravel(), minlength=nf)
        print(f"== scatter on {bins} bins ({na} x {N} into {nf} bins; "
              f"busiest bin takes {counts.max() / k.size:.3f} of values)",
              flush=True)
        for name, fn in (("scatter_c64", scatter_c64),
                         ("scatter_2xf32", scatter_2xf32)):
            t, ts = time_call(fn, k, vals, reps=10)
            r = trace(lambda a: fn(a, vals), k)
            res["ab"][f"{name}[{bins}]"] = dict(
                warm_s=t, warm_all_s=ts, kernels=r["kernels"][:6],
                busy_ns=r["busy_ns"], reps=r["reps"])
            print(f"   {name}: warm {t * 1e3:.3f} ms (min "
                  f"{min(ts) * 1e3:.3f}, max {max(ts) * 1e3:.3f})  [{card}]",
                  flush=True)
            for kk in r["kernels"][:4]:
                print(f"   {kk['total_ns'] / r['reps'] / 1e6:9.3f} ms/call "
                      f"{kk['module']}:{kk['op']} {kk['names'][:1]}",
                      flush=True)
    del ops

    # A/B: STFT engines (matmul vs rfft on the same frames)
    for name, cap in (("stft_matmul", stft_mod.MATMUL_NFFT_MAX),
                      ("stft_rfft", 0)):
        stft_mod.MATMUL_NFFT_MAX = cap
        stft_mod._stft_program.cache_clear()
        for tr in ("stft", "ssq_stft"):
            fn = cells[tr]
            t, _ = time_call(fn, x, reps=10)
            res["ab"][f"{tr}[{name}]"] = dict(warm_s=t)
            print(f"== {tr} via {name}: warm {t * 1e3:.3f} ms  [{card}]",
                  flush=True)
    stft_mod.MATMUL_NFFT_MAX = 2048
    stft_mod._stft_program.cache_clear()

    # achievable bandwidth: read + write of a large float32 array
    big = jnp.ones((COPY_BYTES // 4,), jnp.float32)
    copy = jax.jit(lambda a: a * 2.0)
    t, _ = time_call(copy, big, reps=10)
    res["copy_GBps"] = 2 * big.nbytes / t / 1e9
    print(f"== copy (read+write {2 * big.nbytes >> 20} MiB): "
          f"{t * 1e3:.3f} ms = "
          f"{res['copy_GBps']:.0f} GB/s  [{card}]", flush=True)
    st = jax.devices()[0].memory_stats() or {}
    res["peak_bytes_in_use"] = st.get("peak_bytes_in_use")
    print(card)

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
