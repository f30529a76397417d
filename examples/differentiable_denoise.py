"""Gradient-based denoising THROUGH the synchrosqueezed transform.

A capability the reference stack has at no layer (numba/CUDA/Rust
kernels are not differentiable; old/ssqueezepy has no autodiff): here
`ssq_cwt` — FFTs, phase transform and the reassignment scatter — is
differentiable by JAX autodiff end-to-end (bin indices are
piecewise-constant, so cotangents flow through the accumulated values),
so a signal can be OPTIMIZED against a time-frequency objective with
plain `jax.grad`.

Demo: recover a clean two-component signal from a noisy observation by
minimizing

    L(x) = mean (x - y)^2 / sigma^2  +  lam * mean |Tx(x)|

The synchrosqueezed L1 term is a sparsity prior in the reassigned TF
plane (clean AM/FM components occupy few ssq bins; broadband noise
cannot concentrate), i.e. basis-pursuit denoising with ssq_cwt as the
analysis operator. Optimized with optax.adam; every step is ONE jitted
program (value_and_grad through the whole transform).

Run:  python examples/differentiable_denoise.py [--small]
Prints per-iteration loss and the final SNR improvement (dB).
"""
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main():
    import jax
    import jax.numpy as jnp
    import optax
    from ssqueeze_rs_tpu import ssq_cwt, mad_rms

    small = "--small" in sys.argv
    N = 2048 if small else 8192
    fs = float(N)
    steps = 150
    rng = np.random.default_rng(0)

    # clean: a tone + a quadratic chirp; observed: + white noise
    t = np.arange(N) / fs
    clean = (np.sin(2 * np.pi * 0.10 * fs * t)
             + 0.8 * np.sin(2 * np.pi * fs * (0.05 * t + 0.15 * t ** 2)))
    sigma = 0.5
    y = (clean + sigma * rng.standard_normal(N)).astype(np.float32)
    yj = jnp.asarray(y)
    wav = ("gmw", {"beta": 8.0})

    # lam balances the two means: at lam ~ 1 the prior can only
    # afford ~0.04 rms movement against the 1/sigma^2 fidelity; the
    # measured sweep (lam 10/30/100/300/1000 -> +0.15/+0.44/+1.3/+2.4/
    # -2.7 dB on this signal class) peaks near 300 before over-shrinkage
    lam = 300.0

    def loss(x):
        Tx = ssq_cwt(x, wav, scales="log", nv=16, fs=fs,
                     dtype="float32")[0]
        fidelity = jnp.mean((x - yj) ** 2) / (sigma ** 2)
        sparsity = jnp.mean(jnp.abs(Tx))
        return fidelity + lam * sparsity

    opt = optax.adam(5e-2)
    x = yj
    state = opt.init(x)

    @jax.jit
    def step(x, state):
        val, g = jax.value_and_grad(loss)(x)
        updates, state = opt.update(g, state)
        return optax.apply_updates(x, updates), state, val

    t0 = time.perf_counter()
    if "--host-loop" in sys.argv:
        # one dispatch per step, with a host round trip each
        for i in range(steps):
            x, state, val = step(x, state)
            if i % 30 == 0 or i == steps - 1:
                print(f"step {i:3d}  loss {float(val):10.4f}", flush=True)
    else:
        # the WHOLE optimization is one compiled program (lax.scan over
        # steps), one dispatch, no host round trips
        @jax.jit
        def optimize(x, state):
            def body(carry, _):
                x, state = carry
                x, state, val = step(x, state)
                return (x, state), val
            (x, state), vals = jax.lax.scan(body, (x, state), None,
                                            length=steps)
            return x, vals

        x, vals = optimize(x, state)
        vals = np.asarray(vals)
        for i in (0, steps // 2, steps - 1):
            print(f"step {i:3d}  loss {vals[i]:10.4f}", flush=True)
    x = np.asarray(jax.block_until_ready(x))
    dt = time.perf_counter() - t0

    def snr(sig):
        return 10 * np.log10(np.sum(clean ** 2)
                             / max(np.sum((sig - clean) ** 2), 1e-30))

    print(f"{steps} steps in {dt:.1f}s "
          f"({dt / steps * 1e3:.0f} ms/step incl. host loop)")
    print(f"SNR: noisy {snr(y):6.2f} dB -> denoised {snr(x):6.2f} dB "
          f"(mad_rms {float(mad_rms(clean, x)):.3f} vs "
          f"{float(mad_rms(clean, y)):.3f})")
    gain = snr(x) - snr(y)
    print(f"gain {gain:+.2f} dB")
    assert gain > 1.0, "denoising through ssq_cwt should improve SNR"


if __name__ == "__main__":
    main()
