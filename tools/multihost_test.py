"""REAL two-process multi-host validation (CPU backend).

Spawns two `jax.distributed` worker processes, each owning 4 virtual
CPU devices (8 global), and runs the sharded transforms over a
(1, 8) 'time' mesh so the halo exchange crosses the PROCESS boundary —
the multi-process analog of a multi-host run. Each worker independently
checks its local output shards against the locally-computed unsharded
transform:

  * chunked_stft: bit-exact per shard,
  * chunked_ssq_cwt (hybrid exact path incl. cross-process all_gather +
    all_to_all): interior tolerance.

Run:  python tools/multihost_test.py          (driver; exit 0 = pass)
      python tools/multihost_test.py worker <i> <port>   (internal)

This upgrades the multi-host story from "compile-validated on a
virtual mesh" to "executed across real process boundaries" — the
reference has no distributed tests at all (SURVEY §4).
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pid: int, port: int) -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=2, process_id=pid)
    assert jax.process_count() == 2, jax.process_count()
    assert jax.device_count() == 8, jax.device_count()
    assert jax.local_device_count() == 4

    sys.path.insert(0, REPO)
    from jax.sharding import PartitionSpec as P
    from ssqueeze_rs_tpu import stft, istft, ssq_cwt, issq_cwt
    from ssqueeze_rs_tpu.parallel import (make_host_chip_mesh,
                                          global_from_local, is_distributed,
                                          chunked_stft, chunked_ssq_cwt,
                                          chunked_istft, chunked_issq_cwt)

    assert is_distributed()
    # all 8 devices on 'time': halos cross the process boundary
    mesh = make_host_chip_mesh(time_parallel=8)
    assert mesh.devices.shape == (1, 8)

    N = 2048
    rng = np.random.default_rng(0)          # same signal in both workers
    t = np.arange(N) / N
    x = (np.cos(2 * np.pi * 128 * t) +
         0.1 * rng.standard_normal(N)).astype(np.float64)

    # build the global sharded input from per-process local halves
    S_local = N // 2
    x_local = x[pid * S_local:(pid + 1) * S_local]
    xg = global_from_local(x_local, mesh, P("time"))

    # 1. sharded STFT across processes: local shards bit-equal the
    #    locally computed unsharded transform's columns
    kw = dict(window="hann", n_fft=128, hop_len=4, dtype="float64")
    Sx = chunked_stft(xg, mesh, batch_axis_name=None, **kw)
    ref = np.asarray(stft(x, modulated=True, **kw))
    for shard in Sx.addressable_shards:
        c0 = shard.index[-1].start or 0
        got = np.asarray(shard.data)
        want = ref[..., c0:c0 + got.shape[-1]]
        assert np.array_equal(got, want), \
            f"pid{pid}: STFT shard at col {c0} diverges"

    # 1b. sharded istft ACROSS the process boundary: the frame-column
    #     halo (lax.ppermute) crosses DCN here; shards bit-equal the
    #     unsharded XLA istft (the chunked_istft exactness contract)
    xr_g = chunked_istft(Sx, mesh, window="hann", n_fft=128, hop_len=4,
                         N=N)
    xr_ref = np.asarray(istft(ref, window="hann", n_fft=128, hop_len=4,
                              N=N))
    for shard in xr_g.addressable_shards:
        c0 = shard.index[-1].start or 0
        got = np.asarray(shard.data)
        assert np.array_equal(got, xr_ref[..., c0:c0 + got.shape[-1]]), \
            f"pid{pid}: istft shard at col {c0} diverges"

    # 2. hybrid exact chunked ssq_cwt: all_gather + all_to_all span the
    #    process boundary; interior columns match the full transform
    wav = ("gmw", {"beta": 8.0})
    Tx, Wx, fr, sc = chunked_ssq_cwt(xg, mesh, wavelet=wav, scales="log",
                                     nv=16, fs=float(N), dtype="float64")
    Tr, Wr, fr_r, sc_r = ssq_cwt(x, wav, scales="log", nv=16, fs=float(N),
                                 dtype="float64")
    Wr = np.asarray(Wr)
    wmax = np.abs(Wr).max()
    for shard in Wx.addressable_shards:
        c0 = shard.index[-1].start or 0
        got = np.asarray(shard.data)
        want = Wr[..., c0:c0 + got.shape[-1]]
        rel = np.abs(got - want).max() / wmax
        assert rel < 1e-5, f"pid{pid}: CWT shard at col {c0} rel={rel:.2e}"

    # 2b. sharded issq_cwt (column-local): shards bit-equal the
    #     unsharded inverse of the SAME sharded Tx
    Tx_full = np.zeros(Tx.shape, np.complex128)
    for shard in Tx.addressable_shards:      # assemble this proc's view
        c0 = shard.index[-1].start or 0
        Tx_full[..., c0:c0 + shard.data.shape[-1]] = np.asarray(shard.data)
    xs_g = chunked_issq_cwt(Tx, mesh, wavelet=wav)
    for shard in xs_g.addressable_shards:
        c0 = shard.index[-1].start or 0
        got = np.asarray(shard.data)
        want = np.asarray(issq_cwt(
            Tx_full[..., c0:c0 + got.shape[-1]], wav))
        assert np.array_equal(got, want), \
            f"pid{pid}: issq_cwt shard at col {c0} diverges"

    print(f"worker {pid}: MULTIHOST OK "
          f"(procs={jax.process_count()}, devices={jax.device_count()})",
          flush=True)


def worker4(pid: int, port: int) -> None:
    """4-process (data=2, time=4) grid: BOTH mesh axes span process
    boundaries — 'time' halos + the hybrid path's all_gather/all_to_all
    cross 2 processes, and each 'data' row pairs two processes
    (VERDICT r2 #4)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                               num_processes=4, process_id=pid)
    assert jax.process_count() == 4 and jax.device_count() == 8
    assert jax.local_device_count() == 2

    sys.path.insert(0, REPO)
    from jax.sharding import PartitionSpec as P
    from ssqueeze_rs_tpu import stft, ssq_cwt
    from ssqueeze_rs_tpu.parallel import (make_host_chip_mesh,
                                          global_from_local,
                                          chunked_stft, chunked_ssq_cwt)

    # host-major (2, 4): row 0 = procs {0,1}, row 1 = procs {2,3}
    mesh = make_host_chip_mesh(time_parallel=4)
    assert mesh.devices.shape == (2, 4)
    rows = [[d.process_index for d in r] for r in mesh.devices]
    assert rows == [[0, 0, 1, 1], [2, 2, 3, 3]], rows

    B, N = 2, 2048
    rng = np.random.default_rng(0)          # same signal in all workers
    t = np.arange(N) / N
    X = np.stack([np.cos(2 * np.pi * 128 * t),
                  np.sin(2 * np.pi * 64 * t)])
    X = (X + 0.1 * rng.standard_normal((B, N))).astype(np.float64)

    # this process's local slab of the (data, time)-sharded global array
    S2 = N // 2                             # 2 local time shards
    b = pid // 2
    c0 = (pid % 2) * S2
    Xg = global_from_local(X[b:b + 1, c0:c0 + S2], mesh,
                           P("data", "time"))
    assert Xg.shape == (B, N)

    # 1. batched sharded STFT across the process grid: bit-exact shards
    kw = dict(window="hann", n_fft=128, hop_len=4, dtype="float64")
    Sx = chunked_stft(Xg, mesh, batch_axis_name="data", **kw)
    ref = np.asarray(stft(X, modulated=True, **kw))
    for shard in Sx.addressable_shards:
        bi = shard.index[0].start or 0
        ci = shard.index[-1].start or 0
        got = np.asarray(shard.data)
        want = ref[bi:bi + got.shape[0], ..., ci:ci + got.shape[-1]]
        assert np.array_equal(got, want), \
            f"pid{pid}: STFT shard (b={bi}, col={ci}) diverges"

    # 2. hybrid exact chunked ssq_cwt over the full grid
    wav = ("gmw", {"beta": 8.0})
    Tx, Wx, fr, sc = chunked_ssq_cwt(Xg, mesh, wavelet=wav, scales="log",
                                     nv=16, fs=float(N), dtype="float64",
                                     batch_axis_name="data")
    Wr = np.asarray(ssq_cwt(X, wav, scales="log", nv=16, fs=float(N),
                            dtype="float64")[1])
    wmax = np.abs(Wr).max()
    for shard in Wx.addressable_shards:
        bi = shard.index[0].start or 0
        ci = shard.index[-1].start or 0
        got = np.asarray(shard.data)
        want = Wr[bi:bi + got.shape[0], :, ci:ci + got.shape[-1]]
        rel = np.abs(got - want).max() / wmax
        assert rel < 1e-5, \
            f"pid{pid}: CWT shard (b={bi}, col={ci}) rel={rel:.2e}"

    print(f"worker4 {pid}: MULTIHOST OK "
          f"(procs={jax.process_count()}, devices={jax.device_count()})",
          flush=True)


def driver(n_procs: int = 2) -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dev_per_proc = 4 if n_procs == 2 else 8 // n_procs
    role = "worker" if n_procs == 2 else "worker4"
    env = dict(os.environ,
               JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "") +
                          f" --xla_force_host_platform_device_count="
                          f"{dev_per_proc}"),
               PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), role, str(i),
         str(port)], env=env) for i in range(n_procs)]
    rcs = [p.wait(timeout=600) for p in procs]
    ok = all(rc == 0 for rc in rcs)
    print("MULTIHOST", "ALL PASS" if ok else f"FAILED rcs={rcs}")
    return 0 if ok else 1


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "worker":
        worker(int(sys.argv[2]), int(sys.argv[3]))
    elif len(sys.argv) > 1 and sys.argv[1] == "worker4":
        worker4(int(sys.argv[2]), int(sys.argv[3]))
    elif len(sys.argv) > 1 and sys.argv[1] == "4":
        sys.exit(driver(4))
    else:
        sys.exit(driver(2))
