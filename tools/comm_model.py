"""Cross-process collective traffic of one chunked transform call.

`comm_report` (parallel/chunked.py) counts the bytes each device sends
per collective. `cross_bytes` turns one such report into the bytes that
cross process boundaries when P processes share an n-device ring: ring
collectives (ppermute halos, all_gather) cross on exactly P edges, and
the all_to_all's uniform pairwise traffic crosses on (n - n/P)/(n-1) of
its bytes. Everything else stays inside one process.
"""
N_DEV = 8


def cross_bytes(rep: dict, P: int, n: int = N_DEV) -> int:
    """Bytes crossing process boundaries per call, from a comm_report
    dict, for P processes over an n-device ring."""
    if P <= 1:
        return 0
    total = 0
    for e in rep["collectives"]:
        if e["op"] == "ppermute":
            # per ring edge: the halo samples that edge carries (both
            # directions combined = the per-device send total)
            total += P * e["bytes_per_device"] * e["calls"]
        elif e["op"] == "all_gather":
            # ring all_gather: every edge carries (n-1) shard blocks
            total += P * e["bytes_per_device"]
        elif e["op"] == "all_to_all":
            # uniform pairwise: fraction of bytes with the peer in
            # another process = (n - n/P) / (n - 1)
            frac = (n - n // P) / (n - 1)
            total += int(e["calls"] * n * e["bytes_per_device"] * frac)
    return total
