"""Device enumeration sanity tool — the reference ships NVIDIA's
``deviceQuery`` sample for this (built at CMakeLists.txt:106-111).

Prints one JSON object per accelerator with the fields that matter for
this framework's rooflines: platform, device kind, HBM capacity, core
count, and a measured HBM-bandwidth spot check (the TSDF average sweep and
the registration field precompute are bandwidth-bound, SURVEY §6).

    python -m warpsense.utils.device_query [--bandwidth]
"""
from __future__ import annotations

import argparse
import json
import time


def query(bandwidth: bool = False) -> list[dict]:
    import jax

    out = []
    for d in jax.devices():
        info = {
            "id": d.id,
            "platform": d.platform,
            "kind": getattr(d, "device_kind", "unknown"),
            "process_index": d.process_index,
            "backend": jax.default_backend(),
        }
        stats = {}
        try:
            stats = d.memory_stats() or {}
        except Exception:
            pass
        if "bytes_limit" in stats:
            info["hbm_bytes"] = int(stats["bytes_limit"])
        if bandwidth:
            info["hbm_read_gbps"] = round(_measure_bandwidth(d), 1)
        out.append(info)
    return out


def _measure_bandwidth(device) -> float:
    """Spot-check sequential HBM read bandwidth with a reduction sweep."""
    import jax
    import jax.numpy as jnp

    n = 64 * 1024 * 1024  # 256 MB of f32
    x = jax.device_put(jnp.ones((n,), jnp.float32), device)
    f = jax.jit(jnp.sum)
    float(f(x))  # compile + warm
    reps, best = 5, float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        float(f(x))
        best = min(best, time.perf_counter() - t0)
    return 4.0 * n / best / 1e9


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--bandwidth", action="store_true",
                    help="measure HBM read bandwidth per device")
    args = ap.parse_args()
    for info in query(bandwidth=args.bandwidth):
        print(json.dumps(info))


if __name__ == "__main__":
    main()
