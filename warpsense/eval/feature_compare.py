"""feature_compare: featsense features vs host twin vs ORIGINAL F-LOAM.

Equivalent of the reference's ``feature_compare_node``
(/root/reference/test/feature_compare.cpp), which publishes edge/surf
features from the vendored original F-LOAM and the featsense variants on
one cloud for visual RViz comparison.  Here the comparison is quantified
three ways on the same organized scan:

* device op vs loop-exact featsense host twin (same spec — regression);
* device op vs the INDEPENDENT original-F-LOAM selection
  (frontends/featsense/floam_original.py, reproducing
  /root/reference/test/floam.h:150-245) — a different algorithm by
  design, so the report shows counts + overlap, catching any shared
  misreading of the featsense spec.

    python -m warpsense.eval.feature_compare [--pcd cloud.pcd]
        [--channels 128 --columns 1024] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import time


def run(cloud: "np.ndarray", *, edge_capacity: int = 2048,
        surf_capacity: int = 4096, out_dir: str | None = None) -> dict:
    import jax.numpy as jnp
    import numpy as np

    from ..frontends.featsense import features as dev
    from ..frontends.featsense import features_reference as ref

    H, W = cloud.shape[:2]
    params_ref = ref.FeatureParams()

    t0 = time.perf_counter()
    e_ref, s_ref = ref.extract_features(cloud, params_ref)
    host_s = time.perf_counter() - t0

    jc = jnp.asarray(cloud, jnp.float32)
    out = dev.extract_features(jc, edge_capacity=edge_capacity,
                               surf_capacity=surf_capacity)
    (e_pts, e_mask, e_idx), (s_pts, s_mask, s_idx) = out
    e_pts.block_until_ready()
    t0 = time.perf_counter()
    (e_pts, e_mask, e_idx), (s_pts, s_mask, s_idx) = dev.extract_features(
        jc, edge_capacity=edge_capacity, surf_capacity=surf_capacity)
    e_pts.block_until_ready()
    dev_s = time.perf_counter() - t0

    e_dev = set(np.asarray(e_idx)[np.asarray(e_mask)].tolist())
    s_dev = set(np.asarray(s_idx)[np.asarray(s_mask)].tolist())
    e_set, s_set = set(map(int, e_ref)), set(map(int, s_ref))

    # independent twin: the ORIGINAL F-LOAM rules (test/floam.h)
    from ..frontends.featsense.floam_original import floam_original_features
    t0 = time.perf_counter()
    e_fl, s_fl = floam_original_features(cloud.reshape(-1, 3))
    floam_s = time.perf_counter() - t0
    e_flo, s_flo = set(map(int, e_fl)), set(map(int, s_fl))

    def jaccard(a, b):
        return len(a & b) / max(len(a | b), 1)

    def recall(dev, other):
        """Fraction of the other algorithm's picks the device also found."""
        return len(dev & other) / max(len(other), 1)

    result = {
        "metric": "feature_compare",
        "edges": {"host": len(e_set), "device": len(e_dev),
                  "floam": len(e_flo),
                  "jaccard": round(jaccard(e_set, e_dev), 4),
                  "floam_recall": round(recall(e_dev, e_flo), 4),
                  "floam_precision": round(recall(e_flo, e_dev), 4)},
        "surfs": {"host": len(s_set), "device": len(s_dev),
                  "floam": len(s_flo),
                  "jaccard": round(jaccard(s_set, s_dev), 4),
                  "floam_recall": round(recall(s_dev, s_flo), 4),
                  "floam_precision": round(recall(s_flo, s_dev), 4)},
        "host_ms": round(host_s * 1e3, 1),
        "device_ms": round(dev_s * 1e3, 1),
        "floam_ms": round(floam_s * 1e3, 1),
    }
    if out_dir is not None:
        from pathlib import Path

        from ..io.pcd import write_ply
        d = Path(out_dir)
        d.mkdir(parents=True, exist_ok=True)
        flat = cloud.reshape(-1, 3)
        write_ply(d / "edges_host.ply", flat[sorted(e_set)])
        write_ply(d / "surfs_host.ply", flat[sorted(s_set)])
        write_ply(d / "edges_device.ply",
                  np.asarray(e_pts)[np.asarray(e_mask)])
        write_ply(d / "surfs_device.ply",
                  np.asarray(s_pts)[np.asarray(s_mask)])
        result["out_dir"] = str(d)
    return result


def main() -> None:
    import numpy as np

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcd", default=None, help="organized cloud to load")
    ap.add_argument("--channels", type=int, default=64)
    ap.add_argument("--columns", type=int, default=512)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()

    if args.pcd is not None:
        from ..io.pcd import read_pcd
        pts = read_pcd(args.pcd).astype(np.float32)
        n = args.channels * args.columns
        if len(pts) < n:
            pts = np.concatenate([pts, np.zeros((n - len(pts), 3), np.float32)])
        cloud = pts[:n].reshape(args.channels, args.columns, 3)
    else:
        from ..io.synthetic import BoxWorld, render_scan
        cloud = render_scan(BoxWorld.default(), np.eye(4),
                            channels=args.channels, columns=args.columns,
                            max_range=22.0, noise_std=0.005,
                            rng=np.random.default_rng(0))
    print(json.dumps(run(cloud, out_dir=args.out_dir)))


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
