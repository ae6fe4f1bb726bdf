"""pcd2tsdf: single cloud -> TSDF volume, device op vs host twin.

Equivalent of the reference's pcd2tsdf node
(/root/reference/test/pcd2tsdf.cpp:30-130 + launch/pcd2tsdf.launch): loads
a PCD (or synthesizes a scan), voxel-subsamples and demeans it, builds the
TSDF volume with BOTH the device fusion op and the exact integer host twin,
and reports agreement statistics + optional colored-PLY exports instead of
publishing RViz markers.

    python -m warpsense.eval.pcd2tsdf [--pcd cloud.pcd] [--out-dir DIR]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np


def run(cloud_mm: np.ndarray, *, tau: int = 600, resolution: int = 64,
        size=(201, 201, 121), max_weight_scaled: int = 32 * 64,
        host_compare_points: int = 256, out_dir: str | None = None) -> dict:
    import tempfile
    from pathlib import Path

    import jax.numpy as jnp

    from ..core.consts import MATRIX_RESOLUTION
    from ..map.global_map import GlobalMap
    from ..map.local_map import LocalMap, create_state
    from ..ops.tsdf import plan_raymarch, tsdf_update
    from ..ops.tsdf_reference import update_tsdf_reference

    up = np.array([0, 0, MATRIX_RESOLUTION], np.int64)
    max_range = int(np.max(np.linalg.norm(cloud_mm, axis=1))) + tau
    ms, mi = plan_raymarch(tau, resolution, max_range)

    def device_volume(pts):
        state = create_state(size, tau, 0, xp=jnp)
        t0 = time.perf_counter()
        state = tsdf_update(state, jnp.asarray(pts, jnp.int32),
                            jnp.ones((len(pts),), bool),
                            jnp.zeros(3, jnp.int32),
                            jnp.asarray(up, jnp.int32),
                            size=state.value.shape, tau=tau,
                            max_weight=max_weight_scaled,
                            resolution=resolution, max_steps=ms,
                            max_isteps=mi)
        state.value.block_until_ready()
        return state, (time.perf_counter() - t0) * 1000

    n = len(cloud_mm)
    device_volume(cloud_mm)                       # warmup (compile)
    state, device_ms = device_volume(cloud_mm)
    stats = {
        "points": int(n),
        "touched_voxels_device": int((np.asarray(state.weight) != 0).sum()),
        "device_ms": round(device_ms, 2),
    }

    # exact integer host-twin comparison on a subsample (the twin is a
    # per-point Python ray-march: faithful, not fast)
    if host_compare_points:
        stride = max(1, n // host_compare_points)
        sub = cloud_mm[::stride][:host_compare_points]
        sub_state, _ = device_volume(sub)
        gm = GlobalMap(Path(tempfile.mkdtemp()) / "pcd2tsdf_host", tau, 0)
        lm = LocalMap(size, gm)
        t0 = time.perf_counter()
        update_tsdf_reference(sub.astype(np.int64), np.zeros(3, np.int64),
                              up, lm, tau=tau, max_weight=max_weight_scaled,
                              resolution=resolution)
        host_ms = (time.perf_counter() - t0) * 1000
        gm.close()
        dv = np.asarray(sub_state.value, np.int32)
        dw = np.asarray(sub_state.weight, np.int32)
        hv = lm.state.value.astype(np.int32)
        hw = lm.state.weight.astype(np.int32)
        touched = (dw != 0) | (hw != 0)
        agree = (dv == hv) & (dw == hw)
        stats.update({
            "compare_points": int(len(sub)),
            "touched_voxels_host": int((hw != 0).sum()),
            "exact_agreement": (float(agree[touched].mean())
                                if touched.any() else 1.0),
            "value_mad_mm": (float(np.abs(dv - hv)[touched].mean())
                             if touched.any() else 0.0),
            "host_ms": round(host_ms, 2),
        })
    if out_dir is not None:
        from pathlib import Path

        from ..obs.viz import export_tsdf_ply
        out = Path(out_dir)
        out.mkdir(parents=True, exist_ok=True)
        stats["device_ply"] = str(out / "tsdf_device.ply")
        export_tsdf_ply(out / "tsdf_device.ply", state,
                        resolution=resolution, tau=tau)
    return stats


def _load_cloud(args) -> np.ndarray:
    if args.pcd:
        from ..io.pcd import read_pcd
        cloud_m = read_pcd(args.pcd)[:, :3]
    else:
        from ..io.synthetic import BoxWorld, render_scan
        scan = render_scan(BoxWorld.default(), np.eye(4), channels=32,
                           columns=512)
        cloud_m = scan.reshape(-1, 3)
        cloud_m = cloud_m[np.any(cloud_m != 0, axis=1)]
    # demean + voxel-center subsample like the reference driver
    cloud_m = cloud_m - cloud_m.mean(axis=0, keepdims=True)
    mm = np.round(cloud_m * 1000).astype(np.int64)
    vox = mm // args.resolution
    _, keep = np.unique(vox, axis=0, return_index=True)
    centers = vox[np.sort(keep)] * args.resolution + args.resolution // 2
    return centers


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pcd", default=None, help="input cloud (synthetic if unset)")
    ap.add_argument("--tau", type=int, default=600)
    ap.add_argument("--resolution", type=int, default=64)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args(argv)
    cloud = _load_cloud(args)
    stats = run(cloud, tau=args.tau, resolution=args.resolution,
                out_dir=args.out_dir)
    print(json.dumps(stats))


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
