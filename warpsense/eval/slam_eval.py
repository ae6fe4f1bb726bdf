"""End-to-end SLAM evaluation: ATE + throughput for both pipelines.

The reference evaluates trajectories externally (evo/HILTI,
/root/reference/README.md:262-279); this driver makes it one command:
run warpsense (HATSDF point-to-TSDF) or featsense (F-LOAM + VGICP) over a
dataset with ground truth and report ATE RMSE, per-stage timings, and
scans/s.

    python -m warpsense.eval.slam_eval --pipeline warpsense --frames 20
    python -m warpsense.eval.slam_eval --pipeline featsense --frames 20
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from ..core.config import Params
from ..io.dataset import SyntheticDataset
from ..io.trajectory import ate_rmse, write_tum


def default_params(channels: int, columns: int) -> Params:
    return Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 64, "max_weight": 10,
                "size": {"x": 25, "y": 25, "z": 10}, "shift": 8.0,
                "update_distance": 0.1},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "registration": {"max_iterations": 200, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": channels, "hresolution": columns},
    })


def run_warpsense(dataset, params: Params, map_path: Path, *,
                  capacity: int = 32768, sharded: bool = False) -> dict:
    if sharded:
        # the multi-chip pipeline app over ALL devices of this process
        # (virtual CPU meshes work too: JAX_PLATFORMS=cpu +
        # jax_num_cpu_devices; multi-process runs suffix per-host files,
        # see pipeline/warpsense_sharded.py)
        from ..pipeline.warpsense_sharded import ShardedWarpsenseApp
        app = ShardedWarpsenseApp(params, map_path=map_path,
                                  capacity=capacity)
    else:
        from ..pipeline.warpsense import WarpsenseApp
        app = WarpsenseApp(params, map_path=map_path, capacity=capacity)
    truth, est, times = [], [], []
    for frame in dataset:
        t0 = time.perf_counter()
        pose_mm = app.cloud_callback(frame.cloud, frame.stamp)
        times.append(time.perf_counter() - t0)
        pose_m = pose_mm.astype(np.float64).copy()
        pose_m[:3, 3] /= 1000.0
        est.append(pose_m)
        truth.append(frame.ground_truth)
    app.terminate()
    return _report(np.stack(est), truth, times)


def run_featsense(dataset, params: Params, map_path: Path, *,
                  edge_capacity: int = 2048, surf_capacity: int = 4096,
                  cloud_capacity: int = 32768) -> dict:
    from ..pipeline.featsense import FeatsenseApp

    app = FeatsenseApp(params, map_path=map_path,
                       edge_capacity=edge_capacity,
                       surf_capacity=surf_capacity,
                       cloud_capacity=cloud_capacity)
    truth, est, times = [], [], []
    for frame in dataset:
        t0 = time.perf_counter()
        pose = app.process_scan(frame.cloud, frame.stamp)
        times.append(time.perf_counter() - t0)
        est.append(pose)
        truth.append(frame.ground_truth)
    app.terminate()
    return _report(np.stack(est), truth, times)


def _report(est: np.ndarray, truth, times: list[float]) -> dict:
    steady = times[2:] if len(times) > 4 else times  # skip compile frames
    out = {
        "frames": len(times),
        "scan_ms_avg": round(float(np.mean(steady)) * 1000, 2),
        "scans_per_s": round(1.0 / float(np.mean(steady)), 2),
    }
    if truth is not None:
        # ATE over the frames that HAVE ground truth (timestamp-matched
        # GT legitimately skips frames outside the tolerance)
        have = [i for i, t in enumerate(truth) if t is not None]
        if len(have) >= 3:
            truth_a = np.stack([truth[i] for i in have])
            est_a = est[have]
            out["ate_rmse_m"] = round(ate_rmse(est_a, truth_a, align=True), 4)
            out["ate_rmse_raw_m"] = round(
                ate_rmse(est_a, truth_a, align=False), 4)
            out["ate_frames"] = len(have)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--pipeline",
                    choices=["warpsense", "warpsense-sharded", "featsense"],
                    default="warpsense")
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--channels", type=int, default=128)
    ap.add_argument("--columns", type=int, default=1024)
    ap.add_argument("--radius", type=float, default=2.0)
    ap.add_argument("--map-out", default=None)
    ap.add_argument("--tum-out", default=None)
    ap.add_argument("--bag", default=None,
                    help="drive from a rosbag1 file instead of synthetic")
    ap.add_argument("--cloud-topic", default="/os_cloud_node/points")
    ap.add_argument("--imu-topic", default=None)
    ap.add_argument("--tum-gt", default=None,
                    help="TUM ground-truth file for ATE against the bag")
    ap.add_argument("--gt-tolerance", type=float, default=0.05,
                    help="max |scan stamp - GT stamp| (s) to associate")
    args = ap.parse_args(argv)

    if args.bag:
        from ..io.rosbag import RosbagDataset
        from ..io.trajectory import read_tum
        ds = RosbagDataset(args.bag, args.cloud_topic, args.imu_topic,
                           channels=args.channels, columns=args.columns)
        frames = list(ds)
        if args.tum_gt:
            # associate by NEAREST TIMESTAMP, not list index: GT files are
            # routinely sampled at a different rate than the cloud topic
            # and bags drop scans — index pairing silently misaligns every
            # subsequent pose and corrupts the reported ATE
            stamps, gt = read_tum(args.tum_gt)
            for fr in frames:
                j = int(np.argmin(np.abs(stamps - fr.stamp)))
                if abs(float(stamps[j]) - fr.stamp) <= args.gt_tolerance:
                    fr.ground_truth = gt[j]
        dataset = frames
    else:
        dataset = SyntheticDataset(args.frames, channels=args.channels,
                                   columns=args.columns)
    params = default_params(args.channels, args.columns)
    map_path = Path(args.map_out) if args.map_out else (
        Path(tempfile.mkdtemp()) / "slam_eval")
    if args.pipeline == "featsense":
        stats = run_featsense(dataset, params, map_path)
    else:
        stats = run_warpsense(dataset, params, map_path,
                              sharded=args.pipeline == "warpsense-sharded")
    stats["pipeline"] = args.pipeline
    print(json.dumps(stats))


if __name__ == "__main__":
    from ..utils.compile_cache import enable_compile_cache
    enable_compile_cache()
    main()
