"""Motion-envelope stress: fast rotation + large steps in the cluttered
world.  The reference README documents warpsense as "unstable in large
environments / fast motion" (README.md:301); this pins the fast mode's
behavior at 6 deg / 0.21 m per scan — double the standard fixture's
rate — with IMU assist, where the interpolated-residual + adaptive-LM
generation must still track."""
import numpy as np
import pytest

from warpsense.core.config import Params
from warpsense.io.synthetic import (BoxWorld, circular_trajectory,
                                    imu_stream_for, render_scan)
from warpsense.pipeline.warpsense import WarpsenseApp
from warpsense.utils.imu import ImuSample

N_SCANS = 60
SCAN_DT = 0.05


def _ate(gt, est_mm):
    est_m = est_mm.copy()
    est_m[:, :3, 3] /= 1000.0
    world_est = np.einsum("ij,njk->nik", gt[0], est_m)
    err = world_est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))


@pytest.mark.parametrize("coarse", [0, 5])
def test_fast_motion_envelope(tmp_path, coarse):
    """Full circle in 60 scans (6 deg/scan, 0.21 m/scan): ATE stays below
    2x the voxel size; coarse-to-fine LM matches full-resolution LM."""
    params = Params.from_dict({
        "lidar": {"channels": 32, "hresolution": 256},
        "map": {"max_distance": 0.96, "update_distance": 0.3,
                "resolution": 128, "size": {"x": 14.0, "y": 14.0, "z": 6.0},
                "shift": 3.0, "max_weight": 10},
        "registration": {"max_iterations": 50, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast",
                         "coarse_iterations": coarse},
    })
    world = BoxWorld.default()
    gt = circular_trajectory(N_SCANS, radius=2.0, z=0.3)
    rng = np.random.default_rng(3)

    app = WarpsenseApp(params, map_path=tmp_path / f"s{coarse}",
                       capacity=8192, max_range_mm=22000)
    imu = imu_stream_for(gt, SCAN_DT)
    est = []
    for i in range(N_SCANS):
        stamp = i * SCAN_DT
        for s in imu:
            if (i - 1) * SCAN_DT < s.stamp <= stamp:
                app.imu_callback(ImuSample(s.stamp, s.angular_velocity))
        scan = render_scan(world, gt[i], channels=32, columns=256,
                           max_range=22.0, noise_std=0.01, rng=rng)
        est.append(app.cloud_callback(scan, stamp).copy())
    app.terminate()
    rmse = _ate(gt, np.stack(est))
    assert rmse < 0.26, f"ATE RMSE {rmse:.3f} m at 6 deg/scan"


def test_featsense_projective_backend(tmp_path):
    """Featsense's shared TSDF back end runs on the production projective
    path (fusion='projective'/'auto'), not only the parity ray-march."""
    from warpsense.eval.slam_eval import default_params
    from warpsense.io.dataset import SyntheticDataset

    params = default_params(32, 256)
    ds = list(SyntheticDataset(6, channels=32, columns=256))
    from warpsense.pipeline.featsense import FeatsenseApp
    app = FeatsenseApp(params, map_path=tmp_path / "fp",
                       edge_capacity=1024, surf_capacity=2048,
                       cloud_capacity=8192, fusion="projective")
    poses = [app.process_scan(fr.cloud, fr.stamp) for fr in ds]
    app.terminate()
    est = np.stack(poses)
    gt = np.stack([fr.ground_truth for fr in ds])
    err = np.linalg.norm(
        np.einsum("ij,njk->nik", gt[0], est)[:, :3, 3] - gt[:, :3, 3],
        axis=1)
    assert float(np.sqrt(np.mean(err ** 2))) < 0.5
    from warpsense.map.global_map import GlobalMap
    assert len(GlobalMap(tmp_path / "fp", 0, truncate=False).chunk_tags()) > 0
