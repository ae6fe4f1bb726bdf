"""End-to-end warpsense loop on a synthetic trajectory (ATE check).

Plays the role of the reference's rosbag+evo evaluation (README.md:262-279)
on a fully synthetic box-room world: render organized scans along a known
trajectory, run the SLAM loop, compare the estimated path to ground truth.
"""
import numpy as np
import pytest

from warpsense.core.config import Params
from warpsense.io.synthetic import (BoxWorld, circular_trajectory,
                                    imu_stream_for, render_scan)
from warpsense.pipeline.warpsense import WarpsenseApp
from warpsense.utils.imu import ImuSample

N_SCANS = 60          # half circle at ~62 mm / 3 deg per scan —
SCAN_DT = 0.05        # inside the warpsense operating envelope (20 Hz-ish)


@pytest.fixture(scope="module")
def slam_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slam")
    params = Params.from_dict({
        "lidar": {"channels": 32, "hresolution": 256},
        "map": {"max_distance": 0.96, "update_distance": 0.3,
                "resolution": 128, "size": {"x": 12.0, "y": 12.0, "z": 6.0},
                "shift": 3.0, "max_weight": 10},
        "registration": {"max_iterations": 200, "epsilon": 0.03,
                         "it_weight_gradient": 0.1},
    })
    world = BoxWorld.default()
    gt = circular_trajectory(2 * N_SCANS, radius=1.2, z=0.3)[:N_SCANS]
    rng = np.random.default_rng(0)

    app = WarpsenseApp(params, map_path=tmp / "slam", capacity=8192,
                       max_range_mm=22000)
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
    return gt, np.stack(est), tmp / "slam"


@pytest.fixture(scope="module")
def slam_run_fast(tmp_path_factory):
    """Same trajectory under the production fast mode: packed fields +
    gradient-interpolated residuals (sub-voxel accuracy)."""
    tmp = tmp_path_factory.mktemp("slam_fast")
    params = Params.from_dict({
        "lidar": {"channels": 32, "hresolution": 256},
        "map": {"max_distance": 0.96, "update_distance": 0.3,
                "resolution": 128, "size": {"x": 12.0, "y": 12.0, "z": 6.0},
                "shift": 3.0, "max_weight": 10},
        "registration": {"max_iterations": 50, "epsilon": 0.03,
                         "it_weight_gradient": 0.1, "mode": "fast"},
    })
    world = BoxWorld.default()
    gt = circular_trajectory(2 * N_SCANS, radius=1.2, z=0.3)[:N_SCANS]
    rng = np.random.default_rng(0)

    app = WarpsenseApp(params, map_path=tmp / "slam", capacity=8192,
                       max_range_mm=22000)
    imu = imu_stream_for(gt, SCAN_DT)
    est, iters = [], []
    for i in range(N_SCANS):
        stamp = i * SCAN_DT
        for s in imu:
            if (i - 1) * SCAN_DT < s.stamp <= stamp:
                app.imu_callback(ImuSample(s.stamp, s.angular_velocity))
        scan = render_scan(world, gt[i], channels=32, columns=256,
                           max_range=22.0, noise_std=0.01, rng=rng)
        est.append(app.cloud_callback(scan, stamp).copy())
        iters.append(app.last_reg_iters)
    app.terminate()
    return gt, np.stack(est), np.asarray(iters)


def ate_rmse(gt, est_mm):
    """Align est (map frame = first sensor frame) into world via gt[0]."""
    est_m = est_mm.copy()
    est_m[:, :3, 3] /= 1000.0
    world_est = np.einsum("ij,njk->nik", gt[0], est_m)
    err = world_est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))


def test_trajectory_ate(slam_run):
    gt, est, _ = slam_run
    rmse = ate_rmse(gt, est)
    # the nearest-cell residual quantization (128 mm voxels) plus the
    # ~0.1 deg/scan field-chirality noise floor put the achievable ATE
    # around 0.2 m on this trajectory; trilinear residuals (planned) push
    # it below the voxel size
    assert rmse < 0.4, f"ATE RMSE {rmse:.3f} m"


def test_trajectory_ate_fast_subvoxel(slam_run_fast):
    """Interpolated residuals push ATE below the voxel size (VERDICT r1 #4:
    <= 0.12 m at 128 mm voxels) while converging in few GN iterations."""
    gt, est, iters = slam_run_fast
    rmse = ate_rmse(gt, est)
    assert rmse < 0.12, f"ATE RMSE {rmse:.3f} m"
    assert float(np.mean(iters)) < 45, f"mean GN iters {np.mean(iters):.1f}"


def test_poses_persisted(slam_run):
    _, est, path = slam_run
    from warpsense.map.global_map import GlobalMap
    gm = GlobalMap(path, 0, truncate=False)
    poses = gm.read_poses()
    gm.close()
    assert len(poses) == N_SCANS
    np.testing.assert_allclose(poses[-1][:3], est[-1][:3, 3] / 1000.0,
                               atol=2e-3)


def test_map_persisted_nonempty(slam_run):
    _, _, path = slam_run
    from warpsense.map.global_map import GlobalMap
    gm = GlobalMap(path, 0, truncate=False)
    chunks = gm.chunk_tags()
    assert len(chunks) > 4
    total = sum(int(np.count_nonzero(gm.read_chunk(c) >> 16))
                for c in chunks)
    assert total > 10000  # plenty of weighted voxels persisted


def test_sane_step_gate_and_velocity_prior_health(tmp_path):
    """Control-law regression (round 5): an implausible registration step
    is replaced by the IMU-only prior, and the velocity seed is disabled
    until a registration makes a real accepted step again — the corridor
    scene's ballistic-runaway guard (config.sane_step_m /
    velocity_prior)."""
    import jax.numpy as jnp
    from warpsense.core.config import Params
    from warpsense.io.synthetic import BoxWorld, render_scan, \
        walk_trajectory
    from warpsense.pipeline.warpsense import WarpsenseApp

    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 6, "y": 5, "z": 4}, "shift": 8.0,
                "update_distance": 0.05},
        "registration": {"max_iterations": 20, "epsilon": 0.0,
                         "it_weight_gradient": 0.1, "mode": "fast",
                         "sane_step_m": 0.5},
        "lidar": {"channels": 16, "hresolution": 128},
    })
    app = WarpsenseApp(params, map_path=tmp_path / "gate",
                       capacity=2048, sync_shift=True)
    world = BoxWorld.default()
    rng = np.random.default_rng(0)
    scans = [render_scan(world, p, channels=16, columns=128,
                         noise_std=0.002, rng=rng)
             for p in walk_trajectory(4, step_m=0.05)]
    app.cloud_callback(scans[0], 0.0)
    app.cloud_callback(scans[1], 0.1)
    assert app._reg_healthy          # normal tracking: prior enabled

    # force an implausible solve: registration "teleports" 5 m
    crazy = np.eye(4, dtype=np.float32)
    crazy[:3, 3] = [5000.0, 0.0, 0.0]
    orig = app._register
    app._register = lambda pts, mask, pre: crazy
    pose_before = app.pose.copy()
    app.cloud_callback(scans[2], 0.2)
    app._register = orig
    # gate fired: pose moved by at most the IMU-only prior (~0), and the
    # velocity seed is disabled for the next scan
    assert np.linalg.norm(app.pose[:3, 3] - pose_before[:3, 3]) < 500.0
    assert not app._reg_healthy

    # a healthy registration re-enables the prior
    app.cloud_callback(scans[3], 0.3)
    assert app._reg_healthy
