"""Fastsense pipeline: async copy-on-write mapping + orientation-diff IMU.

Mirrors the reference's warpsense_cpu node behavior (src/cpu/fastsense.cpp):
registration every scan against the published map snapshot while TSDF
update / shift / viz run in a side thread, gated every N scans or D meters.
"""
import numpy as np
import pytest

from warpsense.core.config import Params
from warpsense.io.synthetic import (BoxWorld, circular_trajectory,
                                    render_scan)
from warpsense.io.trajectory import _quat_from_mat
from warpsense.pipeline.fastsense import FastsenseApp
from warpsense.utils.imu import (ImuOrientationDiff, ImuSample,
                                 _quat_to_mat_np)
from warpsense.utils.ring_buffer import ConcurrentRingBuffer

N_SCANS = 40
SCAN_DT = 0.05


def test_orientation_diff_pretransform():
    """R(q_now) @ R(q_prev)^T semantics, first sample seeds only
    (fastsense.cpp:181-212)."""
    buf = ConcurrentRingBuffer(16)
    diff = ImuOrientationDiff(buf)

    def quat_z(theta):
        return np.array([0.0, 0.0, np.sin(theta / 2), np.cos(theta / 2)])

    buf.push_nb(ImuSample(0.01, np.zeros(3), quat_z(0.1)))
    first = diff.pretransform(0.05)
    np.testing.assert_allclose(first, np.eye(4), atol=1e-12)

    # two samples <= stamp: only the LAST counts; delta = 0.3 - 0.1 rad
    buf.push_nb(ImuSample(0.06, np.zeros(3), quat_z(0.2)))
    buf.push_nb(ImuSample(0.09, np.zeros(3), quat_z(0.3)))
    buf.push_nb(ImuSample(0.50, np.zeros(3), quat_z(9.9)))  # future: stays
    second = diff.pretransform(0.10)
    np.testing.assert_allclose(second[:3, :3], _quat_to_mat_np(quat_z(0.2)),
                               atol=1e-12)
    assert len(buf) == 1  # the future sample was not consumed


@pytest.fixture(scope="module")
def fastsense_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fastsense")
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

    # small gate so the async shift-update path actually exercises
    app = FastsenseApp(params, map_path=tmp / "fast", capacity=8192,
                       update_frequency=5, update_distance_m=0.25)
    R0 = gt[0][:3, :3]
    est = []
    for i in range(N_SCANS):
        stamp = i * SCAN_DT
        q = _quat_from_mat(R0.T @ gt[i][:3, :3])   # map-frame orientation
        app.imu_callback(ImuSample(stamp - 1e-3, np.zeros(3), q))
        scan = render_scan(world, gt[i], channels=32, columns=256,
                           max_range=22.0, noise_std=0.01, rng=rng)
        est.append(app.cloud_callback(scan, stamp).copy())
        app.sync(timeout=30.0)   # deterministic replay: wait out the worker
    updates_enqueued = app.scan_count
    app.terminate()
    return gt, np.stack(est), tmp / "fast", updates_enqueued


def ate_rmse(gt, est_mm):
    est_m = est_mm.copy()
    est_m[:, :3, 3] /= 1000.0
    world_est = np.einsum("ij,njk->nik", gt[0], est_m)
    err = world_est[:, :3, 3] - gt[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))


def test_fastsense_trajectory_ate(fastsense_run):
    gt, est, _, _ = fastsense_run
    rmse = ate_rmse(gt, est)
    # fastsense fuses every 5 scans regardless of motion (vs warpsense's
    # update_distance gate), so more pose drift enters the map on this
    # 128 mm-voxel synthetic scene — hence the slightly looser bound
    assert rmse < 0.5, f"ATE RMSE {rmse:.3f} m"


def test_fastsense_map_persisted(fastsense_run):
    """Terminate joins the worker and flushes map + poses (fastsense.cpp:58-86)."""
    _, est, path, _ = fastsense_run
    from warpsense.map.global_map import GlobalMap
    gm = GlobalMap(path, 0, truncate=False)
    poses = gm.read_poses()
    assert len(poses) == N_SCANS
    np.testing.assert_allclose(poses[-1][:3], est[-1][:3, 3] / 1000.0,
                               atol=2e-3)
    assert len(gm.chunk_tags()) > 0
