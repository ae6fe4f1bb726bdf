"""End-to-end featsense pipeline on synthetic OS1 scans."""
import numpy as np
import pytest

from warpsense.core.config import Params
from warpsense.io.synthetic import BoxWorld, render_scan
from warpsense.pipeline.featsense import FeatsenseApp, ThreadedFeatsenseRunner


def make_params():
    return Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 24, "y": 20, "z": 8}, "shift": 8.0,
                "update_distance": 0.08},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "lidar": {"channels": 32, "hresolution": 512},
    })


def straight_trajectory(n, step=0.12):
    poses = np.zeros((n, 4, 4))
    for i in range(n):
        yaw = 0.02 * i
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i] = np.eye(4)
        poses[i][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
        poses[i][:3, 3] = [step * i, 0.04 * i, 0.0]
    return poses


def render_all(poses, channels=32, columns=512, seed=0):
    world = BoxWorld.default()
    rng = np.random.default_rng(seed)
    return [render_scan(world, p, channels=channels, columns=columns,
                        noise_std=0.003, rng=rng) for p in poses]


@pytest.fixture(scope="module")
def scans_and_truth():
    poses = straight_trajectory(6)
    return render_all(poses), poses


def test_featsense_app_tracks_trajectory(tmp_path, scans_and_truth):
    scans, truth = scans_and_truth
    app = FeatsenseApp(make_params(), map_path=tmp_path / "fs",
                       edge_capacity=512, surf_capacity=1024,
                       cloud_capacity=4096,
                       odom_kwargs=dict(edge_map_capacity=2048,
                                        surf_map_capacity=4096))
    errs = []
    for scan, gt in zip(scans, truth):
        pose = app.process_scan(scan)
        errs.append(np.linalg.norm(pose[:3, 3] - gt[:3, 3]))
    app.terminate()
    assert errs[-1] < 0.12, f"featsense trajectory errors {errs}"
    # TSDF map got fused and persisted
    from warpsense.map.global_map import GlobalMap
    gm = GlobalMap(tmp_path / "fs", 0, truncate=False)
    assert len(gm.chunk_tags()) > 0
    assert len(gm.read_poses()) > 0


def test_mapping_gates_on_update_distance(tmp_path, scans_and_truth):
    scans, truth = scans_and_truth
    app = FeatsenseApp(make_params(), map_path=tmp_path / "gate",
                       edge_capacity=512, surf_capacity=1024,
                       cloud_capacity=4096,
                       odom_kwargs=dict(edge_map_capacity=2048,
                                        surf_map_capacity=4096))
    # same scan twice: zero motion -> second mapping call must be gated
    app.process_scan(scans[0])
    assert app.mapping.initialized
    res = app.mapping.process(
        np.ascontiguousarray(scans[0].reshape(-1, 3)),
        np.any(scans[0].reshape(-1, 3) != 0, axis=1),
        np.eye(4))
    assert res is None
    app.terminate()


def test_threaded_runner_matches_sequential(tmp_path, scans_and_truth):
    scans, truth = scans_and_truth
    seq = FeatsenseApp(make_params(), map_path=tmp_path / "seq",
                       edge_capacity=512, surf_capacity=1024,
                       cloud_capacity=4096,
                       odom_kwargs=dict(edge_map_capacity=2048,
                                        surf_map_capacity=4096))
    for scan in scans[:4]:
        seq.process_scan(scan)

    thr_app = FeatsenseApp(make_params(), map_path=tmp_path / "thr",
                           edge_capacity=512, surf_capacity=1024,
                           cloud_capacity=4096,
                           odom_kwargs=dict(edge_map_capacity=2048,
                                            surf_map_capacity=4096))
    runner = ThreadedFeatsenseRunner(thr_app)
    runner.start()
    for i, scan in enumerate(scans[:4]):
        runner.submit(scan, float(i))
    runner.drain()
    seq.terminate()
    thr_app.terminate()

    a = seq.trajectory()
    b = thr_app.trajectory()
    assert len(a) == len(b) == 4
    np.testing.assert_allclose(a, b, atol=1e-5)
    # the visualization stage drained every refined pose into the path
    assert len(runner.path) == 4
    assert all(p.shape == (4, 4) for _, p in runner.path)
