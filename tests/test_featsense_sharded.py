"""Sharded featsense TSDF back end (round-5 / VERDICT r4 #7).

The reference shares ONE GPU TSDF back end between warpsense and
featsense (src/featsense/mapping.cpp:82-137 -> tsdf_mapping.cpp); here
the mesh twin of that shared seam is ``FeatsenseMapping(mesh=...)`` — the
O(voxels) fusion shards over the device mesh while the front end
(features, odometry, VGICP) stays replicated.  The e2e pin: the same
scans through the single-chip app (level-grid projective fusion) and the
mesh-backed app produce THE SAME trajectory (the sharded level sweep is
bit-identical per shard), and the mesh back end shifts + persists.
"""
import numpy as np
import pytest

from warpsense.core.config import Params
from warpsense.io.synthetic import BoxWorld, render_scan, walk_trajectory
from warpsense.parallel.sharded import make_mesh
from warpsense.pipeline.featsense import FeatsenseApp

WINDOW = (160, 101, 41)      # x divisible by the 8-device mesh
CH, COLS = 32, 512


def make_params(shift=8.0):
    return Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 20, "y": 12, "z": 5}, "shift": shift,
                "update_distance": 0.05},
        "floam": {"min_distance": 0.5, "max_distance": 40.0,
                  "edge_threshold": 0.5, "surf_threshold": 0.05,
                  "edge_resolution": 0.15, "optimization_steps": 3,
                  "enrich": 4, "vgicp_fitness_score": 6.0},
        "lidar": {"channels": CH, "hresolution": COLS},
    })


def make_app(tmp_path, name, **kw):
    return FeatsenseApp(
        make_params(**{k: v for k, v in kw.items() if k == "shift"}),
        map_path=tmp_path / name, edge_capacity=1024, surf_capacity=2048,
        cloud_capacity=8192, window_size=WINDOW,
        odom_kwargs=dict(edge_map_capacity=4096, surf_map_capacity=8192),
        **{k: v for k, v in kw.items() if k != "shift"})


@pytest.fixture(scope="module")
def walk_scans():
    poses = walk_trajectory(6, step_m=0.1)
    world = BoxWorld.default()
    rng = np.random.default_rng(0)
    return [render_scan(world, p, channels=CH, columns=COLS,
                        noise_std=0.002, rng=rng) for p in poses], poses


def test_featsense_sharded_backend_matches_single_chip(tmp_path, walk_scans):
    scans, truth = walk_scans
    one = make_app(tmp_path, "one", fusion="projective-level")
    many = make_app(tmp_path, "many", mesh=make_mesh(8))
    for i, scan in enumerate(scans):
        p1 = one.process_scan(scan, float(i))
        pN = many.process_scan(scan, float(i))
    # F-LOAM odometry is replicated (identical by construction); the
    # refined VGICP/TSDF trajectory is the one the sharded back end feeds
    g1 = np.stack(one.mapping.gicp_path)
    gN = np.stack(many.mapping.gicp_path)
    one.terminate()
    many.terminate()
    assert len(g1) == len(gN) >= 4
    np.testing.assert_allclose(gN[:, :3, 3], g1[:, :3, 3], atol=5e-3)
    np.testing.assert_allclose(gN[:, :3, :3], g1[:, :3, :3], atol=1e-3)
    # ground truth relative to the first frame (the odometry world frame
    # is the first sensor pose); gicp_path starts at scan 1 (scan 0 is
    # the bootstrap fuse)
    rel = np.linalg.inv(truth[0]) @ truth[len(gN)]
    err = np.linalg.norm(gN[-1][:3, 3] - rel[:3, 3])
    assert err < 0.15, f"mesh featsense drifted {err:.3f} m"


def test_featsense_sharded_shift_and_persist(tmp_path, walk_scans):
    from warpsense.map.global_map import GlobalMap
    scans, _ = walk_scans
    app = make_app(tmp_path, "shift", mesh=make_mesh(8), shift=0.15)
    for i, scan in enumerate(scans):
        app.process_scan(scan, float(i))
    moved = np.any(np.asarray(app.mapping.state.pos) != 0)
    app.terminate()
    assert moved, "sharded featsense window never shifted"
    gm = GlobalMap(tmp_path / "shift", 0, truncate=False)
    assert len(gm.chunk_tags()) > 0 and len(gm.read_poses()) > 0
