"""Checkpoint/resume: persisted map + poses survive a restart."""
import numpy as np

from warpsense.core.config import Params
from warpsense.io.synthetic import BoxWorld, render_scan, walk_trajectory
from warpsense.pipeline.warpsense import WarpsenseApp


def make_params():
    return Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 20, "y": 20, "z": 6}, "shift": 8.0,
                "update_distance": 0.08},
        "registration": {"max_iterations": 60, "epsilon": 0.0,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": 32, "hresolution": 512},
    })


def test_warpsense_resume_continues_trajectory(tmp_path):
    world = BoxWorld.default()
    poses = walk_trajectory(8, step_m=0.1)
    rng = np.random.default_rng(0)
    scans = [render_scan(world, p, channels=32, columns=512,
                         noise_std=0.002, rng=rng) for p in poses]
    path = tmp_path / "resume"

    app = WarpsenseApp(make_params(), map_path=path, capacity=8192)
    for scan, stamp in zip(scans[:4], range(4)):
        last_pose = app.cloud_callback(scan, float(stamp))
    fused_before = int((np.asarray(app.state.weight) != 0).sum())
    app.terminate()

    # restart from the persisted file
    app2 = WarpsenseApp(make_params(), map_path=path, capacity=8192,
                        resume=True)
    assert app2.initialized
    # pose restored (poses are stored rounded to mm)
    np.testing.assert_allclose(app2.pose[:3, 3], last_pose[:3, 3], atol=2.0)
    # the reloaded window carries the fused map
    fused_after = int((np.asarray(app2.state.weight) != 0).sum())
    assert fused_after > 0.9 * fused_before

    # continue the trajectory; error must not grow beyond the drift the
    # first session already accumulated (resume adds no discontinuity)
    err_before = np.linalg.norm(last_pose[:3, 3] / 1000.0 - poses[3][:3, 3])
    errs = []
    for i, (scan, gt) in enumerate(zip(scans[4:], poses[4:])):
        pose = app2.cloud_callback(scan, float(4 + i))
        errs.append(np.linalg.norm(pose[:3, 3] / 1000.0 - gt[:3, 3]))
    app2.terminate()
    assert errs[-1] < err_before + 0.1, \
        f"pre-resume drift {err_before:.3f}, post-resume errors {errs}"


def make_featsense_params():
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


def test_featsense_resume_continues_trajectory(tmp_path):
    """Featsense resume parity (VERDICT r3 #8): the persisted pose becomes
    a world-frame offset over the restarted F-LOAM odometry, and the
    reloaded window carries the fused map."""
    from warpsense.pipeline.featsense import FeatsenseApp

    world = BoxWorld.default()
    poses = walk_trajectory(8, step_m=0.1)
    rng = np.random.default_rng(1)
    scans = [render_scan(world, p, channels=32, columns=512,
                         noise_std=0.002, rng=rng) for p in poses]
    path = tmp_path / "fs_resume"
    kw = dict(edge_capacity=512, surf_capacity=1024, cloud_capacity=4096,
              odom_kwargs=dict(edge_map_capacity=2048,
                               surf_map_capacity=4096))

    app = FeatsenseApp(make_featsense_params(), map_path=path, **kw)
    for scan, stamp in zip(scans[:4], range(4)):
        app.process_scan(scan, float(stamp))
    last_world = app.mapping.last_gicp_pose.copy()
    fused_before = int((np.asarray(app.mapping.state.weight) != 0).sum())
    app.terminate()

    app2 = FeatsenseApp(make_featsense_params(), map_path=path,
                        resume=True, **kw)
    # the persisted pose was restored as the world-frame offset (poses are
    # persisted in meters, rounded to mm)
    np.testing.assert_allclose(app2.mapping.pose_offset[:3, 3],
                               last_world[:3, 3], atol=2e-3)
    fused_after = int((np.asarray(app2.mapping.state.weight) != 0).sum())
    assert fused_after > 0.9 * fused_before
    # the shift gate compares mm poses: the resume seed must be mm too
    # (code-review r4: a meters-frame seed makes the gate measure
    # distance-from-origin, spuriously shifting or never shifting)
    np.testing.assert_allclose(app2.mapping.last_shift_pose[:3, 3],
                               last_world[:3, 3] * 1000.0, atol=2.0)

    # continue: refined world poses must track the true trajectory without
    # a resume discontinuity (the odometry restarts at identity; the
    # offset maps its relative motion onto the persisted path)
    err_before = np.linalg.norm(last_world[:3, 3] - poses[3][:3, 3])
    errs = []
    for i, (scan, gt) in enumerate(zip(scans[4:], poses[4:])):
        app2.process_scan(scan, float(4 + i))
        world = app2.mapping.last_gicp_pose
        errs.append(np.linalg.norm(world[:3, 3] - gt[:3, 3]))
    app2.terminate()
    assert errs[-1] < err_before + 0.15, \
        f"pre-resume drift {err_before:.3f}, post-resume errors {errs}"
