"""Eval harness smoke tests (small synthetic workloads)."""
import json

import numpy as np
import pytest

from warpsense.eval import pcd2tsdf, pcd_registration


def _small_cloud(res=256, half=3000, n_per_wall=300, seed=0):
    rng = np.random.default_rng(seed)
    pts = []
    for ax in range(3):
        for s in (-1, 1):
            p = rng.uniform(-half, half, (n_per_wall, 3))
            p[:, ax] = s * half
            pts.append(p)
    mm = np.concatenate(pts).astype(np.int64)
    vox = mm // res
    _, keep = np.unique(vox, axis=0, return_index=True)
    return vox[np.sort(keep)] * res + res // 2


def test_pcd2tsdf_device_matches_host_twin():
    cloud = _small_cloud()
    stats = pcd2tsdf.run(cloud, tau=900, resolution=256, size=(31, 31, 31),
                         host_compare_points=128)
    assert stats["touched_voxels_device"] > 100
    assert stats["exact_agreement"] == 1.0, stats


def test_pcd_registration_recovers_perturbations():
    cloud = _small_cloud()
    results = pcd_registration.run(cloud, tau=900, resolution=256,
                                   size=(31, 31, 31), max_iterations=60,
                                   epsilon=0.0, mode="fast")
    assert set(results) == {"idle", "translation", "rotation",
                            "rotation_inv", "translation+rotation"}
    # idle must stay put; every perturbation must be mostly recovered
    assert results["idle"]["avg"] < 20.0, results["idle"]
    for name in ("translation", "rotation", "rotation_inv",
                 "translation+rotation"):
        assert results[name]["avg"] < 120.0, (name, results[name])


def test_slam_eval_cli_smoke(tmp_path, capsys):
    from warpsense.eval import slam_eval

    slam_eval.main(["--pipeline", "warpsense", "--frames", "4",
                    "--channels", "16", "--columns", "256",
                    "--map-out", str(tmp_path / "m")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["frames"] == 4
    assert np.isfinite(out["ate_rmse_m"])

    # the mesh app through the same CLI (8-device virtual mesh)
    slam_eval.main(["--pipeline", "warpsense-sharded", "--frames", "4",
                    "--channels", "16", "--columns", "256",
                    "--map-out", str(tmp_path / "ms")])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["pipeline"] == "warpsense-sharded"
    assert np.isfinite(out["ate_rmse_m"])


def test_feature_compare_includes_floam_twin():
    """feature_compare reports the independent original-F-LOAM selection
    (frontends/featsense/floam_original.py, reproducing test/floam.h) —
    a second, non-self-referential implementation next to the host twin."""
    from warpsense.eval.feature_compare import run
    from warpsense.io.synthetic import BoxWorld, render_scan

    cloud = render_scan(BoxWorld.default(), np.eye(4), channels=32,
                        columns=256, max_range=22.0, noise_std=0.005,
                        rng=np.random.default_rng(0))
    out = run(cloud)
    assert out["edges"]["jaccard"] == 1.0       # device == host twin
    assert out["surfs"]["jaccard"] == 1.0
    assert out["edges"]["floam"] > 0 and out["surfs"]["floam"] > 0
    assert 0.0 <= out["edges"]["floam_precision"] <= 1.0


def test_floam_original_rules():
    """Edges exceed the 0.1 curvature gate; <=20 edges per sector; every
    unpicked sector point lands in surf (floam.h:30-148 semantics)."""
    from warpsense.frontends.featsense.floam_original import \
        floam_original_features

    rng = np.random.default_rng(5)
    # one synthetic "scan line": points on a smooth arc with sharp spikes
    n = 400
    az = np.linspace(-1.0, 1.0, n)
    pts = np.stack([10 * np.cos(az), 10 * np.sin(az),
                    np.zeros(n)], axis=1)
    pts[::37] *= 1.4                     # corner-like spikes
    pts += rng.normal(0, 0.002, pts.shape)
    e, s = floam_original_features(pts, n_scans=128, min_distance=2.0,
                                   max_distance=60.0)
    assert len(e) > 0 and len(s) > 0
    assert set(e).isdisjoint(set(s))
    assert max(list(e) + list(s)) < n
    # determinism
    e2, s2 = floam_original_features(pts, n_scans=128, min_distance=2.0,
                                     max_distance=60.0)
    np.testing.assert_array_equal(e, e2)
    np.testing.assert_array_equal(s, s2)
