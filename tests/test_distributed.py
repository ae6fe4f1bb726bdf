"""Multi-host entry helpers: single-process degenerate form on the
8-device virtual CPU mesh, PLUS a real 2-process ``jax.distributed`` run
(coordinator on localhost, Gloo CPU collectives) pinning the multi-host
code path itself — shard_state_global/host_slab_bounds/gather_state with
``process_count() == 2`` (VERDICT r3 #5; new capability, the reference is
single-node, SURVEY §5.8)."""
import json
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np

from warpsense.map.local_map import LocalMapState
from warpsense.parallel.distributed import (gather_state, global_mesh,
                                            host_slab_bounds,
                                            init_distributed,
                                            shard_state_global)
from warpsense.parallel.sharded import tsdf_update_projective_sharded
from warpsense.core.consts import WEIGHT_RESOLUTION

SIZE = (80, 41, 41)


def _state():
    return LocalMapState(
        value=np.full(SIZE, 600, np.int16),
        weight=np.zeros(SIZE, np.int16),
        pos=np.zeros(3, np.int32),
        offset=np.asarray([s // 2 for s in SIZE], np.int32))


def test_init_distributed_noop_single_process():
    init_distributed()          # no coordinator, 1 process -> no-op
    assert jax.process_count() == 1


def test_global_mesh_and_sharding_roundtrip():
    mesh = global_mesh()
    assert mesh.devices.size == len(jax.devices())
    st = shard_state_global(_state(), mesh)
    assert st.value.sharding.spec == ("x", None, None)
    back = gather_state(st)
    np.testing.assert_array_equal(back.value, _state().value)

    x0, x1 = host_slab_bounds(mesh, SIZE)
    assert (x0, x1) == (0, SIZE[0])     # single process owns everything


def test_global_state_runs_sharded_fusion():
    mesh = global_mesh()
    st = shard_state_global(_state(), mesh)
    pts = jnp.asarray(np.tile([900, 900, 100], (60, 1)).astype(np.int32))
    mask = jnp.ones((60,), bool)
    out = tsdf_update_projective_sharded(
        st, pts, mask, jnp.zeros(3, jnp.int32), jnp.eye(3, dtype=jnp.float32),
        mesh=mesh, size=SIZE, tau=600, max_weight=32 * WEIGHT_RESOLUTION,
        resolution=64, channels=16, columns=64, vfov_deg=45.0)
    assert int(jnp.sum(out.weight != 0)) > 0


def test_two_process_distributed_matches_single(tmp_path):
    """Two REAL processes (jax.distributed over localhost, 2 CPU devices
    each -> a 4-device global mesh): one sharded fusion + registration
    step must produce the same state and pose as the same step in this
    (single-process) test runtime."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    out_npz = tmp_path / "p0.npz"
    cmd = [sys.executable, "-m", "warpsense.parallel.distributed",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--cpu", "2", "--out", str(out_npz)]
    procs = [subprocess.Popen(cmd + ["--process-id", str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = []
    for p in procs:
        out, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-2000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))

    # both processes saw the 2-process / 4-device world and split the slab
    for o in outs:
        assert o["processes"] == 2 and o["devices"] == 4
    slabs = sorted(tuple(o["slab"]) for o in outs)
    assert slabs == [(0, 40), (40, 80)]
    # the psum'd registration is replicated: identical pose + checksums
    assert outs[0]["pose"] == outs[1]["pose"]
    assert outs[0]["value_sum"] == outs[1]["value_sum"]
    assert outs[0]["weight_nonzero"] == outs[1]["weight_nonzero"] > 0

    # equals the single-process result (this runtime's 8-device mesh is
    # a different shard count — shard invariance is part of the claim)
    from warpsense.core.consts import WEIGHT_RESOLUTION
    from warpsense.map.local_map import create_state
    from warpsense.parallel.distributed import _demo_cloud
    from warpsense.parallel.sharded import (
        make_mesh, precompute_fields_packed_sharded,
        register_cloud_packed_sharded, shard_state,
        tsdf_update_projective_sharded)

    mesh = make_mesh(8)
    st = shard_state(create_state(SIZE, 600, 0, force_odd=False), mesh)
    pts = jnp.asarray(_demo_cloud(3000, half=1100, zhalf=350))
    mask = jnp.ones((pts.shape[0],), bool)
    st = tsdf_update_projective_sharded(
        st, pts, mask, jnp.zeros(3, jnp.int32),
        jnp.eye(3, dtype=jnp.float32), mesh=mesh, size=SIZE, tau=600,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=64, channels=32,
        columns=128, vfov_deg=45.0)
    fields = precompute_fields_packed_sharded(st, mesh=mesh, tau=600)
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [90, -60, 40]
    pose, _, _ = register_cloud_packed_sharded(
        fields, st.pos, st.offset, pts, mask, jnp.asarray(pert), mesh=mesh,
        size=SIZE, resolution=64, tau=600, max_iterations=30, epsilon=0.03,
        gather_freeze=True)

    saved = np.load(out_npz)
    np.testing.assert_array_equal(saved["value"], np.asarray(st.value))
    np.testing.assert_array_equal(saved["weight"], np.asarray(st.weight))
    np.testing.assert_allclose(saved["pose"], np.asarray(pose),
                               rtol=1e-5, atol=2e-3)


def test_two_process_sharded_app(tmp_path):
    """The FULL pipeline app on a 2-process mesh: identical trajectories
    in both processes, host-slab-scoped shift + per-process persistence
    whose union equals the single-process app's map."""
    from pathlib import Path

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    import os
    worker = Path(__file__).parent / "_sharded_app_worker.py"
    env = dict(os.environ,
               PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    procs = [subprocess.Popen(
        [sys.executable, str(worker), str(i), str(port), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(2)]
    for p in procs:
        out, err = p.communicate(timeout=600)
        assert p.returncode == 0, err[-3000:]
        assert "WORKER_OK" in out

    t0 = np.load(tmp_path / "traj0.npy")
    t1 = np.load(tmp_path / "traj1.npy")
    # the psum'd registration loop is replicated: bitwise-identical paths
    np.testing.assert_array_equal(t0, t1)

    # single-process 4-device twin on the same scans
    from warpsense.core.config import Params
    from warpsense.io.synthetic import (BoxWorld, render_scan,
                                        walk_trajectory)
    from warpsense.parallel.sharded import make_mesh
    from warpsense.pipeline.warpsense_sharded import ShardedWarpsenseApp

    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
                "size": {"x": 20, "y": 12, "z": 5}, "shift": 0.25,
                "update_distance": 0.08},
        "registration": {"max_iterations": 60, "epsilon": 0.0,
                         "it_weight_gradient": 0.1, "mode": "fast"},
        "lidar": {"channels": 32, "hresolution": 512},
    })
    # sync_shift: the workers shift synchronously at a fixed scan index;
    # the single-process twin must swap at the same scan to be comparable
    app = ShardedWarpsenseApp(params, mesh=make_mesh(4),
                              map_path=tmp_path / "single",
                              capacity=8192, window_size=(160, 101, 41),
                              sync_shift=True)
    poses = walk_trajectory(6, step_m=0.1)
    world = BoxWorld.default()
    rng = np.random.default_rng(0)
    ts = []
    for i, gt in enumerate(poses):
        scan = render_scan(world, gt, channels=32, columns=512,
                           noise_std=0.002, rng=rng)
        ts.append(app.cloud_callback(scan, float(i)))
    app.terminate()
    ts = np.stack(ts)
    np.testing.assert_allclose(t0[:, :3, 3], ts[:, :3, 3], atol=5.0)

    # per-process files union == single-process map (weight-nonzero wins)
    from warpsense.map.global_map import GlobalMap
    area = (np.asarray([-20, -50, -20]), np.asarray([80, 50, 20]))
    raws = []
    for path in ("mh.p0", "mh.p1", "single"):
        gm = GlobalMap(tmp_path / path, 600, 0, truncate=False)
        raws.append(gm.read_area(*area))
        gm.close()
    r0, r1, rs = raws
    merged = np.where((r0 >> 16) != 0, r0, r1)
    w_s = (rs >> 16) != 0
    assert w_s.sum() > 1000
    np.testing.assert_array_equal((merged >> 16) != 0, w_s)
    # pose paths diverge by <= 5 mm -> a thin film of voxels can fuse to
    # slightly different codes; require near-total agreement
    agree = (merged[w_s] == rs[w_s]).mean()
    assert agree > 0.99, f"map agreement {agree:.4f}"

    # the merge_maps tool produces the same union as a single file
    from warpsense.eval.merge_maps import merge
    stats = merge([tmp_path / "mh.p0", tmp_path / "mh.p1"],
                  tmp_path / "merged")
    assert stats["poses"] == 6
    gm = GlobalMap(tmp_path / "merged", 600, 0, truncate=False)
    rm = gm.read_area(*area)
    gm.close()
    np.testing.assert_array_equal(rm, merged)
