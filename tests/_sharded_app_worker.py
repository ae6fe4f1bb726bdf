"""Worker for tests/test_distributed.py::test_two_process_sharded_app:
one process of a 2-process ShardedWarpsenseApp run (2 CPU devices each ->
a 4-device global mesh), driving identical synthetic scans through the
full pipeline app (fusion, cached sharded fields, registration, a forced
sharded shift with host-slab-scoped IO, per-process persistence)."""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)

pid, port, outdir = int(sys.argv[1]), sys.argv[2], sys.argv[3]
jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=2, process_id=pid)

import numpy as np  # noqa: E402

from warpsense.core.config import Params  # noqa: E402
from warpsense.io.synthetic import (BoxWorld, render_scan,  # noqa: E402
                                    walk_trajectory)
from warpsense.parallel.distributed import global_mesh  # noqa: E402
from warpsense.pipeline.warpsense_sharded import \
    ShardedWarpsenseApp  # noqa: E402

params = Params.from_dict({
    "map": {"max_distance": 0.6, "resolution": 128, "max_weight": 10,
            "size": {"x": 20, "y": 12, "z": 5}, "shift": 0.25,
            "update_distance": 0.08},
    "registration": {"max_iterations": 60, "epsilon": 0.0,
                     "it_weight_gradient": 0.1, "mode": "fast"},
    "lidar": {"channels": 32, "hresolution": 512},
})
mesh = global_mesh()
app = ShardedWarpsenseApp(params, mesh=mesh, map_path=f"{outdir}/mh",
                          capacity=8192, window_size=(160, 101, 41))
poses = walk_trajectory(6, step_m=0.1)
world = BoxWorld.default()
rng = np.random.default_rng(0)          # identical scans in every process
traj = []
for i, gt in enumerate(poses):
    scan = render_scan(world, gt, channels=32, columns=512,
                       noise_std=0.002, rng=rng)
    traj.append(app.cloud_callback(scan, float(i)))
assert np.any(np.asarray(app.state.pos) != 0), "shift did not run"
app.terminate()
np.save(f"{outdir}/traj{pid}.npy", np.stack(traj))
print("WORKER_OK", pid)
