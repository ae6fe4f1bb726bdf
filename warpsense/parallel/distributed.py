"""Multi-host (multi-process) mesh bring-up for the sharded SLAM layer.

The reference is strictly single-node/single-GPU (SURVEY.md §2.7/§5.8);
this is the new capability's process-level entry: initialize
``jax.distributed``, build a global 1-D mesh over every chip of every
host, and construct host-local shards of the TSDF window as a global
``jax.Array`` — after which every function in parallel/sharded.py works
unchanged (shard_map addresses the global mesh; collectives ride
ICI/DCN as laid out by the mesh).

Single-process (tests, one host) degenerates gracefully: ``initialize``
with ``num_processes=1`` is a no-op-equivalent and the helpers fall back
to plain ``device_put``.
"""
from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..map.local_map import LocalMapState


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Bring up jax.distributed from args or the standard env vars
    (JAX_COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID); no-op when
    single-process and nothing is configured."""
    coordinator_address = (coordinator_address
                           or os.environ.get("JAX_COORDINATOR_ADDRESS"))
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if coordinator_address is None and num_processes == 1:
        return                                  # single host, nothing to do
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes, process_id=process_id)


def global_mesh(axis: str = "x") -> Mesh:
    """1-D mesh over ALL devices of the job (every chip of every host),
    in process-major order so each host's block is contiguous — slab IO
    during shift stays host-local."""
    return Mesh(np.array(jax.devices()), (axis,))


def shard_state_global(state: LocalMapState, mesh: Mesh) -> LocalMapState:
    """Place a (host-replicated numpy/jnp) LocalMapState as a global
    x-block-sharded jax.Array across every process.

    Each process materializes only ITS devices' blocks
    (``make_array_from_callback`` slices the host copy), so the full
    window never needs to exist on more than one host at a time beyond
    the source copy driving the call."""
    blk = NamedSharding(mesh, P("x", None, None))
    rep = NamedSharding(mesh, P())

    def arr(x, sharding):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx])

    return LocalMapState(
        value=arr(state.value, blk),
        weight=arr(state.weight, blk),
        pos=arr(np.asarray(state.pos, np.int32), rep),
        offset=arr(np.asarray(state.offset, np.int32), rep),
    )


def host_slab_bounds(mesh: Mesh, size: tuple[int, int, int]
                     ) -> tuple[int, int]:
    """[x0, x1) array-axis rows owned by THIS process's devices — the
    rows whose slab IO (shift eviction/load) this host performs."""
    X = size[0]
    devs = list(mesh.devices.flat)
    n = len(devs)
    assert X % n == 0, "window X must divide the mesh"
    xs = X // n
    mine = [i for i, d in enumerate(devs)
            if d.process_index == jax.process_index()]
    if not mine:
        return 0, 0
    return min(mine) * xs, (max(mine) + 1) * xs


def gather_state(state: LocalMapState) -> LocalMapState:
    """Fully-replicated numpy copy of a sharded state (host side; uses
    process-local data plus an allgather when multi-host)."""
    def np_of(x):
        if isinstance(x, jax.Array) and not x.is_fully_addressable:
            from jax.experimental import multihost_utils
            x = multihost_utils.process_allgather(x, tiled=True)
        return np.asarray(x)
    return LocalMapState(*(np_of(x) for x in state))


# ------------------------------------------------------------ runnable entry

def _demo_cloud(n: int, half: int, zhalf: int, seed: int = 7) -> np.ndarray:
    """Deterministic box-room cloud (int32 mm) — identical in every
    process, so the sharded step's inputs are process-invariant."""
    from ..io.synthetic import box_room_cloud
    return box_room_cloud(n, half, zhalf, seed=seed)


def main(argv=None) -> None:
    """Multi-host demo/validation step: bring up ``jax.distributed``,
    build the global mesh, run ONE sharded fusion + packed registration
    step on a deterministic synthetic cloud, and print a JSON line with
    this host's slab bounds, the registered pose, and state checksums
    (identical across processes and equal to the single-process result —
    asserted by tests/test_distributed.py with 2 real CPU processes).

        python -m warpsense.parallel.distributed \
            --coordinator host0:9999 --num-processes 2 --process-id 0
    """
    import argparse
    import json

    from ..core.consts import WEIGHT_RESOLUTION
    from ..map.local_map import create_state
    from .sharded import (precompute_fields_packed_sharded,
                          register_cloud_packed_sharded,
                          tsdf_update_projective_sharded)

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--cpu", type=int, default=0,
                    help="force the CPU backend with N local devices "
                         "(testing; GPU hosts use their cards)")
    ap.add_argument("--size", type=int, nargs=3, default=[80, 41, 41])
    ap.add_argument("--out", default=None,
                    help="process 0 writes value/weight/pose here (.npz)")
    args = ap.parse_args(argv)

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.cpu)
    init_distributed(args.coordinator, args.num_processes, args.process_id)
    mesh = global_mesh()
    size = tuple(args.size)
    TAU, RES = 600, 64

    state = shard_state_global(
        create_state(size, TAU, 0, force_odd=False), mesh)
    pts = jnp.asarray(_demo_cloud(3000, half=1100, zhalf=350))
    mask = jnp.ones((pts.shape[0],), bool)
    state = tsdf_update_projective_sharded(
        state, pts, mask, jnp.zeros(3, jnp.int32),
        jnp.eye(3, dtype=jnp.float32), mesh=mesh, size=size, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES, channels=32,
        columns=128, vfov_deg=45.0)
    fields = precompute_fields_packed_sharded(state, mesh=mesh, tau=TAU)
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = [90, -60, 40]
    pose, iters, err = register_cloud_packed_sharded(
        fields, state.pos, state.offset, pts, mask, jnp.asarray(pert),
        mesh=mesh, size=size, resolution=RES, tau=TAU, max_iterations=30,
        epsilon=0.03, gather_freeze=True)

    x0, x1 = host_slab_bounds(mesh, size)
    full = gather_state(state)
    print(json.dumps({
        "process": jax.process_index(),
        "processes": jax.process_count(),
        "devices": len(jax.devices()),
        "slab": [x0, x1],
        "pose": np.asarray(pose).tolist(),
        "iters": int(iters),
        "weight_nonzero": int((full.weight != 0).sum()),
        "value_sum": int(np.asarray(full.value, np.int64).sum()),
    }))
    if args.out and jax.process_index() == 0:
        np.savez(args.out, value=full.value, weight=full.weight,
                 pose=np.asarray(pose))


if __name__ == "__main__":
    main()
