#!/usr/bin/env python3
"""On-card smoke test of the warpsense main path.

    python chip_smoke.py               # one GPU: every phase below
    python chip_smoke.py --four-cards  # four GPUs: the sharded app only

Runs the production path the way a user does — ``WarpsenseApp`` with
``registration.mode="fast"`` and ``fusion="auto"``, then ``terminate()``
— at the width of the UOS Parking Lot deployment (40 x 40 x 15 m window
at 64 mm = 625 x 625 x 235 = 91.8M voxels, tau 600 mm, OS1-128 scans of
128 x 1024, 32,768 registration points) on scans rendered from a seed,
then checks every device stage against its plain reference at that width:

* device: the card (``nvidia-smi``), JAX, XLA flags, compile cache;
* main path: 30 scans, first-scan and steady per-scan wall time, compiled
  memory of the fusion / fields / registration steps, peak device memory,
  ATE against the rendered ground truth, persisted poses;
* parity: each step on the GPU against the same function on the host CPU
  device of this process (fusion, packed fields, registration), and the
  ray-march twin against the exact integer reference;
* stage times: device time of each sweep chained K times, with its bytes
  over time against the card's memory bandwidth;
* ``--four-cards``: ``ShardedWarpsenseApp`` over a 4-device mesh against
  ``WarpsenseApp`` on device 0, scan for scan.

Any failed check raises: the script exits non-zero and prints no result.
The last line of a passing run is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))

# ---------------------------------------------------------------- deployment
# UOS Parking Lot (the reference's evaluation, README.md:309-328)
WINDOW_M = (40, 40, 15)
RES = 64                 # mm
WINDOW_VOXELS = (625, 625, 235)   # the app forces odd extents: 234 -> 235
TAU_M = 0.6
CHANNELS, COLUMNS = 128, 1024
CAPACITY = 32768
N_SCANS = 30
SCAN_DT = 0.1            # 10 Hz
STEP_M = 0.1             # 1 m/s walk
SEED = 0
# the bound tests/test_pipeline_warpsense.py holds the fast path to
ATE_BOUND_M = 0.12

# GPU vs CPU tolerances, with their reasons
# fusion: float32 sqrt, division, atan polynomial and FMA contraction
# round differently on the two backends.  At most 1e-5 of the voxels may
# differ; a voxel may differ by more than 1 unit only where a float64
# twin of the per-voxel rule puts one of its decisions (beam rounding,
# front/behind, acceptance gates, weight floor) within float32 rounding
# of its threshold — there both answers are the rule applied correctly.
FUSION_MAX_FRACTION, FUSION_MAX_UNITS = 1e-5, 1
KNIFE_EDGE_BINS, KNIFE_EDGE_MM, KNIFE_EDGE_WEIGHT = 1e-3, 0.05, 1e-3
# registration: the normal-equation reductions sum in another order
REG_MAX_DT_MM, REG_MAX_DTHETA_DEG = 1.0, 0.01
REG_TRUTH_DT_MM, REG_TRUTH_DTHETA_DEG = float(RES), 0.3
REG_PERTURBATION_MM = (80.0, -60.0, 40.0)
# four cards, one step from the same map and points: the per-iteration
# psum runs over NCCL in another order
MESH_MAX_DT_MM, MESH_MAX_DTHETA_DEG = 1.0, 0.01
# four cards, the whole 30-scan run: each app feeds its own poses back
# into fusion and registration, and discrete decisions (LM accept/reject,
# the gather freeze, the fusion gate) turn last-bit differences into
# differences the size of the registration noise.  Per pose, the two
# trajectories are held to the accuracy the parity phase demands of a
# registration against the truth (one voxel, 0.3 deg); each to the ATE
# bound.
MESH_TRAJ_MAX_DT_MM, MESH_TRAJ_MAX_DTHETA_DEG = float(RES), 0.3

RAYMARCH_POINTS = 2048
STAGE_K = 12

# Peak memory bandwidth by device_kind (NVIDIA data sheets).  A kind that
# is not here gets no roofline share.
PEAK_HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,       # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,
}


# ------------------------------------------------------------------ helpers
def plane_mismatch(a, b, *, max_fraction: float, max_units: int):
    """Compare integer planes (or tuples of planes sharing a shape) voxel
    by voxel.  Returns (voxels that differ, largest |difference|, ok):
    ok when at most ``max_fraction`` of the voxels differ, each by at most
    ``max_units``."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    differ = np.zeros(np.shape(a[0]), bool)
    worst = 0
    for x, y in zip(a, b):
        d = np.abs(np.asarray(x, np.int64) - np.asarray(y, np.int64))
        differ |= d != 0
        worst = max(worst, int(d.max(initial=0)))
    n = int(differ.sum())
    ok = n <= max_fraction * differ.size and worst <= max_units
    return n, worst, ok


def knife_edge_distance(margins):
    """Per voxel: the distance of its nearest decision from its threshold
    in tolerance units (1 = KNIFE_EDGE_BINS / _MM / _WEIGHT)."""
    with np.errstate(invalid="ignore"):
        units = np.concatenate([margins["bins"] / KNIFE_EDGE_BINS,
                                margins["mm"] / KNIFE_EDGE_MM,
                                margins["weight"][:, None]
                                / KNIFE_EDGE_WEIGHT], axis=1)
    return np.nanmin(units, axis=1)


def ambiguous_beams(points, scanner_mm, *, vfov_deg):
    """Beams (flat col * channels + ring) whose content float32 rounding
    may decide in build_beam_table on the level grid: those a point on a
    ring or column bin boundary may be binned into, and those holding a
    point on a boundary of the 8 mm range buckets that pick the nearest
    return (within KNIFE_EDGE_BINS, in float64)."""
    d = np.asarray(points, np.float64) - np.asarray(scanner_mm, np.float64)
    r = np.maximum(np.linalg.norm(d, axis=1), 1.0)
    spacing = np.radians(vfov_deg) / (CHANNELS - 1)
    ringf = (np.radians(vfov_deg) / 2
             - np.arcsin(np.clip(d[:, 2] / r, -1, 1))) / spacing
    colf = (np.arctan2(d[:, 1], d[:, 0]) + np.pi) / (2 * np.pi) * COLUMNS
    on_edge = ((np.abs(ringf - np.floor(ringf) - 0.5) < KNIFE_EDGE_BINS)
               | (np.abs(colf - np.floor(colf) - 0.5) < KNIFE_EDGE_BINS))
    bucket = np.linalg.norm(d, axis=1) / 8.0
    on_edge |= np.abs(bucket - np.round(bucket)) < KNIFE_EDGE_BINS
    out = set()
    for rf, cf in zip(ringf[on_edge], colf[on_edge]):
        for ring in {int(np.floor(rf)), int(np.floor(rf)) + 1}:
            for col in {int(np.floor(cf)), int(np.floor(cf)) + 1}:
                if 0 <= ring < CHANNELS:
                    out.add((col % COLUMNS) * CHANNELS + ring)
    return np.asarray(sorted(out), np.int64)


def rotation_deg(R) -> float:
    """Rotation angle of R in degrees; atan2 of the skew and trace parts
    stays accurate near zero, where arccos of the trace alone reads the
    float32 orthonormality error as ~0.01 deg."""
    R = np.asarray(R, np.float64)[:3, :3]
    s = np.linalg.norm([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                        R[1, 0] - R[0, 1]]) / 2.0
    c = (np.trace(R) - 1.0) / 2.0
    return float(np.degrees(np.arctan2(s, c)))


def entry_kernels(compiled) -> list[str]:
    """Opcodes of the kernels a compiled program launches: the entry
    computation's instructions, less parameters and bookkeeping."""
    lines = compiled.as_text().splitlines()
    start = next(i for i, line in enumerate(lines)
                 if line.startswith("ENTRY"))
    skip = {"parameter", "tuple", "get-tuple-element", "constant", "bitcast"}
    ops = []
    for line in lines[start + 1:]:
        if line.startswith("}"):
            break
        m = re.search(r"\s([\w-]+)\(", line.split("=", 1)[-1])
        if m and m.group(1) not in skip:
            ops.append(m.group(1))
    return ops


def check(ok: bool, what: str) -> None:
    print(f"  {'PASS' if ok else 'FAIL'}: {what}", flush=True)
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def make_params():
    from warpsense.core.config import Params
    return Params.from_dict({
        "lidar": {"channels": CHANNELS, "hresolution": COLUMNS},
        "map": {"max_distance": TAU_M, "resolution": RES,
                "size": dict(zip("xyz", WINDOW_M))},
        "registration": {"mode": "fast", "max_iterations": 50,
                         "epsilon": 0.03},
    })


def render(n_scans=N_SCANS):
    """(ground-truth poses (n, 4, 4) m, organized scans) from the seed."""
    from warpsense.io.synthetic import BoxWorld, render_scan, walk_trajectory
    truth = walk_trajectory(n_scans, step_m=STEP_M)
    rng = np.random.default_rng(SEED)
    world = BoxWorld.default()
    scans = [render_scan(world, p, channels=CHANNELS, columns=COLUMNS,
                         noise_std=0.002, rng=rng) for p in truth]
    return truth, scans


def run_app(app, truth, scans, after_first=None):
    """Feed scans (+ the matching gyro stream) through ``app``; returns
    (poses mm, per-scan wall seconds).  ``after_first`` runs once the
    first (compiling) scan is done."""
    from warpsense.io.synthetic import imu_stream_for
    from warpsense.utils.imu import ImuSample
    imu = imu_stream_for(truth, SCAN_DT)
    poses, walls = [], []
    for i, scan in enumerate(scans):
        stamp = i * SCAN_DT
        for s in imu:
            if (i - 1) * SCAN_DT < s.stamp <= stamp:
                app.imu_callback(ImuSample(s.stamp, s.angular_velocity))
        t0 = time.perf_counter()
        poses.append(app.cloud_callback(scan, stamp))
        walls.append(time.perf_counter() - t0)
        if i == 0 and after_first is not None:
            after_first()
    return np.stack(poses), np.asarray(walls)


def ate_m(truth, poses_mm) -> float:
    """Unaligned ATE RMSE: the app's map frame is the first sensor frame."""
    est = np.asarray(poses_mm, np.float64).copy()
    est[:, :3, 3] /= 1000.0
    world = np.einsum("ij,njk->nik", truth[0], est)
    err = world[:, :3, 3] - truth[:, :3, 3]
    return float(np.sqrt(np.mean(np.sum(err ** 2, axis=1))))


def map_frame_points(scan, pose_mm):
    """Dedup'd voxel centers of one scan (sensor frame, like the app's
    preprocessing) moved to the map frame at ``pose_mm``: int32 mm."""
    from warpsense.ops.preprocess import preprocess_host
    pts, mask = preprocess_host(scan.reshape(-1, 3), resolution=RES,
                                capacity=CAPACITY)
    R = np.asarray(pose_mm, np.float64)[:3, :3]
    world = pts.astype(np.float64) @ R.T + np.asarray(pose_mm)[:3, 3]
    return np.where(mask[:, None], np.round(world), 0).astype(np.int32), mask


# ------------------------------------------------------------------- phases
def phase_device(jax, cache_dir):
    print("== device", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX platform {dev.platform!r})")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi)
    print(f"jax {jax.__version__}; devices {len(jax.devices())} x "
          f"{dev.device_kind}; XLA_FLAGS={os.environ.get('XLA_FLAGS')!r}; "
          f"compile cache {cache_dir}", flush=True)
    prec = jax.config.jax_default_matmul_precision
    check(prec == "highest",
          f"float32 matmul precision is 'highest' (got {prec!r}): no TF32")


def phase_main_path(jax, workdir):
    """30 scans through WarpsenseApp at full width; returns what the parity
    phase reuses."""
    from warpsense.map.global_map import GlobalMap
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    from warpsense.ops.tsdf_projective import tsdf_update_projective
    from warpsense.pipeline.warpsense import WarpsenseApp

    print("== main path: WarpsenseApp, fusion='auto', mode='fast'",
          flush=True)
    params = make_params()
    truth, scans = render(N_SCANS)
    app = WarpsenseApp(params, map_path=workdir / "main", capacity=CAPACITY,
                       profile=True)
    size = app.local_map.size
    print(f"window {size} = {int(np.prod(size)):,} voxels; "
          f"{CHANNELS}x{COLUMNS} scans; capacity {CAPACITY}", flush=True)
    check(tuple(size) == WINDOW_VOXELS, f"window is {WINDOW_VOXELS}")
    poses, walls = run_app(app, truth, scans, after_first=app.eval.clear)
    warm = jax.device_get(app.state)
    print(f"first scan {walls[0]:.3f} s (compile included); p50 of scans "
          f"2-{N_SCANS}: {np.median(walls[1:]) * 1e3:.2f} ms; p90 "
          f"{np.percentile(walls[1:], 90) * 1e3:.2f} ms", flush=True)
    # the app's own spans (obs/profiler.py), scans 2-N
    for row in app.eval.to_rows():
        print(f"  span {row['task']}: {row['count']} x, mean "
              f"{row['avg'] / 1e3:.2f} ms, max {row['max'] / 1e3:.2f} ms")

    # compiled memory of the three device steps at the app's shapes
    m = params.map
    st = app.state
    pts = jax.numpy.zeros((CAPACITY, 3), jax.numpy.int32)
    mask = jax.numpy.zeros((CAPACITY,), bool)
    eye3 = jax.numpy.eye(3, dtype=jax.numpy.float32)
    fuse_c = tsdf_update_projective.lower(
        st, pts, mask, jax.numpy.zeros(3, jax.numpy.int32), eye3, size=size,
        tau=m.tau, max_weight=m.max_weight_scaled, resolution=RES,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=params.lidar.vfov
    ).compile()
    fields_c = precompute_fields_packed.lower(st, tau=m.tau).compile()
    fields = precompute_fields_packed(st, tau=m.tau)
    reg_c = register_cloud_packed.lower(
        fields, st.pos, st.offset, pts, mask,
        jax.numpy.eye(4, dtype=jax.numpy.float32), size=size,
        resolution=RES, tau=m.tau, max_iterations=50, it_weight_gradient=0.1,
        epsilon=0.03, gather_freeze=True).compile()
    for name, c in (("fusion", fuse_c), ("fields", fields_c),
                    ("registration", reg_c)):
        print(f"memory_analysis {name}: {c.memory_analysis()}")
        ops = entry_kernels(c)
        print(f"  {name}: {len(ops)} kernels "
              f"{dict(sorted(collections.Counter(ops).items()))}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"peak device memory: {stats.get('peak_bytes_in_use', 0):,} B",
          flush=True)

    app.terminate()
    ate = ate_m(truth, poses)
    print(f"ATE RMSE {ate:.4f} m over {N_SCANS} scans", flush=True)
    check(np.all(np.isfinite(poses)), "poses are finite")
    check(ate <= ATE_BOUND_M, f"ATE {ate:.4f} m <= {ATE_BOUND_M} m")
    n_poses = len(GlobalMap(workdir / "main", 0, truncate=False).read_poses())
    check(n_poses == N_SCANS, f"{n_poses} persisted poses == {N_SCANS}")
    return params, size, warm, scans[-1], poses[-1]


def phase_parity(jax, params, size, warm, scan, pose_mm, workdir):
    """Each device step on the GPU against the same function on the CPU
    device of this process, at full width; the ray-march twin against the
    exact integer reference."""
    import jax.numpy as jnp

    from warpsense.core.consts import MATRIX_RESOLUTION
    from warpsense.core.geometry import to_int_mat, transform_point_fixed
    from warpsense.map.global_map import GlobalMap
    from warpsense.map.local_map import LocalMap, LocalMapState, in_bounds
    from warpsense.ops.registration import (precompute_fields_packed,
                                            precompute_fields_packed2,
                                            register_cloud_packed)
    from warpsense.ops.tsdf import plan_raymarch
    from warpsense.ops.tsdf_projective import build_beam_table
    from warpsense.ops.tsdf_reference import (projective_reference,
                                              update_tsdf_reference)
    from warpsense.pipeline.fusion_backend import (fuse_cloud,
                                                   grid_rotation_for)

    print("== parity at full width: GPU vs CPU", flush=True)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    m = params.map
    pts, mask = map_frame_points(scan, pose_mm)

    def on(dev, tree):
        return jax.device_put(tree, dev)

    # --- fusion: one scan into the warm map
    devs = (("gpu", gpu), ("cpu", cpu))
    fused = {}
    for name, dev in devs:
        with jax.default_device(dev):
            out = fuse_cloud(on(dev, LocalMapState(*warm)), on(dev, pts),
                             on(dev, mask), pose_mm, params=params,
                             size=size, fusion="auto")
            fused[name] = jax.device_get(out)
    g, c = fused["gpu"], fused["cpu"]
    n, worst, _ = plane_mismatch((g.value, g.weight), (c.value, c.weight),
                                 max_fraction=FUSION_MAX_FRACTION,
                                 max_units=FUSION_MAX_UNITS)
    print(f"fusion: {n} of {g.value.size:,} voxels differ, max |diff| "
          f"{worst}; fused voxels {int(np.count_nonzero(g.weight)):,}")
    check(n <= FUSION_MAX_FRACTION * g.value.size,
          f"fusion differs in <= {FUSION_MAX_FRACTION:g} of voxels")
    # the beam tables (scan -> nearest return per beam) on both devices
    grid_rot, level = grid_rotation_for(pose_mm, params.lidar.vfov)
    check(level, "the scan's pose is inside the level-grid tilt envelope")
    scanner_mm = np.floor(pose_mm[:3, 3] / RES).astype(np.int64) * RES \
        + RES // 2
    tables, keeps = {}, {}
    for name, dev in devs:
        with jax.default_device(dev):
            pts_d = on(dev, pts)
            keep = on(dev, mask) & in_bounds(
                jnp.floor_divide(pts_d, RES), on(dev, warm.pos),
                jnp.asarray(size), -(m.tau // RES // 2))
            keeps[name] = jax.device_get(keep)
            tables[name] = jax.device_get(build_beam_table(
                pts_d, keep, jnp.asarray(scanner_mm, jnp.int32), grid_rot,
                channels=CHANNELS, columns=COLUMNS,
                vfov_deg=params.lidar.vfov))
    (rg, eg), (rc, ec) = tables["gpu"], tables["cpu"]
    # which return a beam keeps is integer work, but binning a point into
    # a beam uses the backend's own arctan2 / arcsin: a beam may keep
    # another return only where a point sits on a bin boundary
    diff_beams = np.flatnonzero((np.isfinite(rg) != np.isfinite(rc))
                                | np.any(eg != ec, axis=1))
    loose = ambiguous_beams(pts[np.asarray(keeps["cpu"])], scanner_mm,
                            vfov_deg=params.lidar.vfov)
    both = np.isfinite(rg) & np.isfinite(rc)
    rel = float(np.max(np.abs(rg[both] - rc[both]) / rc[both], initial=0))
    print(f"beam tables: {len(diff_beams)} of {len(rg):,} beams keep "
          f"another return ({len(loose)} beams take a point on a bin "
          f"boundary); {int(np.sum(rg[both] != rc[both])):,} ranges differ "
          f"in float32 rounding, by <= {rel:.2g} relative")
    check(bool(np.all(np.isin(diff_beams, loose))) and rel <= 1e-6,
          "beam tables differ only on bin boundaries, ranges within 1e-6")

    def twin(flat_idx):
        """float64 rule at flat window indices: (value, weight, distance
        from the nearest decision threshold in tolerance units, whether
        the voxel reads a beam that the two devices fill differently)."""
        a = np.stack(np.unravel_index(flat_idx, size), axis=1)
        sz = np.asarray(size)
        gcoords = warm.pos + np.mod(a - warm.offset + sz // 2, sz) - sz // 2
        v, w, mg = projective_reference(
            gcoords, scanner_mm, rc, ec, tau=m.tau, resolution=RES,
            channels=CHANNELS, columns=COLUMNS, vfov_deg=params.lidar.vfov)
        return v, w, knife_edge_distance(mg), np.isin(mg["beam"], diff_beams)

    # beyond one unit: only where the rule itself sits on a threshold
    big = np.flatnonzero(
        (np.abs(g.value.astype(np.int32) - c.value) > FUSION_MAX_UNITS)
        | (np.abs(g.weight.astype(np.int32) - c.weight) > FUSION_MAX_UNITS))
    _, _, edge, other_beam = twin(big)
    explained = (edge <= 1.0) | other_beam
    print(f"fusion: {len(big)} voxels differ by more than "
          f"{FUSION_MAX_UNITS} unit: {int(other_beam.sum())} read a beam "
          f"the devices fill differently, {int((edge <= 1.0).sum())} sit "
          "on a threshold of the per-voxel rule")
    for i in big[~explained][:5]:
        print(f"  voxel {np.unravel_index(i, size)}: GPU "
              f"({g.value.flat[i]}, {g.weight.flat[i]}), CPU "
              f"({c.value.flat[i]}, {c.weight.flat[i]}), warm "
              f"({warm.value.flat[i]}, {warm.weight.flat[i]})")
    check(bool(np.all(explained)),
          "every voxel that differs by more than 1 unit reads a boundary "
          "beam or sits on a float32 rounding boundary of the rule")

    # the GPU sweep against the float64 twin: the same scan into an empty
    # window, every voxel it fused plus 1M drawn at random
    empty = LocalMapState(np.full(size, m.tau, np.int16),
                          np.zeros(size, np.int16), warm.pos, warm.offset)
    with jax.default_device(gpu):
        first = jax.device_get(fuse_cloud(
            on(gpu, empty), on(gpu, pts), on(gpu, mask), pose_mm,
            params=params, size=size, fusion="auto"))
    sample = np.union1d(np.flatnonzero(first.weight), np.random.default_rng(
        SEED).integers(0, first.weight.size, 1_000_000))
    v, w, edge, other_beam = twin(sample)
    clear = (edge > 1.0) & ~other_beam
    got_v = first.value.reshape(-1)[sample]
    got_w = first.weight.reshape(-1)[sample]
    bad = clear & ((got_w != w) | (got_v != np.where(w != 0, v, m.tau)))
    for i in np.flatnonzero(bad)[:5]:
        print(f"  voxel {np.unravel_index(sample[i], size)}: GPU "
              f"({got_v[i]}, {got_w[i]}), twin ({v[i]}, {w[i]}), "
              f"{edge[i]:.3g} tolerance units from a threshold")
    print(f"fusion vs float64 twin: {len(sample):,} voxels "
          f"({int(np.count_nonzero(got_w)):,} fused), "
          f"{int((~clear).sum()):,} on a threshold or a boundary beam, "
          f"{int(bad.sum())} differ elsewhere")
    check(not bad.any(), "the GPU sweep equals the float64 twin wherever "
                         "the rule is clear of a threshold")

    # --- packed fields: integer-only, bit-exact
    base = g
    fields = {}
    for name, dev in devs:
        st = on(dev, base)
        fields[name] = (precompute_fields_packed(st, tau=m.tau),
                        precompute_fields_packed2(st))
    for i, name in enumerate(("packed", "packed2")):
        a = jax.device_get(fields["gpu"][i])
        b = jax.device_get(fields["cpu"][i])
        n, worst, ok = plane_mismatch(tuple(a), tuple(b), max_fraction=0.0,
                                      max_units=0)
        print(f"fields {name}: {n} voxels differ")
        check(ok, f"fields {name} bit-exact")

    # --- registration from a known perturbation
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = REG_PERTURBATION_MM
    out = {}
    for name, dev in devs:
        with jax.default_device(dev):
            f = fields[name][0]
            T, iters, _ = register_cloud_packed(
                f, on(dev, base.pos), on(dev, base.offset), on(dev, pts),
                on(dev, mask), on(dev, pert), size=size, resolution=RES,
                tau=m.tau, max_iterations=50, it_weight_gradient=0.1,
                epsilon=0.03, gather_freeze=True)
            out[name] = (np.asarray(T, np.float64), int(iters))
    (Tg, ig), (Tc, ic) = out["gpu"], out["cpu"]
    dt = float(np.linalg.norm(Tg[:3, 3] - Tc[:3, 3]))
    dth = rotation_deg(Tg[:3, :3] @ Tc[:3, :3].T)
    print(f"registration: GPU {ig} iters, t {Tg[:3, 3].round(3)} mm, "
          f"rot {rotation_deg(Tg):.4f} deg; CPU {ic} iters, t "
          f"{Tc[:3, 3].round(3)} mm; |dt| {dt:.4f} mm, |dtheta| "
          f"{dth:.5f} deg")
    check(dt <= REG_MAX_DT_MM and dth <= REG_MAX_DTHETA_DEG,
          f"GPU-CPU drift <= {REG_MAX_DT_MM} mm, {REG_MAX_DTHETA_DEG} deg")
    for name, T in (("GPU", Tg), ("CPU", Tc)):
        check(np.linalg.norm(T[:3, 3]) <= REG_TRUTH_DT_MM
              and rotation_deg(T) <= REG_TRUTH_DTHETA_DEG,
              f"{name} recovers the truth within one voxel and "
              f"{REG_TRUTH_DTHETA_DEG} deg")

    # --- ray-march twin vs the exact integer reference
    sub = pts[mask][:: max(1, int(mask.sum()) // RAYMARCH_POINTS)]
    sub = sub[:RAYMARCH_POINTS]
    lm = LocalMap(size, GlobalMap(workdir / "raymarch", m.tau, 0),
                  force_odd=False)
    fresh = LocalMapState(*jax.device_get(lm.device_state()))
    max_steps, max_isteps = plan_raymarch(m.tau, RES, 50000, CHANNELS,
                                          params.lidar.vfov)
    with jax.default_device(gpu):
        march = jax.device_get(fuse_cloud(
            on(gpu, fresh), on(gpu, sub), on(gpu, np.ones(len(sub), bool)),
            pose_mm, params=params, size=size, fusion="raymarch",
            max_steps=max_steps, max_isteps=max_isteps))
    with jax.default_device(cpu):
        int_rot = to_int_mat(jnp.asarray(pose_mm, jnp.float32))
        up = np.asarray(transform_point_fixed(
            jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32),
            int_rot.at[:3, 3].set(0)), np.int64)
    scanner = np.floor(pose_mm[:3, 3] / RES).astype(np.int64)
    t0 = time.perf_counter()
    update_tsdf_reference(sub.astype(np.int64), scanner, up, lm, m.tau,
                          m.max_weight_scaled, RES, channels=CHANNELS,
                          vfov_deg=params.lidar.vfov)
    n, worst, ok = plane_mismatch(
        (march.value, march.weight), (lm.state.value, lm.state.weight),
        max_fraction=0.0, max_units=0)
    print(f"ray-march twin ({len(sub)} points): {n} voxels differ from the "
          f"integer reference; {int(np.count_nonzero(march.weight)):,} "
          f"touched; reference took {time.perf_counter() - t0:.1f} s")
    check(ok, "ray-march twin bit-exact against the reference")


def phase_stage_times(jax):
    """Device time per stage at 91.8M voxels and 32K points: K chained
    iterations, each feeding the next, awaited once."""
    import jax.numpy as jnp

    import bench
    from warpsense.core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
    from warpsense.ops.tsdf import plan_raymarch, tsdf_update

    print("== stage times (device, not gated)", flush=True)
    cfg = dict(bench.FULL, k=STAGE_K)
    loops = bench.build_slam_loops(cfg)
    nvox = int(np.prod(cfg["size"]))

    def per_iter(fn, *args, reps=3):
        jax.block_until_ready(fn(*args))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(*args))
            best = min(best, time.perf_counter() - t0)
        return best / STAGE_K

    warm = jax.block_until_ready(bench._single_fusion(loops, loops["state"],
                                                      cfg=cfg))
    t_fuse = per_iter(loops["tsdf"], warm)
    t_xor = per_iter(loops["xor"], warm)
    t_fields = per_iter(loops["fields"], warm) - t_xor
    fields = jax.block_until_ready(loops["precompute"](warm))
    t_reg = per_iter(loops["reg"], fields, warm.pos, warm.offset)
    _, iters, _ = loops["reg_once"](fields, warm)
    iters = int(iters)

    ms, mi = plan_raymarch(cfg["tau"], cfg["res"], 50000, cfg["channels"],
                           cfg["vfov_deg"])
    up = jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32)

    def march(st):
        return tsdf_update(st, loops["pts"], loops["mask"],
                           jnp.zeros(3, jnp.int32), up, size=cfg["size"],
                           tau=cfg["tau"], max_weight=32 * WEIGHT_RESOLUTION,
                           resolution=cfg["res"], max_steps=ms,
                           max_isteps=mi, channels=cfg["channels"],
                           vfov_deg=cfg["vfov_deg"])

    st = jax.block_until_ready(march(jax.tree.map(jnp.copy, warm)))
    t0 = time.perf_counter()
    for _ in range(STAGE_K):
        st = march(st)
    jax.block_until_ready(st)
    t_march = (time.perf_counter() - t0) / STAGE_K

    kind = jax.devices()[0].device_kind
    peak = PEAK_HBM_BYTES_PER_S.get(kind)
    # floors from shapes: both sweeps read and write 8 B per voxel
    # (fusion: int16 value + weight in and out; fields: 4 B in, 4 B out)
    for name, t, nbytes in (("level fusion sweep (XLA)", t_fuse, 8 * nvox),
                            ("packed-fields precompute", t_fields,
                             8 * nvox)):
        rate = nbytes / t
        share = (f"{rate / peak:.1%} of {peak / 1e12:.2f} TB/s"
                 if peak else "no peak on record for this device")
        print(f"{name}: {t * 1e3:.3f} ms; {nbytes / 1e9:.3f} GB -> "
              f"{rate / 1e12:.3f} TB/s = {share}")
    print(f"LM loop: {t_reg * 1e3:.3f} ms per registration, {iters} "
          f"iterations ({t_reg / max(iters, 1) * 1e3:.3f} ms each)")
    print(f"ray-march twin (scatter-min, {int(loops['mask'].sum())} points):"
          f" {t_march * 1e3:.3f} ms", flush=True)


def phase_four_cards(jax, workdir):
    """ShardedWarpsenseApp over a 1-D 4-device mesh against WarpsenseApp
    on device 0: one step of each stage from the same map and points,
    then the two apps scan for scan."""
    from warpsense.map.local_map import LocalMapState
    from warpsense.ops.registration import (precompute_fields_packed,
                                            register_cloud_packed)
    from warpsense.parallel.sharded import (
        make_mesh, precompute_fields_packed_sharded,
        register_cloud_packed_sharded, shard_state,
        tsdf_update_projective_sharded)
    from warpsense.pipeline.fusion_backend import (fuse_cloud,
                                                   grid_rotation_for)
    from warpsense.pipeline.warpsense import WarpsenseApp
    from warpsense.pipeline.warpsense_sharded import ShardedWarpsenseApp

    print("== four cards: ShardedWarpsenseApp vs WarpsenseApp", flush=True)
    n = len(jax.devices())
    check(n == 4, f"4 devices visible (got {n})")
    params = make_params()
    m = params.map
    mesh = make_mesh(4)
    # x extent: the nearest that the mesh divides (625 -> 624)
    window = (WINDOW_VOXELS[0] // 4 * 4,) + WINDOW_VOXELS[1:]
    truth, scans = render(N_SCANS)
    dev0 = jax.devices()[0]
    with jax.default_device(dev0):
        one = WarpsenseApp(params, map_path=workdir / "one",
                           capacity=CAPACITY, window_size=window,
                           force_odd=False)
        p1, w1 = run_app(one, truth, scans)
        warm = jax.device_get(one.state)
        one.terminate()

    # --- one step of each stage, same inputs, 1 card vs the mesh
    pose = p1[-1]
    pts, mask = map_frame_points(scans[-1], pose)
    rot, _ = grid_rotation_for(pose, params.lidar.vfov)
    spos = np.floor(pose[:3, 3] / RES).astype(np.int32)
    with jax.default_device(dev0):
        single = fuse_cloud(jax.device_put(LocalMapState(*warm), dev0), pts,
                            mask, pose, params=params, size=window,
                            fusion="auto")
        f1 = precompute_fields_packed(single, tau=m.tau)
    sharded = tsdf_update_projective_sharded(
        shard_state(LocalMapState(*warm), mesh), pts, mask, spos, rot,
        mesh=mesh, size=window, tau=m.tau, max_weight=m.max_weight_scaled,
        resolution=RES, channels=CHANNELS, columns=COLUMNS,
        vfov_deg=params.lidar.vfov)
    n_fuse, worst, _ = plane_mismatch(
        (np.asarray(single.value), np.asarray(single.weight)),
        (np.asarray(sharded.value), np.asarray(sharded.weight)),
        max_fraction=0.0, max_units=0)
    print(f"fusion: {n_fuse} of {np.prod(window):,} voxels differ between "
          f"1 card and the mesh (max |diff| {worst})")
    check(n_fuse <= FUSION_MAX_FRACTION * np.prod(window),
          f"mesh fusion differs in <= {FUSION_MAX_FRACTION:g} of voxels")
    f4 = precompute_fields_packed_sharded(
        shard_state(jax.device_get(single), mesh), mesh=mesh, tau=m.tau)
    n_f, _, ok = plane_mismatch(np.asarray(f1.plane), np.asarray(f4.plane),
                                max_fraction=0.0, max_units=0)
    print(f"fields: {n_f} voxels differ between 1 card and the mesh")
    check(ok, "mesh packed fields bit-exact")
    pert = np.eye(4, dtype=np.float32)
    pert[:3, 3] = REG_PERTURBATION_MM
    kw = dict(size=window, resolution=RES, tau=m.tau, max_iterations=50,
              epsilon=0.03, gather_freeze=True)
    with jax.default_device(dev0):
        T1, i1, _ = register_cloud_packed(f1, single.pos, single.offset, pts,
                                          mask, pert, it_weight_gradient=0.1,
                                          **kw)
    T4, i4, _ = register_cloud_packed_sharded(
        f4, np.asarray(single.pos), np.asarray(single.offset), pts, mask,
        pert, mesh=mesh, **kw)
    T1, T4 = np.asarray(T1, np.float64), np.asarray(T4, np.float64)
    dt1 = float(np.linalg.norm(T1[:3, 3] - T4[:3, 3]))
    dth1 = rotation_deg(T1[:3, :3] @ T4[:3, :3].T)
    print(f"registration: 1 card {int(i1)} iters, mesh {int(i4)} iters; "
          f"|dt| {dt1:.4f} mm, |dtheta| {dth1:.5f} deg", flush=True)
    check(dt1 <= MESH_MAX_DT_MM and dth1 <= MESH_MAX_DTHETA_DEG,
          f"one mesh registration within {MESH_MAX_DT_MM} mm and "
          f"{MESH_MAX_DTHETA_DEG} deg of the 1-card one")

    # --- the two apps, scan for scan
    many = ShardedWarpsenseApp(params, mesh=mesh, map_path=workdir / "many",
                               capacity=CAPACITY, window_size=window)
    p4, w4 = run_app(many, truth, scans)
    many.terminate()
    dt = np.linalg.norm(p1[:, :3, 3] - p4[:, :3, 3], axis=1)
    dth = np.asarray([rotation_deg(a[:3, :3] @ b[:3, :3].T)
                      for a, b in zip(p1, p4)])
    ate1, ate4 = ate_m(truth, p1), ate_m(truth, p4)
    print(f"window {window}; p50 per scan: 1 card "
          f"{np.median(w1[1:]) * 1e3:.2f} ms, 4 cards "
          f"{np.median(w4[1:]) * 1e3:.2f} ms")
    print("trajectory drift per pose (mm): "
          f"{[round(float(x), 3) for x in dt]}")
    print(f"max |dt| {dt.max():.4f} mm, max |dtheta| {dth.max():.5f} deg; "
          f"ATE 1 card {ate1:.4f} m, 4 cards {ate4:.4f} m", flush=True)
    check(max(ate1, ate4) <= ATE_BOUND_M, f"both ATEs <= {ATE_BOUND_M} m")
    check(dt.max() <= MESH_TRAJ_MAX_DT_MM
          and dth.max() <= MESH_TRAJ_MAX_DTHETA_DEG,
          f"trajectories agree per pose within {MESH_TRAJ_MAX_DT_MM:g} mm "
          f"and {MESH_TRAJ_MAX_DTHETA_DEG} deg")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded app over 4 GPUs against "
                         "the single-card app")
    args = ap.parse_args(argv)

    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the parity phase runs the CPU twins in this same process
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    from warpsense.utils.compile_cache import enable_compile_cache
    cache_dir = enable_compile_cache()
    import jax

    phase_device(jax, cache_dir)
    workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        if args.four_cards:
            phase_four_cards(jax, workdir)
        else:
            main_out = phase_main_path(jax, workdir)
            phase_parity(jax, *main_out, workdir)
            phase_stage_times(jax)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
