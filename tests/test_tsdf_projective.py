"""Projective TSDF fusion vs the ray-march twin."""
import numpy as np
import jax.numpy as jnp
import pytest

from warpsense.core.consts import MATRIX_RESOLUTION, WEIGHT_RESOLUTION
from warpsense.io.synthetic import BoxWorld, render_scan
from warpsense.map.local_map import create_state
from warpsense.ops.preprocess import preprocess_host
from warpsense.ops.tsdf import plan_raymarch, tsdf_update
from warpsense.ops.tsdf_projective import (atan2_poly, build_beam_table,
                                           tsdf_update_projective)

TAU = 600
RES = 64
SIZE = (161, 161, 81)
CHANNELS, COLUMNS, VFOV = 32, 512, 45.0


def _scan_points(seed=0, cap=16384):
    rng = np.random.default_rng(seed)
    scan = render_scan(BoxWorld.default(), np.eye(4), channels=CHANNELS,
                       columns=COLUMNS, vfov_deg=VFOV, noise_std=0.002,
                       rng=rng)
    pts, mask = preprocess_host(scan.reshape(-1, 3), resolution=RES,
                                capacity=cap)
    return jnp.asarray(pts), jnp.asarray(mask)


def _fresh():
    return create_state(SIZE, TAU, 0, xp=jnp)


def test_atan2_poly_matches_numpy():
    rng = np.random.default_rng(1)
    y = jnp.asarray(rng.normal(0, 1e4, (64, 128)), jnp.float32)
    x = jnp.asarray(rng.normal(0, 1e4, (64, 128)), jnp.float32)
    got = np.asarray(atan2_poly(y, x))
    want = np.arctan2(np.asarray(y), np.asarray(x))
    assert np.max(np.abs(got - want)) < 1e-5


def test_beam_table_nearest_return():
    pts = jnp.asarray([[5000, 0, 0], [9000, 0, 0],      # same beam, 5m & 9m
                       [0, 5000, 0]], jnp.int32)
    mask = jnp.ones((3,), bool)
    rng_tab, endpoint = build_beam_table(
        pts, mask, jnp.zeros(3, jnp.int32), jnp.eye(3, dtype=jnp.float32),
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
    hit = np.isfinite(np.asarray(rng_tab))
    assert hit.sum() == 2                                # two distinct beams
    eps = np.asarray(endpoint)[hit]
    # the +x beam must keep the NEAR return (5 m)
    assert any(np.allclose(e, [5000, 0, 0], atol=1) for e in eps)
    assert not any(np.allclose(e, [9000, 0, 0], atol=1) for e in eps)


def test_projective_matches_raymarch_statistically():
    pts, mask = _scan_points()
    up = jnp.asarray([0, 0, MATRIX_RESOLUTION], jnp.int32)
    ms, mi = plan_raymarch(TAU, RES, 12000, CHANNELS, VFOV)

    ray = tsdf_update(_fresh(), pts, mask, jnp.zeros(3, jnp.int32), up,
                      size=SIZE, tau=TAU, max_weight=32 * WEIGHT_RESOLUTION,
                      resolution=RES, max_steps=ms, max_isteps=mi,
                      channels=CHANNELS, vfov_deg=VFOV)
    proj = tsdf_update_projective(
        _fresh(), pts, mask, jnp.zeros(3, jnp.int32),
        jnp.eye(3, dtype=jnp.float32), size=SIZE, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)

    rv = np.asarray(ray.value, np.int32)
    rw = np.asarray(ray.weight, np.int32)
    pv = np.asarray(proj.value, np.int32)
    pw = np.asarray(proj.weight, np.int32)

    r_occ = rw != 0
    p_occ = pw != 0
    both = r_occ & p_occ
    # coverage: the two formulations quantize ray footprints differently,
    # but the bulk of the fused volume must coincide
    jaccard = both.sum() / max((r_occ | p_occ).sum(), 1)
    assert jaccard > 0.6, f"occupancy jaccard {jaccard:.3f}"
    # where both fused, values must agree closely (same signed distances)
    # the march keeps min-|v| over ALL rays crossing a cell; projective
    # reads the single nearest beam — sub-half-voxel value differences
    mad = np.abs(rv[both] - pv[both]).mean()
    assert mad < 0.35 * RES, f"value MAD {mad:.1f} mm"
    # sign must agree wherever the cell is clearly on one side of the
    # surface (|v| > res/2; straddling cells flip on quantization alone)
    clear = both & (np.abs(rv) > RES // 2)
    sign_agree = np.mean(np.sign(rv[clear]) == np.sign(pv[clear]))
    assert sign_agree > 0.97, f"sign agreement {sign_agree:.3f}"


def test_projective_surface_zero_crossing():
    """Wall at x=+4 m: TSDF along +x must cross zero at the wall."""
    pts, mask = _scan_points(seed=1)
    proj = tsdf_update_projective(
        _fresh(), pts, mask, jnp.zeros(3, jnp.int32),
        jnp.eye(3, dtype=jnp.float32), size=SIZE, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
    v = np.asarray(proj.value, np.int32)
    w = np.asarray(proj.weight, np.int32)
    # walk from the scanner toward the first pillar (x 2..2.6, y 1..1.6 m,
    # BoxWorld.default): TSDF must be positive in front, negative behind,
    # crossing zero at the front face (|p| ~ 2.4 m along this bearing)
    c = np.asarray([SIZE[0] // 2, SIZE[1] // 2, SIZE[2] // 2])
    target = np.array([2.3, 1.3, 0.0])
    direction = target / np.linalg.norm(target)
    ts = np.arange(0.2, 4.5, 0.032)            # meters, half-voxel steps
    cells = np.unique(
        (c + np.floor(ts[:, None] * direction * 1000.0 / RES)).astype(int),
        axis=0)
    # re-order along the bearing
    cells = cells[np.argsort(np.linalg.norm((cells - c) * RES, axis=1))]
    line_v = v[cells[:, 0], cells[:, 1], cells[:, 2]]
    line_w = w[cells[:, 0], cells[:, 1], cells[:, 2]]
    fused = line_w != 0
    assert fused.sum() > 10
    signs = np.sign(line_v[fused])
    assert signs[0] > 0
    assert (signs < 0).any()
    flip_dist = np.linalg.norm(
        (cells[fused][np.argmax(signs < 0)] - c) * RES) / 1000.0
    front = np.linalg.norm([2.0 * 2.3 / 2.6, 1.3 * 2.0 / 2.3, 0])  # ~face
    assert 1.9 <= flip_dist <= 2.9, f"zero crossing at {flip_dist:.2f} m"


def test_projective_weight_drop_behind_surface():
    pts, mask = _scan_points(seed=2)
    proj = tsdf_update_projective(
        _fresh(), pts, mask, jnp.zeros(3, jnp.int32),
        jnp.eye(3, dtype=jnp.float32), size=SIZE, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
    v = np.asarray(proj.value, np.int32)
    w = np.asarray(proj.weight, np.int32)
    deep = v < -TAU // 10
    assert deep.any()
    # weights behind the surface drop linearly and never exceed the base
    assert (np.abs(w[deep]) < WEIGHT_RESOLUTION).all()
    assert (np.abs(w[deep & (w != 0)]) > 0).all()


def test_fusion_config_guards():
    """check_fusion_config (ADVICE r3): configurations that would break
    the f32-exact merge division or the banded-atan ring binning raise at
    the fusion entry instead of silently corrupting the map."""
    import pytest
    from warpsense.ops.tsdf_projective import check_fusion_config

    check_fusion_config(600, 32 * WEIGHT_RESOLUTION, 45.0)   # bench config
    with pytest.raises(ValueError, match="2\\^24"):
        # tau 3 m, max_weight 128 * WEIGHT_RESOLUTION = 8192 -> 4.9e7
        check_fusion_config(3000, 8192, 45.0)
    with pytest.raises(ValueError, match="vfov"):
        check_fusion_config(600, 640, 120.0)
    with pytest.raises(ValueError):
        tsdf_update_projective(
            _fresh(), *_scan_points(seed=0), jnp.zeros(3, jnp.int32),
            jnp.eye(3, dtype=jnp.float32), size=SIZE, tau=TAU,
            max_weight=1 << 24, resolution=RES,
            channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)


def _pitched_scene(pitch_deg, seed=5):
    """Map-frame mm points of a scan captured at a pitched sensor pose."""
    t = np.radians(pitch_deg)
    pose = np.eye(4)
    pose[:3, :3] = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                             [-np.sin(t), 0, np.cos(t)]])
    rng = np.random.default_rng(seed)
    scan = render_scan(BoxWorld.default(), pose, channels=CHANNELS,
                       columns=COLUMNS, vfov_deg=VFOV, noise_std=0.002,
                       rng=rng).reshape(-1, 3)
    valid = np.any(scan != 0.0, axis=1)
    world = scan @ pose[:3, :3].T + pose[:3, 3]
    pts, mask = preprocess_host(np.where(valid[:, None], world, 0.0),
                                resolution=RES, capacity=16384)
    return (jnp.asarray(pts), jnp.asarray(mask),
            jnp.asarray(pose[:3, :3], jnp.float32))


def test_level_grid_tilt_envelope():
    """Quantify the LEVEL-grid production path's attitude envelope
    (VERDICT r3 #6): under sensor pitch, the level map-aligned binning
    drops returns whose map-frame elevation leaves the ring band, while
    the attitude-aware grid keeps them.  Inside the vfov/8 budget the
    written-voxel deficit stays in the low single digits; beyond it the
    deficit grows — which is why fusion dispatch falls back (see
    fusion_backend.level_tilt_budget_deg)."""
    from warpsense.pipeline.fusion_backend import level_tilt_budget_deg

    budget = level_tilt_budget_deg(VFOV)        # 2 deg (measured)
    deficits = {}
    for pitch in (0.0, budget, 5.625, 11.25):
        pts, mask, R = _pitched_scene(pitch)
        level = tsdf_update_projective(
            _fresh(), pts, mask, jnp.zeros(3, jnp.int32),
            jnp.eye(3, dtype=jnp.float32), size=SIZE, tau=TAU,
            max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
            channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
        attitude = tsdf_update_projective(
            _fresh(), pts, mask, jnp.zeros(3, jnp.int32), R, size=SIZE,
            tau=TAU, max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
            channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
        n_level = int(np.count_nonzero(np.asarray(level.weight)))
        n_att = int(np.count_nonzero(np.asarray(attitude.weight)))
        deficits[pitch] = 1.0 - n_level / max(n_att, 1)
    assert abs(deficits[0.0]) < 1e-6            # level == attitude level
    assert deficits[budget] < 0.12, deficits    # inside the budget
    assert deficits[11.25] > deficits[5.625] > deficits[budget]
    assert deficits[11.25] > 0.25, deficits     # why dispatch falls back


def test_fusion_dispatch_attitude_fallback(tmp_path):
    """fuse_cloud automatically switches from the level grid to the
    attitude-aware grid beyond the tilt budget (VERDICT r3 #6)."""
    from warpsense.core.config import Params
    from warpsense.pipeline.fusion_backend import (fuse_cloud,
                                                   grid_rotation_for,
                                                   sensor_tilt_deg)

    def pitched_pose_mm(deg):
        t = np.radians(deg)
        p = np.eye(4, dtype=np.float32)
        p[:3, :3] = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                              [-np.sin(t), 0, np.cos(t)]], np.float32)
        return p

    assert sensor_tilt_deg(pitched_pose_mm(12.0)) == pytest.approx(12.0)
    _, level = grid_rotation_for(pitched_pose_mm(1.5), VFOV)
    assert level
    rot, level = grid_rotation_for(pitched_pose_mm(12.0), VFOV)
    assert not level
    np.testing.assert_allclose(np.asarray(rot),
                               pitched_pose_mm(12.0)[:3, :3], atol=1e-6)

    params = Params.from_dict({
        "map": {"max_distance": 0.6, "resolution": RES, "max_weight": 32},
        "lidar": {"channels": CHANNELS, "hresolution": COLUMNS},
    })
    pts, mask, R = _pitched_scene(12.0)
    pose = pitched_pose_mm(12.0)
    out = fuse_cloud(_fresh(), pts, mask, pose, params=params, size=SIZE,
                     fusion="projective-level")
    expect = tsdf_update_projective(
        _fresh(), pts, mask, jnp.zeros(3, jnp.int32),
        jnp.asarray(pose[:3, :3]), size=SIZE, tau=TAU,
        max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
    np.testing.assert_array_equal(np.asarray(out.value),
                                  np.asarray(expect.value))


def _level_params():
    from warpsense.core.config import Params
    return Params.from_dict({
        "map": {"max_distance": TAU / 1000.0, "resolution": RES,
                "max_weight": 32},
        "lidar": {"channels": CHANNELS, "hresolution": COLUMNS},
    })


def test_level_sweep_equals_attitude_sweep_at_identity():
    """At R = I the level grid IS the sensor attitude: fuse_cloud's
    production sweep ("auto" = "projective-level") and the attitude sweep
    ("projective") must agree bit for bit, over two chained fusions."""
    from warpsense.pipeline.fusion_backend import fuse_cloud

    pts, mask = _scan_points(seed=3)
    params = _level_params()
    pose = np.eye(4, dtype=np.float32)
    pose2 = pose.copy()
    pose2[:3, 3] = [2 * RES, -RES, RES]
    out = {}
    for fusion in ("auto", "projective"):
        st = fuse_cloud(_fresh(), pts, mask, pose, params=params, size=SIZE,
                        fusion=fusion)
        out[fusion] = fuse_cloud(st, pts, mask, pose2, params=params,
                                 size=SIZE, fusion=fusion)
    np.testing.assert_array_equal(np.asarray(out["auto"].value),
                                  np.asarray(out["projective"].value))
    np.testing.assert_array_equal(np.asarray(out["auto"].weight),
                                  np.asarray(out["projective"].weight))
    assert int(np.count_nonzero(np.asarray(out["auto"].weight))) > 10000


def test_level_sweep_empty_scan_is_identity():
    """A scan with no valid return leaves the map untouched."""
    from warpsense.pipeline.fusion_backend import fuse_cloud

    pts, mask = _scan_points(seed=0)
    warm = fuse_cloud(_fresh(), pts, mask, np.eye(4, dtype=np.float32),
                      params=_level_params(), size=SIZE, fusion="auto")
    before = (np.asarray(warm.value).copy(), np.asarray(warm.weight).copy())
    after = fuse_cloud(warm, pts, jnp.zeros_like(mask),
                       np.eye(4, dtype=np.float32), params=_level_params(),
                       size=SIZE, fusion="auto")
    np.testing.assert_array_equal(np.asarray(after.value), before[0])
    np.testing.assert_array_equal(np.asarray(after.weight), before[1])


def test_level_sweep_tall_window():
    """The level sweep takes windows taller than 256 voxels (z = 300): it
    fuses the same cells as a 101-voxel-tall window that already holds
    the whole scene (BoxWorld spans z in [-2, 3] m), plus only the tau
    band behind the ceiling that the short window cuts off."""
    from warpsense.pipeline.fusion_backend import fuse_cloud

    tall, short = (251, 251, 300), (251, 251, 101)
    pts, mask = _scan_points(seed=4)
    params = _level_params()
    out = {}
    for size in (tall, short):
        out[size] = fuse_cloud(create_state(size, TAU, 0, xp=jnp,
                                            force_odd=False),
                               pts, mask, np.eye(4, dtype=np.float32),
                               params=params, size=size, fusion="auto")
    tv, tw = np.asarray(out[tall].value), np.asarray(out[tall].weight)
    sv, sw = np.asarray(out[short].value), np.asarray(out[short].weight)
    assert tw.shape == tall
    # both windows are centered on the origin: global z = index - s // 2
    cz = tall[2] // 2 - short[2] // 2
    np.testing.assert_array_equal(tw[:, :, cz:cz + short[2]], sw)
    np.testing.assert_array_equal(tv[:, :, cz:cz + short[2]], sv)
    # beyond the short window only the tau band behind the ceiling fuses
    band = -(-TAU // RES)
    assert tw[:, :, cz + short[2]:].any()
    assert not tw[:, :, :cz - band].any()
    assert not tw[:, :, cz + short[2] + band:].any()
    zs = np.nonzero(sw.any(axis=(0, 1)))[0]
    # floor at -2 m and ceiling at +3 m: 78 voxels apart at 64 mm
    assert zs.max() - zs.min() > 70, (zs.min(), zs.max())


def test_projective_reference_matches_level_sweep():
    """The float64 host twin of the per-voxel rule (tsdf_reference.
    projective_reference) reproduces the XLA level sweep on every voxel
    whose decisions are clear of float32 rounding — the oracle the
    on-card parity check uses to explain any backend difference."""
    from warpsense.map.local_map import in_bounds
    from warpsense.ops.tsdf_reference import projective_reference

    pts, mask = _scan_points(seed=6)
    eye = jnp.eye(3, dtype=jnp.float32)
    out = tsdf_update_projective(
        _fresh(), pts, mask, jnp.zeros(3, jnp.int32), eye, size=SIZE,
        tau=TAU, max_weight=32 * WEIGHT_RESOLUTION, resolution=RES,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
    scanner_mm = np.full(3, RES // 2)
    keep = mask & in_bounds(jnp.floor_divide(pts, RES),
                            jnp.zeros(3, jnp.int32), jnp.asarray(SIZE),
                            -(TAU // RES // 2))
    rng_tab, endpoint = build_beam_table(
        pts, keep, jnp.asarray(scanner_mm, jnp.int32), eye,
        channels=CHANNELS, columns=COLUMNS, vfov_deg=VFOV)
    # fresh window: pos 0, offset s // 2 -> global = index - s // 2
    idx = np.indices(SIZE).reshape(3, -1).T
    v, w, mg = projective_reference(
        idx - np.asarray(SIZE) // 2, scanner_mm, np.asarray(rng_tab),
        np.asarray(endpoint), tau=TAU, resolution=RES, channels=CHANNELS,
        columns=COLUMNS, vfov_deg=VFOV)
    with np.errstate(invalid="ignore"):
        clear = ((mg["bins"].min(axis=1) > 1e-3)
                 & (np.nan_to_num(mg["mm"], nan=np.inf).min(axis=1) > 0.05)
                 & (mg["weight"] > 1e-3))
    # the scanner's own ring boundary plane (elevation 0 falls exactly
    # between two rings) is the bulk of the knife edges
    assert clear.mean() > 0.95
    got_v = np.asarray(out.value).reshape(-1)
    got_w = np.asarray(out.weight).reshape(-1)
    np.testing.assert_array_equal(got_w[clear], w[clear])
    np.testing.assert_array_equal(got_v[clear],
                                  np.where(w != 0, v, TAU)[clear])
    assert int(np.count_nonzero(w[clear])) > 10000
