"""Featsense feature extraction: device op vs numpy golden twin."""
import numpy as np
import jax.numpy as jnp
import pytest

from warpsense.frontends.featsense import features as dev
from warpsense.frontends.featsense import features_reference as ref
from warpsense.io.synthetic import BoxWorld, render_scan

PARAMS = ref.FeatureParams(min_distance=0.5, max_distance=40.0,
                           edge_threshold=0.5, surf_threshold=0.05)


def synth_scan(H=16, W=256, seed=0):
    rng = np.random.default_rng(seed)
    pose = np.eye(4)
    pose[:3, 3] = [0.5, -0.3, 0.2]
    return render_scan(BoxWorld.default(), pose, channels=H, columns=W,
                       noise_std=0.002, rng=rng)


def test_curvature_and_ranges_match_twin():
    cloud = synth_scan()
    c_dev, r_dev = dev.curvature_and_ranges(jnp.asarray(cloud))
    c_ref, r_ref = ref.curvature_and_ranges(cloud)
    band = np.isfinite(c_ref)
    assert np.array_equal(band, np.isfinite(np.asarray(c_dev)))
    np.testing.assert_allclose(np.asarray(c_dev)[band], c_ref[band],
                               rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(np.asarray(r_dev)[band], r_ref[band],
                               rtol=1e-5, atol=1e-6)


def test_occlusion_mask_matches_twin():
    cloud = synth_scan(seed=3)
    _, r_ref = ref.curvature_and_ranges(cloud)
    m_ref = ref.mark_occluded(r_ref, PARAMS)
    # device op computes ranges over the full grid; the twin only fills the
    # valid band — mask comparison is restricted to marks, which only ever
    # originate from band columns in both.
    m_dev = np.asarray(dev.mark_occluded(jnp.linalg.norm(jnp.asarray(cloud),
                                                         axis=-1), PARAMS))
    mismatches = np.count_nonzero(m_dev != m_ref)
    assert mismatches == 0, f"{mismatches} occlusion-mask mismatches"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_feature_selection_matches_twin(seed):
    cloud = synth_scan(seed=seed)
    e_ref, s_ref = ref.extract_features(cloud, PARAMS)
    (e_pts, e_mask, e_idx), (s_pts, s_mask, s_idx) = dev.extract_features(
        jnp.asarray(cloud), params=PARAMS,
        edge_capacity=1024, surf_capacity=2048)
    e_set = set(np.asarray(e_idx)[np.asarray(e_mask)].tolist())
    s_set = set(np.asarray(s_idx)[np.asarray(s_mask)].tolist())
    assert len(e_ref) > 10 and len(s_ref) > 50, "scene too sparse to test"
    assert e_set == set(e_ref.tolist())
    assert s_set == set(s_ref.tolist())
    # returned points are the cloud entries at those indices
    H, W = cloud.shape[:2]
    flat = cloud.reshape(-1, 3)
    np.testing.assert_array_equal(
        np.asarray(e_pts)[np.asarray(e_mask)],
        flat[np.asarray(e_idx)[np.asarray(e_mask)]])


def test_capacity_truncation():
    cloud = synth_scan(seed=1)
    (e_pts, e_mask, _), _ = dev.extract_features(
        jnp.asarray(cloud), params=PARAMS, edge_capacity=4, surf_capacity=8)
    assert e_pts.shape == (4, 3)
    assert int(np.asarray(e_mask).sum()) <= 4
