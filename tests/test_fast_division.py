"""Exactness guards for the fusion's numeric replacements.

_div_trunc_by_pos replaced the merge's int32 division with guarded f32
math on a proof that it is bit-identical below 2^24 — this pins the proof
with an exhaustive boundary sweep plus randomized fuzzing over the real
merge operand ranges.
"""
import numpy as np

import jax.numpy as jnp

from warpsense.ops.tsdf_projective import _div_trunc_by_pos
from warpsense.core.geometry import div_trunc


def test_div_trunc_by_pos_matches_int_division_fuzz():
    rng = np.random.default_rng(0)
    # the merge's real envelope: |a| <= 2*tau*max_weight, 1 <= b <= 2112
    a = rng.integers(-2_500_000, 2_500_000, 200_000).astype(np.int32)
    b = rng.integers(1, 2112, 200_000).astype(np.int32)
    got = np.asarray(_div_trunc_by_pos(jnp.asarray(a), jnp.asarray(b)))
    want = np.asarray(div_trunc(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def test_div_trunc_by_pos_integer_boundaries():
    # quotients exactly at integer boundaries are where a rounded f32
    # division could fall on the wrong side without the correction step
    qs = np.arange(1, 4000, dtype=np.int64)
    bs = np.arange(1, 2112, 97, dtype=np.int64)
    a_list, b_list = [], []
    for b in bs:
        a_list.append(qs * b)            # exact multiples
        a_list.append(qs * b - 1)        # one below
        a_list.append(qs * b + 1)        # one above
        b_list.extend([np.full_like(qs, b)] * 3)
    a = np.clip(np.concatenate(a_list), -(2 ** 23), 2 ** 23).astype(np.int32)
    b = np.concatenate(b_list).astype(np.int32)
    got = np.asarray(_div_trunc_by_pos(jnp.asarray(a), jnp.asarray(b)))
    want = np.asarray(div_trunc(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    # negative side
    got = np.asarray(_div_trunc_by_pos(jnp.asarray(-a), jnp.asarray(b)))
    want = np.asarray(div_trunc(jnp.asarray(-a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)


def test_resolve_fusion_dispatch():
    from warpsense.pipeline.fusion_backend import resolve_fusion

    # explicit names pass through untouched
    for name in ("raymarch", "projective", "projective-level"):
        assert resolve_fusion(name) == name
    # auto is the level sweep on every backend, window and sensor —
    # windows taller than 256 voxels included
    assert resolve_fusion("auto") == "projective-level"
