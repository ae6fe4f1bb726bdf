"""Featsense front end: F-LOAM feature odometry + VGICP refinement.

JAX re-design of src/featsense (see each module's
docstring for the parity map)."""
from .features import extract_features
from .features_reference import FeatureParams
from .odometry import FeatureMapState, OdomEstimation, odom_update
from .vgicp import vgicp_align

__all__ = ["extract_features", "FeatureParams", "FeatureMapState",
           "OdomEstimation", "odom_update", "vgicp_align"]
