"""warpsense — a LiDAR SLAM engine in JAX/XLA, run on an NVIDIA GPU.

Brand-new implementation of the capabilities of juliangaal/warpsense
(HATSDF-SLAM point-to-TSDF registration + TSDF fusion, F-LOAM-style
featsense odometry, chunked persistent global map).
"""
import jax as _jax

# SLAM math (Rodrigues, 6x6 solves, covariance fits) is precision-sensitive:
# a GPU's default float32 matmul may run in TF32 (~3 decimal digits), which
# loses ~1e-3 on 3x3 products.  Every product runs at full float32.
_jax.config.update("jax_default_matmul_precision", "highest")

__version__ = "0.1.0"
