"""Test environment: the CPU backend with an 8-device virtual mesh, so the
multi-device sharding paths are exercised without accelerators.  The
platform is chosen through jax.config before first backend use, so it
holds whatever JAX_PLATFORMS says.  On-card checks live in chip_smoke.py.
"""
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
