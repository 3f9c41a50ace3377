"""orbslam3_tpu: visual-inertial SLAM engine in JAX (ORB-SLAM3 V1.0 design).

Feature-parity target: ORB-SLAM3 V1.0 (reference fork geoeo/ORB_SLAM3_V1.0);
see SURVEY.md for the component map.
"""

import os

import jax

# Persistent compilation cache.  JAX reads JAX_COMPILATION_CACHE_DIR itself;
# when it is unset the cache lives at a fixed path inside the checkout (the
# path is part of each entry's key, so a moving directory would never hit).
CACHE_DIR_DEFAULT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    jax.config.update("jax_compilation_cache_dir", CACHE_DIR_DEFAULT)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

__version__ = "0.1.0"
