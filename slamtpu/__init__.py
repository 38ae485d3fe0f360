"""slamtpu — a JAX/XLA/Pallas LiDAR-inertial SLAM framework.

Re-designed from scratch with the capabilities of the reference C++ stack
khalisfadil/slam-sam (Ouster + GNSS/INS decoding, NDT voxel-hash Gaussian maps,
Newton / Stein-Variational-Newton NDT registration, IMU preintegration and
factor-graph fusion), expressed as pure fixed-shape array programs.
"""

__version__ = "0.1.0"

import jax as _jax

# GPU float32 matmuls may run in TF32 (about three decimal digits), which
# corrupts SE(3) chains and least-squares solves. SLAM geometry needs true
# float32 everywhere; the registration hot path is bound by memory traffic,
# not by the tensor cores, so this costs little.
_jax.config.update("jax_default_matmul_precision", "highest")
