"""psgradientsdf — dense RGB-D reconstruction engine on JAX/XLA.

A from-scratch JAX/XLA re-design of the PSgradientSDF pipeline
(WACV 2023: "High-Quality RGB-D Reconstruction via Multi-View Uncalibrated
Photometric Stereo and Gradient-SDF"; reference C++ at /root/reference):

  1. SDF-based rigid camera tracking (Gauss-Newton on a point-to-SDF objective)
  2. Gradient-SDF volumetric fusion (per-voxel distance + gradient + color)
  3. Keyframe selection by image sharpness
  4. Joint photometric refinement of distance / albedo / lighting / pose
     (SH order-1/2 per-keyframe lighting, or a global RGB LED point light)
  5. Mesh / point-cloud / SDF / trajectory export

Design stance (accelerator-first, not a port):
  * voxel payload is SoA: dist[Z,Y,X], grad[Z,Y,X,3], weight[Z,Y,X],
    albedo[Z,Y,X,3] and bit-packed visibility — dense, statically shaped,
    XLA-tileable (vs. the reference's AoS SdfVoxel* + ragged vector<bool>,
    cpp/include/sdf_tracker/VolumetricGradSdf.h:40-42).
  * every hot loop is a jitted dense kernel: fusion is an elementwise
    gather over the whole grid, tracking is a masked per-pixel reduction,
    refinement residuals are a (surface-voxel x keyframe) batched kernel.
  * multi-chip scaling via jax.sharding.Mesh + shard_map: Z-slab grid
    partition, psum for Gauss-Newton normal-equation reductions, halo
    exchange for finite-difference stencils.
"""

__version__ = "0.1.0"

import jax as _jax

# Geometry/GN math (3x3 rotations, 6x6 and 8x8 normal equations, the JᵀWJ
# matvecs of the refinement solves) is precision-critical.  On the GPU XLA
# may run a float32 matmul/einsum in TF32 (about 10 mantissa bits), which
# costs pose accuracy and breaks parity with the float32 references.  Pin
# full float32 products globally; the few genuinely large matmuls in this
# engine are reductions that want exact float32 anyway.
_jax.config.update("jax_default_matmul_precision", "highest")

from psgradientsdf.config import PipelineConfig, load_config  # noqa: F401
