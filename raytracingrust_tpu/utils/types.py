"""Scalar/array type conventions for the whole framework.

The reference tracer is entirely f32 (``lib/utils/types.rs:4-8`` defines
``Float = f32`` and cgmath f32 vectors).  We keep f32 as the canonical compute
dtype: the intersection math needs f32
precision (bf16 loses hits to catastrophic cancellation in the quadratic /
Moller-Trumbore determinants).  bf16 is used only where it is safe
(e.g. accumulation-free color math is still f32; matmul inputs stay f32 with
HIGHEST precision so no matmul runs in a reduced format such as TF32).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

Float = jnp.float32
Int = jnp.int32
NPFloat = np.float32

PI = float(np.pi)
INF = float(np.inf)

# t-interval used by the render loop, mirroring the reference's
# world.hit(ray, 0.00001, INFINITY) at lib/core/render.rs:38.
T_MIN = 1e-5

# Epsilon under which a scatter direction counts as degenerate
# (lib/utils/math.rs:6-9).
NEAR_ZERO_EPS = 1e-8


def degrees_to_radians(deg):
    """lib/utils/math.rs:32-34."""
    return deg * (PI / 180.0)


def radians_to_degrees(rad):
    """lib/utils/math.rs:37-39."""
    return rad * (180.0 / PI)
