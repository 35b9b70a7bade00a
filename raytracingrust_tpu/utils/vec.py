"""Vector math over ``(..., 3)`` arrays.

Batched replacement for the reference's cgmath-based scalar vector layer
(``lib/utils/{vector,math}.rs``): every op is batched and shape-polymorphic so
the integrator can work on whole ray wavefronts at once instead of one
ray at a time.
"""

from __future__ import annotations

import jax.numpy as jnp

from .types import NEAR_ZERO_EPS


def dot(a, b):
    """Batched dot product over the trailing xyz axis -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def length_squared(v):
    return jnp.sum(v * v, axis=-1)


def length(v):
    return jnp.sqrt(length_squared(v))


def normalize(v):
    """cgmath ``normalize`` semantics: v / |v| (no epsilon guard — the
    reference happily divides by zero too; callers guard where it matters)."""
    return v / length(v)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def near_zero(v):
    """True where the vector is < 1e-8 in every coordinate
    (lib/utils/math.rs:6-9)."""
    return jnp.all(jnp.abs(v) < NEAR_ZERO_EPS, axis=-1)


def reflect(v, n):
    """Mirror ``v`` about normal ``n`` (lib/utils/math.rs:12-14)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction via perpendicular/parallel decomposition
    (lib/utils/math.rs:16-21).  ``uv`` must be unit length; ``etai_over_etat``
    broadcasts over the batch."""
    cos_theta = jnp.minimum(dot(n, -uv), 1.0)
    if jnp.ndim(etai_over_etat) < jnp.ndim(cos_theta):
        etai_over_etat = jnp.broadcast_to(etai_over_etat, cos_theta.shape)
    out_perp = etai_over_etat[..., None] * (uv + cos_theta[..., None] * n)
    # sqrt has an infinite derivative at 0 (grazing/TIR boundary); clamp the
    # radicand away from 0 so reverse-mode AD stays finite
    rad = jnp.maximum(jnp.abs(1.0 - length_squared(out_perp)), 1e-12)
    out_parallel = -jnp.sqrt(rad)[..., None] * n
    return out_perp + out_parallel


def to_spherical_coords(v):
    """Direction -> (theta, phi) with the reference's exact convention
    (lib/utils/math.rs:24-29): theta = acos(-y), phi = atan2(-z, x) + pi.
    Returns a (..., 2) array."""
    theta = jnp.arccos(jnp.clip(-v[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-v[..., 2], v[..., 0]) + jnp.pi
    return jnp.stack([theta, phi], axis=-1)
