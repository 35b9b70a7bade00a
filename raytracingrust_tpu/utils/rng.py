"""Counter-based, shard-invariant random number generation.

The reference uses unseeded per-OS-thread ``thread_rng`` everywhere
(lib/core/render.rs:80, lib/materials.rs:127,151, lib/volume.rs:57,
lib/utils/sample.rs:59-79), so its renders are not reproducible (SURVEY.md
quirk Q10).  Here every draw is a pure function of ``(seed, ray_id, stream,
column)``: one threefry-2x32 cipher invocation with the 64-bit seed as the
key and ``(ray_id, stream*CIPHER_BLOCK + column/2)`` as the 64-bit counter
yields TWO 32-bit words = two U[0,1) values.  Renders are bit-identical
across reruns AND across device-mesh layouts (a ray's randomness depends only
on its global id, never on which chip traced it), and the XLA integrator and
the Pallas megakernel consume byte-identical uniforms because both call THIS
module's cipher.

This layout costs ceil(n/2) ciphers per (ray, stream) — the jax.random
equivalent (fold_in per ray + fold_in per stream + one cipher per element of
``uniform(key, (n,))``) costs n + 2.  The cipher is most of the per-bounce
arithmetic, so the counter layout AND the 13-round strength (see
THREEFRY_ROUNDS) are direct rays/s wins.

Distribution parity with the reference samplers (lib/utils/sample.rs):
  * ``sample_unit_sphere_surface`` — rejection-sample a cube, keep |v|<=1,
    normalize.  Uniform on S^2; we generate it directly from (z, phi).
  * ``sample_unit_sphere_volume`` — rejection-sample, keep |v|<=1.  Uniform
    in the ball; we generate it as surface * r where r = U^(1/3).
The distributions are identical; the draws are not bitwise identical to Rust
(impossible anyway given the unseeded reference RNG).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .types import PI

# Counter layout: x1 = stream * CIPHER_BLOCK + cipher_index.  Bounds:
# up to 2*CIPHER_BLOCK uniforms per (ray, stream) and 2^32/CIPHER_BLOCK
# streams (jitter + one per bounce; depth caps at 50 in the reference GUI).
CIPHER_BLOCK = 256


# Cipher strength: Threefry-2x32 with 13 rounds — Random123's published
# reduced-round variant (Salmon et al., SC'11: 13 rounds passes the full
# BigCrush battery; 20 is the crypto-margin default jax.random uses).  The
# cipher is the dominant per-bounce cost in the sphere kernel, and a
# Monte-Carlo renderer needs statistical
# quality, not a security margin — 13 rounds is a direct rays/s win on
# every engine.  Both engines share THIS function, so cross-engine
# bit-parity is preserved; goldens were regenerated with it.
THREEFRY_ROUNDS = 13

_ROTS = (13, 15, 26, 6, 17, 29, 16, 24)  # Threefry-2x32 rotation cycle


def threefry2x32(k0, k1, x0, x1, rounds: int = THREEFRY_ROUNDS):
    """Threefry-2x32, generic round count (Random123's general-R loop:
    key injections after every 4th round), written lane-wise on uint32
    arrays so it lowers identically inside Pallas kernels and XLA
    (validated against an independent NumPy implementation in
    tests/test_pallas.py; rounds=20 is bit-exact with
    jax.extend.random.threefry_2x32)."""
    rotl = lambda x, r: (x << r) | (x >> (32 - r))
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for i in range(rounds):
        r = np.uint32(_ROTS[i % 8])
        x0 = x0 + x1
        x1 = rotl(x1, r) ^ x0
        if i % 4 == 3:
            j = i // 4 + 1
            x0 = x0 + ks[j % 3]
            x1 = x1 + ks[(j + 1) % 3] + np.uint32(j)
    return x0, x1


def bits_to_uniform(bits):
    """uint32 -> f32 U[0,1) via the IEEE mantissa trick (set exponent to
    2^0, fill the 23-bit mantissa with the top random bits, subtract 1)."""
    mant = (bits >> np.uint32(9)) | np.uint32(0x3F800000)
    return jax.lax.bitcast_convert_type(mant, jnp.float32) - 1.0


def base_key(seed: int):
    """64-bit seed -> (2,) uint32 (hi, lo) cipher key words — the same word
    layout jax.random.key(seed) uses."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return jnp.array([seed >> 32, seed & 0xFFFFFFFF], jnp.uint32)


def ray_uniforms(key, ray_ids, stream, n: int):
    """(R, n) independent U[0,1) draws for one stream of a ray batch.

    ``key``: (2,) uint32 from :func:`base_key` (may be traced — re-seeding
    never recompiles).  ``ray_ids``: (R,) int32 GLOBAL ray ids.  ``stream``:
    per-use stream id (0 = pixel jitter, 1 + b = bounce b); may be traced.
    """
    n_ciphers = -(-n // 2)
    if n_ciphers > CIPHER_BLOCK:
        raise ValueError(f"{n} uniforms exceed the stream's cipher block")
    x0 = ray_ids.astype(jnp.uint32)
    k0 = jnp.broadcast_to(key[0], x0.shape)
    k1 = jnp.broadcast_to(key[1], x0.shape)
    base = jnp.asarray(stream, jnp.uint32) * np.uint32(CIPHER_BLOCK)
    cols = []
    for j in range(n_ciphers):
        x1 = jnp.broadcast_to(base + np.uint32(j), x0.shape)
        a0, a1 = threefry2x32(k0, k1, x0, x1)
        cols.append(bits_to_uniform(a0))
        cols.append(bits_to_uniform(a1))
    return jnp.stack(cols[:n], axis=-1)


def unit_sphere_surface(u1, u2):
    """Uniform direction on the unit sphere from two U[0,1) draws.

    Same distribution as ``sample_unit_sphere_surface``
    (lib/utils/sample.rs:71-79) without the rejection loop (data-dependent
    loops do not vectorize over a wavefront).
    """
    z = 1.0 - 2.0 * u1
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * PI) * u2
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def cbrt01(u):
    """cbrt on [0,1) as exp(log(u)/3) — the ONE cube-root implementation
    shared by the XLA shader and the sphere kernel (using the same
    formula in both engines keeps their isotropic scatter directions
    bit-identical).  The clamp maps u == 0 to
    ~exp(-29) instead of 0 — a 2^-32-probability draw displaced by 1e-13."""
    return jnp.exp(jnp.log(jnp.maximum(u, 1e-38)) * (1.0 / 3.0))


def unit_sphere_volume(u1, u2, u3):
    """Uniform point in the unit ball (lib/utils/sample.rs:40-57 equivalent)."""
    d = unit_sphere_surface(u1, u2)
    r = cbrt01(u3)
    return d * r[..., None]
