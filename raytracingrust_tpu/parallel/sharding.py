"""Multi-device rendering: rays sharded over a device mesh.

The reference's parallelism is a rayon thread pool fanning one task per pixel
on shared memory (lib/core/render.rs:113-126).  The device equivalent
(SURVEY.md section 2.6): shard the RAY axis across a 1-D
``jax.sharding.Mesh`` over every device (the GPUs of one host are joined
all to all by NVLink, so the mesh follows the algorithm alone), replicate
the scene (BVH + primitives + materials — they are read-only, the analog
of rayon's ``&Scene``), and let each device trace its own pixel slice.

Collectives:
  * forward — none needed per se (the image tiles are disjoint); the output
    is gathered only at the host edge.
  * backward (inverse rendering) — scene-parameter gradients are partial sums
    per device; jax.grad of the pjit'd loss inserts the psum over NVLink
    automatically because the params are replicated.

Everything goes through ``jax.jit`` with explicit in/out shardings (pjit);
``shard_map`` is reserved for the Pallas collective kernels.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.scene import Scene
from ..utils import color as color_mod
from ..utils import rng

RAY_AXIS = "rays"


def make_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name 'rays'."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, (RAY_AXIS,))


def replicate_scene(scene: Scene, mesh: Mesh) -> Scene:
    """Place every scene array replicated over the mesh (TP analog: the scene
    is the 'model', and it is fully replicated — SURVEY.md 2.6)."""
    repl = NamedSharding(mesh, P())
    return jax.tree.map(lambda x: jax.device_put(x, repl), scene)


def render_linear_sharded(scene: Scene, width: int, height: int, *,
                          mesh: Mesh | None = None, seed: int = 0,
                          engine: str = "auto"):
    """Full frame on a device mesh -> (H, W, 3) f32 mean radiance.

    Pixels are padded to a multiple of the mesh size and sharded along the
    ray axis; the per-ray RNG is keyed by global pixel id, so the result is
    bitwise identical for ANY mesh size (shard-invariance test in
    tests/test_sharding.py).

    Each shard runs the same engine the single-device path would pick
    (render.make_pixel_radiance): on GPUs the sphere kernel executes per
    device inside shard_map when the scene qualifies.
    """
    from ..render.render import make_pixel_radiance

    mesh = mesh or make_mesh()
    n_dev = mesh.devices.size
    n_pixels = width * height
    padded = math.ceil(n_pixels / n_dev) * n_dev
    pixel_ids = np.arange(padded, dtype=np.int32) % n_pixels

    # engine + static kind tuples resolve against the CONCRETE scene here —
    # inside shard_map the scene leaves are traced
    radiance_fn, resolved = make_pixel_radiance(scene, width, height, engine)

    sharding = NamedSharding(mesh, P(RAY_AXIS))
    pixel_ids = jax.device_put(pixel_ids, sharding)
    scene = replicate_scene(scene, mesh)

    if resolved == "pallas":
        fn = jax.jit(jax.shard_map(
            lambda scene, ids, key: radiance_fn(scene, ids, key),
            mesh=mesh,
            in_specs=(P(), P(RAY_AXIS), P()),
            out_specs=P(RAY_AXIS),
            # pallas_call outputs carry no vma annotation; the shards
            # never exchange data
            check_vma=False,
        ))
    else:
        fn = jax.jit(
            lambda scene, ids, key: radiance_fn(scene, ids, key),
            in_shardings=(None, sharding, None),
            out_shardings=sharding,
        )
    out = fn(scene, pixel_ids, rng.base_key(seed))
    out = np.asarray(out)[:n_pixels]
    return out.reshape(height, width, 3)


def render_sharded(scene: Scene, width: int, height: int, *,
                   mesh: Mesh | None = None, seed: int = 0) -> np.ndarray:
    """Sharded render -> (H, W, 4) u8 RGBA (gamma-corrected)."""
    mean = render_linear_sharded(scene, width, height, mesh=mesh, seed=seed)
    gamma = np.sqrt(np.maximum(mean, 0.0))
    return np.asarray(color_mod.np_to_rgba8(gamma))
