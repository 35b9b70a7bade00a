"""Render driver: pixel wavefront generation, sample accumulation, tiling.

The replacement for ``render()`` (lib/core/render.rs:61-127).  The
rayon per-pixel fan-out becomes a dense ray wavefront: the pixel and
sample-per-pixel axes are FOLDED INTO ONE ray batch dimension (samples are
embarrassingly parallel — the reference loops them sequentially per pixel,
lib/core/render.rs:86-100), traced by the wavefront integrator, then
mean-reduced over spp.

Per-pixel semantics matched to calculate_pixel (lib/core/render.rs:75-111):
  * jittered UV: u = (x + U)/ (w-1), v = (y + U)/(h-1)
  * per-SAMPLE firefly clamp to [0, clamp_indirect] BEFORE averaging
  * gamma 2 (sqrt of the mean) at the end
  * RGBA8 write with saturating cast

Large frames are tiled with ``lax.map`` over a static tile count — one
compile, sequential tile execution, bounded memory (the brute-force
intersector materializes an (R, N) t-matrix per bounce).
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..models.scene import Scene
from ..utils import color as color_mod
from ..utils import rng
from .integrator import JITTER_STREAM, trace_paths

def default_tile_rays(scene: Scene) -> int:
    """Rays per lax.map tile: as large as the brute-force (R, N) t-matrix
    allows (target ~256 MB of intermediates), clamped to [2^13, 2^20].  Big
    tiles amortize per-step overhead."""
    n = max(scene.num_primitives, 1)
    budget_elems = 1 << 26
    return int(min(max(budget_elems // n, 8192), 1 << 20))


def pixel_radiance(scene: Scene, pixel_ids, width: int, height: int, key):
    """Mean clamped radiance for a batch of pixels -> (P, 3).

    ``pixel_ids``: (P,) flat pixel indices (y * width + x).  Every
    (pixel, sample) pair becomes one ray; RNG is keyed by the global
    (pixel * spp + sample) id so results are independent of batching/tiling/
    sharding (SURVEY.md Q10 fix).
    """
    spp = scene.settings.samples_per_pixel
    return sample_radiance(scene, pixel_ids, width, height, key,
                           sample_offset=0, n_samples=spp).mean(axis=1)


def sample_radiance(scene: Scene, pixel_ids, width: int, height: int, key,
                    *, sample_offset, n_samples: int):
    """Per-sample clamped radiance -> (P, n_samples, 3) for samples
    [sample_offset, sample_offset + n_samples) of each pixel.

    The RNG counter is the GLOBAL ray id (pixel * spp + global sample index),
    so a sample-sharded render (parallel/distributed.py) produces bitwise the
    same per-sample values as the single-device path.  ``sample_offset`` may
    be a traced scalar (e.g. ``axis_index`` inside shard_map)."""
    spp = scene.settings.samples_per_pixel
    p = pixel_ids.shape[0]

    sample_ids = sample_offset + jnp.arange(n_samples)
    ray_ids = pixel_ids[:, None] * spp + sample_ids[None, :]  # (P, S)
    ray_ids = ray_ids.reshape(-1)
    pid = jnp.repeat(pixel_ids, n_samples)
    x = (pid % width).astype(jnp.float32)
    y = (pid // width).astype(jnp.float32)

    jitter = rng.ray_uniforms(key, ray_ids, JITTER_STREAM, 2)
    u = (x + jitter[:, 0]) / (width - 1)
    v = (y + jitter[:, 1]) / (height - 1)

    o, d = scene.camera.get_rays(u, v)
    radiance = trace_paths(scene, o, d, key, ray_ids)

    # firefly clamp per sample (lib/core/render.rs:95-97); the mean over
    # samples happens in the caller (possibly as a cross-device collective)
    radiance = jnp.clip(radiance, 0.0, scene.settings.clamp_indirect)
    return radiance.reshape(p, n_samples, 3)


@partial(jax.jit, static_argnames=("width", "height", "tile_pixels"))
def _render_tiled(scene: Scene, width: int, height: int, tile_pixels: int,
                  key):
    n_pixels = width * height
    n_tiles = math.ceil(n_pixels / tile_pixels)
    padded = n_tiles * tile_pixels
    pixel_ids = jnp.arange(padded, dtype=jnp.int32) % n_pixels  # pad wraps
    tiles = pixel_ids.reshape(n_tiles, tile_pixels)

    mean = jax.lax.map(
        lambda ids: pixel_radiance(scene, ids, width, height, key), tiles
    )
    return mean.reshape(padded, 3)[:n_pixels].reshape(height, width, 3)


@partial(jax.jit,
         static_argnames=("width", "height", "kinds", "interpret"))
def _render_pallas(scene: Scene, width: int, height: int, iparams,
                   kinds: tuple, interpret: bool):
    from ..ops.pallas_megakernel import pixel_radiance_pallas

    pixel_ids = jnp.arange(width * height, dtype=jnp.int32)
    mean = pixel_radiance_pallas(scene, pixel_ids, width, height, iparams,
                                 kinds=kinds, interpret=interpret)
    return mean.reshape(height, width, 3)


def resolve_engine(scene: Scene, engine: str = "auto", *,
                   use: str = "render") -> tuple[str, bool]:
    """-> (engine, interpret): the one place the platform picks an engine.

    ``use`` is "render" (a forward image, possibly differentiated) or
    "fit" (a loss under ``value_and_grad``; the kernel's grad envelope).

    * "xla" always passes through;
    * "pallas" runs the sphere kernel compiled for the GPU, or in the
      Pallas interpreter on the CPU (the tests); any other platform, or a
      scene outside the kernel's envelope, raises;
    * "auto" picks the kernel only on a GPU and only within its envelope
      for the use, where it beat the XLA engine on an H100 (PERF.md,
      "Findings").  Everything else runs on XLA.
    """
    from ..ops import pallas_megakernel as PK

    platform = jax.devices()[0].platform
    fits = PK.supports_grad if use == "fit" else PK.supports
    if engine == "xla":
        return "xla", False
    if engine == "pallas":
        if platform not in ("gpu", "cpu"):
            raise ValueError(
                f"engine='pallas' needs a GPU (or the CPU interpreter); "
                f"the platform is {platform!r}")
        if not fits(scene):
            raise ValueError("scene is outside the sphere kernel's envelope "
                             "(ops/pallas_megakernel.supports); use "
                             "engine='xla'")
        return "pallas", platform == "cpu"
    if engine != "auto":
        raise ValueError(f"unknown engine {engine!r}")
    if platform == "gpu" and fits(scene):
        return "pallas", False
    return "xla", False


def select_engine(scene: Scene, engine: str, *, use: str = "render") -> str:
    """The engine :func:`resolve_engine` picks, by name."""
    return resolve_engine(scene, engine, use=use)[0]


def make_pixel_radiance(scene: Scene, width: int, height: int,
                        engine: str = "auto", *, use: str = "render"):
    """Engine-resolved per-pixel radiance closure for sharded callers.

    Resolves ``engine`` against the CONCRETE scene (static kind tuples are
    extracted here, outside any trace) and returns ``(fn, resolved)`` where
    ``fn(scene, pixel_ids, key, sample_offset=0, n_samples=None)`` computes
    the (P, 3) mean clamped radiance over the LOCAL sample slice and is
    safe to call with a traced scene inside jit / shard_map.  Every shard
    runs the engine the single-device path would (parallel/distributed.py).
    """
    resolved, interpret = resolve_engine(scene, engine, use=use)

    if resolved == "pallas":
        from ..ops.pallas_megakernel import (pixel_radiance_pallas,
                                             sphere_kinds)

        kinds = sphere_kinds(scene)

        def fn(scene, pixel_ids, key, sample_offset=0, n_samples=None):
            return pixel_radiance_pallas(
                scene, pixel_ids, width, height,
                jnp.asarray(key).astype(jnp.int32), kinds=kinds,
                interpret=interpret, sample_offset=sample_offset,
                n_samples=n_samples)

        return fn, resolved

    def fn(scene, pixel_ids, key, sample_offset=0, n_samples=None):
        key = jnp.asarray(key).astype(jnp.uint32)
        if n_samples is None:
            return pixel_radiance(scene, pixel_ids, width, height, key)
        return sample_radiance(scene, pixel_ids, width, height, key,
                               sample_offset=sample_offset,
                               n_samples=n_samples).mean(axis=1)

    return fn, resolved


def render_linear(scene: Scene, width: int, height: int, *, seed: int = 0,
                  key=None, tile_rays: int | None = None,
                  engine: str = "auto") -> jnp.ndarray:
    """Full frame -> (H, W, 3) f32 MEAN radiance (clamped, pre-gamma).

    This is the differentiable quantity — inverse rendering optimizes
    against it (gamma/u8 quantization stay out of the loss).

    ``engine``: "auto", "pallas" or "xla" (:func:`resolve_engine`).  The
    engines consume identical RNG streams; images agree to f32
    arithmetic-order noise.

    ``key``: optional (2,) threefry key words (rng.base_key) overriding
    ``seed``.  Because the key is an ARRAY input it may be traced — per-step
    reseeding inside a jitted optimization loop never recompiles.
    """
    if key is None:
        key = rng.base_key(seed)
    key = jnp.asarray(key)
    resolved, interpret = resolve_engine(scene, engine)
    if resolved == "pallas":
        from ..ops.pallas_megakernel import sphere_kinds

        return _render_pallas(scene, width, height, key.astype(jnp.int32),
                              sphere_kinds(scene), interpret)
    spp = scene.settings.samples_per_pixel
    if tile_rays is None:
        tile_rays = default_tile_rays(scene)
    tile_pixels = max(1, tile_rays // max(spp, 1))
    tile_pixels = min(tile_pixels, width * height)
    return _render_tiled(scene, width, height, tile_pixels,
                         key.astype(jnp.uint32))


def render(scene: Scene, width: int, height: int, *, seed: int = 0,
           tile_rays: int | None = None, engine: str = "auto") -> np.ndarray:
    """Full frame -> (H, W, 4) u8 RGBA, gamma-corrected — the
    ``RenderTarget`` byte layout (lib/core/render.rs:14-30, 103-110)."""
    mean = render_linear(scene, width, height, seed=seed,
                         tile_rays=tile_rays, engine=engine)
    gamma = jnp.sqrt(jnp.maximum(mean, 0.0))
    return np.asarray(color_mod.to_rgba8(gamma))
