"""Differentiable rendering: parameter plumbing + loss/grad helpers.

The renderer is an ordinary JAX program over the Scene pytree, so
``jax.grad`` works directly; this module provides the bookkeeping for
selecting WHICH leaves are trainable (BASELINE.json north star: material
albedo / fuzz / ir, emission, camera pose/FoV, background colors) and
swapping them into a base scene.

Gradient estimator: reparameterized path gradients with detached discrete
events (fixed-seed uniforms are constants, sampled directions are smooth in
the parameters) — AD matches finite differences of the fixed-seed renderer
away from visibility/branch discontinuities; geometry-edge (silhouette)
gradients are out of scope (SURVEY.md section 7 hard part b).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..render.render import render_linear

# Trainable leaf names -> (sub-pytree, field) paths
PARAM_PATHS = {
    "albedo": ("materials", "albedo"),
    "fuzz": ("materials", "fuzz"),
    "ir": ("materials", "ir"),
    "emission": ("materials", "emission"),
    "mix_factor": ("materials", "mix_factor"),
    "bg_color_a": ("background", "color_a"),
    "bg_color_b": ("background", "color_b"),
    "cam_lookfrom": ("camera", "lookfrom"),
    "cam_lookat": ("camera", "lookat"),
    "cam_up": ("camera", "vertical"),
    "cam_fov": ("camera", "vertical_fov"),
    "sphere_center": ("spheres", "center"),
    "sphere_radius": ("spheres", "radius"),
}


def extract_params(scene: Scene, names: Iterable[str]) -> dict:
    """Pull the selected trainable leaves out of a scene -> params dict."""
    out = {}
    for name in names:
        sub, field = PARAM_PATHS[name]
        out[name] = getattr(getattr(scene, sub), field)
    return out


def apply_params(scene: Scene, params: dict) -> Scene:
    """Swap trainable leaves back into the scene pytree."""
    by_sub: dict[str, dict] = {}
    for name, value in params.items():
        sub, field = PARAM_PATHS[name]
        by_sub.setdefault(sub, {})[field] = value
    for sub, fields in by_sub.items():
        scene = dataclasses.replace(
            scene, **{sub: dataclasses.replace(getattr(scene, sub), **fields)}
        )
    return scene


def make_loss(scene: Scene, target, width: int, height: int, *,
              seed: int = 0, tile_rays: int = 1 << 16,
              engine: str = "auto", mesh=None):
    """-> loss(params, key=None) = mean squared error against ``target``
    (H, W, 3) linear radiance.  Differentiable in every PARAM_PATHS leaf
    present in ``params``.

    ``engine`` resolves with ``render.resolve_engine(use="fit")``: "auto"
    takes the sphere kernel on a GPU when the scene is in its grad
    envelope, whose fused render->MSE->grad kernel makes one
    ``value_and_grad`` step one kernel launch.  ``key`` (optional (2,)
    threefry key words) overrides ``seed`` and may be traced: the fit loop
    reseeds per step without recompiling.

    ``mesh``: a ``jax.sharding.Mesh`` — the loss shards its rays over the
    mesh's first axis with the scene/params replicated; ``jax.grad``'s
    parameter cotangents are psum'd over the devices (over NVLink on a
    multi-GPU host; the BASELINE.json north star's "all-reducing parameter
    gradients" collective).  Because the
    RNG is counter-based over GLOBAL ray ids, the sharded loss equals the
    single-device loss to f32 reduction order for any mesh size
    (tests/test_sharded_fit.py).
    """
    from ..render.render import resolve_engine

    target = jnp.asarray(target)
    engine, interpret = resolve_engine(scene, engine, use="fit")
    if mesh is not None:
        return _make_loss_sharded(scene, target, width, height, seed=seed,
                                  engine=engine, mesh=mesh)

    # Fused render->MSE->grad kernel (ops/pallas_megakernel.mse_loss_pallas):
    # one kernel pass per value_and_grad step instead of forward + backward.
    # Off its gate (skymap, spp > 256) the two-pass kernel path runs.
    if engine == "pallas":
        from ..ops.pallas_megakernel import (mse_loss_pallas, sphere_kinds,
                                             supports_fused_mse)
        from ..utils import rng as _rng

        if supports_fused_mse(scene) and target.shape == (height, width, 3):
            kinds = sphere_kinds(scene)

            def loss(params: dict, key=None):
                s = apply_params(scene, params)
                k = _rng.base_key(seed) if key is None else jnp.asarray(key)
                return mse_loss_pallas(s, target, width, height,
                                       k.astype(jnp.int32), kinds=kinds,
                                       interpret=interpret)

            return loss

    def loss(params: dict, key=None):
        s = apply_params(scene, params)
        img = render_linear(s, width, height, seed=seed, key=key,
                            tile_rays=tile_rays, engine=engine)
        return jnp.mean((img - target) ** 2)

    return loss


def _make_loss_sharded(scene: Scene, target, width: int, height: int, *,
                       seed: int, engine: str, mesh):
    """The multi-device fit loss: rays sharded, scene/params replicated.

    Every shard runs the engine the single-device fit would (the sphere
    kernel's two-pass custom_vjp, or XLA — render.make_pixel_radiance).
    The kernel engine runs inside one ``shard_map`` whose output is the
    global masked SSE via an explicit ``psum``; the backward of the
    replicated (P()) scene input is itself a psum over the mesh, so the
    gradient all-reduce needs no hand-written collective.

    The single-device fused render->MSE->grad kernel computes the WHOLE
    frame's loss in one launch and therefore stays a 1-device fast path;
    per shard this path runs the (two-pass) radiance custom_vjp + XLA MSE,
    which is the same kernel family at one extra elementwise pass.
    """
    import math as _math
    from functools import partial as _partial

    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..parallel.sharding import RAY_AXIS, replicate_scene
    from ..render.render import make_pixel_radiance
    from ..utils import rng as _rng

    n_dev = mesh.devices.size
    n_pixels = width * height
    padded = _math.ceil(n_pixels / n_dev) * n_dev
    ids_np = np.arange(padded, dtype=np.int32) % n_pixels  # pad wraps
    # wrapped pad pixels are masked out of the SSE so the sharded loss is
    # EXACTLY the single-device mean over n_pixels * 3 terms
    w_np = (np.arange(padded) < n_pixels).astype(np.float32)

    radiance_fn, resolved = make_pixel_radiance(scene, width, height,
                                                engine, use="fit")

    ray_sh = NamedSharding(mesh, P(RAY_AXIS))
    ids_d = jax.device_put(ids_np, ray_sh)
    w_d = jax.device_put(w_np, ray_sh)
    tgt_d = jax.device_put(
        np.asarray(target, np.float32).reshape(n_pixels, 3)[ids_np], ray_sh)
    scene_r = replicate_scene(scene, mesh)

    if resolved == "xla":
        # GSPMD path: ONE global trace regardless of mesh size (the
        # sharded inputs' NamedSharding propagates through the jitted fit
        # step), so per-ray arithmetic — and therefore every borderline
        # branch — is identical for any decomposition; the gradient psum
        # is inserted automatically for the replicated params.  A
        # shard_map here would re-trace at the LOCAL shard shape and let
        # fusion flip ulp-borderline paths between mesh sizes (measured:
        # 4/133 pixels on a 19x7 frame).
        def loss(params: dict, key=None):
            s = apply_params(scene_r, params)
            k = _rng.base_key(seed) if key is None else jnp.asarray(key)
            img = radiance_fn(s, ids_d, k)  # (padded, 3)
            return (jnp.sum(((img - tgt_d) ** 2) * w_d[:, None])
                    / (n_pixels * 3))

        return loss

    @_partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=P(),
        # pallas_call outputs carry no vma annotation (see
        # parallel/distributed.py); the psum below is the only
        # cross-shard dataflow and is explicit.  Kernel engines are safe
        # under shard_map's local-shape retrace: they tile rays into
        # fixed blocks, so per-ray arithmetic never depends on the batch
        # size.
        check_vma=False,
    )
    def global_sse(s, ids, tgt, w, key):
        img = radiance_fn(s, ids, key)  # (local, 3)
        sse = jnp.sum(((img - tgt) ** 2) * w[:, None])
        return jax.lax.psum(sse, RAY_AXIS)

    def loss(params: dict, key=None):
        s = apply_params(scene_r, params)
        k = _rng.base_key(seed) if key is None else jnp.asarray(key)
        return global_sse(s, ids_d, tgt_d, w_d, k) / (n_pixels * 3)

    return loss


def render_and_grad(scene: Scene, target, names, width: int, height: int,
                    *, seed: int = 0, engine: str = "auto", mesh=None):
    """Convenience: (loss value, grads dict) for the selected params."""
    loss = make_loss(scene, target, width, height, seed=seed, engine=engine,
                     mesh=mesh)
    params = extract_params(scene, names)
    return jax.value_and_grad(loss)(params)
