"""Wavefront path-tracing integrator.

The reference's recursive ``trace_ray`` (lib/core/render.rs:32-59) becomes an
iterative ``lax.scan`` over bounce depth on a dense wavefront of rays:

    throughput *= attenuation        (the recursion's multiply chain)
    radiance   += throughput * L     (on miss -> background; on terminal
                                      material -> its attenuation)
    depth cutoff -> contributes 0    (depth >= max_ray_depth returns black)

Dead rays stay in their lanes with masked updates — every ray of the
wavefront runs the same ops; the sphere kernel (ops/pallas_megakernel.py)
exits blocks of dead rays early instead.  The scan has
a static trip count so reverse-mode AD works (a while_loop would be faster on
early termination but is not differentiable).

Differentiability: radiance is differentiable w.r.t. material albedo / fuzz /
ir / emission, background colors, and camera parameters through the
throughput chain; sampled directions and discrete choices are detached
(detached-sampling estimator, BASELINE.json north star).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models import scene as S
from ..ops import shade as shade_ops
from ..ops.intersect import intersect_brute
from ..ops.traverse import intersect_bvh
from ..utils import rng, vec
from ..utils.types import T_MIN

# per-ray key fold_in streams: 0 = pixel jitter, 1 + b = bounce b;
# env-NEE draws for bounce b live past the bounce range so turning
# importance sampling on/off never shifts the naive path's randomness
JITTER_STREAM = 0


def bounce_stream(b):
    return 1 + b


def nee_stream(b, max_depth):
    return 1 + max_depth + b


# Below this primitive count the dense matmul intersector is used instead
# of lockstep BVH traversal (ROADMAP A4: re-measure the threshold on the
# GPU) — results are equivalent
# (tests/test_bvh.py), so honoring enable_bvh_tree only matters at scale.
BRUTE_FORCE_THRESHOLD = 256


def closest_hit(scene: S.Scene, o, d, u_vol):
    """World hit — BVH or linear scan, per settings.enable_bvh_tree
    (lib/core/render.rs:68-72), except that small scenes always take the
    dense path (see BRUTE_FORCE_THRESHOLD).  Mesh-bounded volumes need the
    whole boundary's crossing set per ray, so those scenes always take the
    dense path too (their triangle counts are modest by construction)."""
    use_bvh = (
        scene.settings.enable_bvh_tree
        and scene.bvh is not None
        and scene.num_primitives > BRUTE_FORCE_THRESHOLD
        and scene.num_mesh_volumes == 0
    )
    if use_bvh:
        return intersect_bvh(scene, o, d, u_vol, tmin=T_MIN)
    return intersect_brute(scene, o, d, u_vol, tmin=T_MIN)


def trace_paths(scene: S.Scene, o, d, key, ray_ids):
    """Trace a wavefront to completion -> per-ray radiance (R, 3).

    ``key``: (2,) uint32 seed words (rng.base_key); ``ray_ids``: (R,) global
    ray ids — together they define every uniform draw (counter-based RNG).
    """
    settings = scene.settings
    mode = settings.mode
    # free-flight uniform columns: sphere volumes first, then mesh volumes
    n_vol = scene.spheres.num_volumes + scene.num_mesh_volumes
    n_shade = shade_ops.shade_uniforms(scene.materials)
    n_uniforms = n_shade + n_vol

    if mode in (S.MODE_NORMAL, S.MODE_RANDOM):
        # single intersection, no scatter chain (lib/core/render.rs:42-49)
        if settings.max_ray_depth <= 0:
            return jnp.zeros_like(o)
        u = rng.ray_uniforms(key, ray_ids, bounce_stream(0), n_uniforms)
        hit = closest_hit(scene, o, d, u[:, n_shade:])
        bg = scene.background.sample(d)
        if mode == S.MODE_RANDOM:
            return jnp.where(hit.hit[..., None], 0.0, bg)
        ncol = 0.5 * (vec.normalize(hit.normal) + 1.0)
        return jnp.where(hit.hit[..., None], ncol, bg)

    clay = mode == S.MODE_CLAY
    # Environment importance sampling (one-sample MIS, BASELINE config #4):
    # at each diffuse hit, ALSO draw one direction proportional to sky
    # luminance x sin(theta) and trace a shadow ray; both the NEE and the
    # BSDF-sampled env contributions are balance-heuristic weighted so the
    # combined estimator stays unbiased.  Only meaningful with an HDRI sky.
    env_is = (
        settings.env_importance_sampling
        and not clay
        and scene.background.kind == 2  # backgrounds.SKYMAP
    )
    max_depth = settings.max_ray_depth

    def bounce(carry, b):
        o, d, throughput, radiance, alive, mis_pdf = carry
        u = rng.ray_uniforms(key, ray_ids, bounce_stream(b), n_uniforms)
        u_vol = u[:, n_shade:]
        hit = closest_hit(scene, o, d, u_vol)

        missed = alive & ~hit.hit
        bg_rad = scene.background.sample(d)
        if env_is:
            # MIS weight of the BSDF-sampled env hit: rays whose last
            # scatter was diffuse (mis_pdf > 0) share the env's measure
            # with the NEE sample below; specular/primary rays keep w = 1
            dn = vec.normalize(jax.lax.stop_gradient(d))
            p_env = scene.background.pdf(dn)
            w_b = jnp.where(mis_pdf > 0.0,
                            mis_pdf / (mis_pdf + p_env), 1.0)
            bg_rad = bg_rad * w_b[..., None]
        radiance = radiance + jnp.where(
            missed[..., None], throughput * bg_rad, 0.0
        )

        mat_id = shade_ops.resolve_mix(
            scene.materials, hit.material, u[:, :n_shade]
        )
        atten, new_dir, scatters = shade_ops.scatter(
            scene.materials, mat_id, d, hit.normal, hit.front_face,
            u[:, :n_shade],
            clay=clay,
        )
        # Reparameterized path gradients: sampled directions are SMOOTH
        # functions of the parameters given fixed uniforms (metal dir in
        # fuzz, dielectric refraction in ir, everything in camera pose), so
        # gradients flow through them; only discrete events (hit ids, branch
        # choices, masks) are detached.  This makes AD match finite
        # differences of the fixed-seed renderer away from discontinuities.

        terminal = alive & hit.hit & ~scatters
        radiance = radiance + jnp.where(
            terminal[..., None], throughput * atten, 0.0
        )

        cont = alive & hit.hit & scatters
        if env_is:
            from ..models import materials as M
            from ..models.backgrounds import sample_skymap_direction
            from ..utils.lookup import tgather
            from ..utils.types import PI

            kind = tgather(scene.materials.kind, mat_id)
            diffuse = cont & (kind == M.LAMBERTIAN)
            un = rng.ray_uniforms(key, ray_ids, nee_stream(b, max_depth),
                                  2 + n_vol)
            d_l, p_l = sample_skymap_direction(
                scene.background, un[:, 0], un[:, 1])
            d_l = jax.lax.stop_gradient(d_l)
            p_l = jax.lax.stop_gradient(p_l)
            cos_l = jnp.maximum(vec.dot(hit.normal, d_l), 0.0)
            shadow = closest_hit(scene, hit.point, d_l, un[:, 2:])
            # cosine-hemisphere BSDF pdf of the SAME direction (the
            # reference lambertian's n + unit-sphere sample is exactly
            # cosine-weighted) -> balance-heuristic weight
            p_b = cos_l / PI
            w_l = p_l / (p_l + p_b)
            L = scene.background.sample(d_l)
            albedo = tgather(scene.materials.albedo, mat_id)
            nee = (
                throughput * albedo * L
                * (cos_l / PI / jnp.maximum(p_l, 1e-12) * w_l)[..., None]
            )
            take = diffuse & ~shadow.hit & (cos_l > 0.0)
            radiance = radiance + jnp.where(take[..., None], nee, 0.0)

            # pdf of the direction the BSDF actually sampled, for the NEXT
            # bounce's miss weighting (0 = specular / no MIS)
            ndn = vec.normalize(jax.lax.stop_gradient(new_dir))
            cos_n = jnp.maximum(vec.dot(hit.normal, ndn), 0.0)
            mis_pdf = jnp.where(diffuse, cos_n / PI, 0.0)
            mis_pdf = jax.lax.stop_gradient(mis_pdf)

        throughput = jnp.where(cont[..., None], throughput * atten, throughput)
        o = jnp.where(cont[..., None], hit.point, o)
        d = jnp.where(cont[..., None], new_dir, d)
        return (o, d, throughput, radiance, cont, mis_pdf), None

    init = (
        o, d,
        jnp.ones_like(o),       # throughput
        jnp.zeros_like(o),      # radiance
        jnp.ones(o.shape[:-1], bool),  # alive
        jnp.zeros(o.shape[:-1]),       # mis_pdf (0 = no MIS for primaries)
    )
    # Unrolling the bounce chain lets XLA fuse across bounces instead of
    # materializing the full wavefront carry in device memory per
    # iteration.  Deep chains (the mesh bench runs depth 50) keep the scan:
    # the unrolled graph would take minutes to compile for little gain.
    if settings.max_ray_depth <= 12:
        carry = init
        for b in range(settings.max_ray_depth):
            carry, _ = bounce(carry, b)
        radiance = carry[3]
    else:
        carry, _ = jax.lax.scan(
            bounce, init, jnp.arange(settings.max_ray_depth)
        )
        radiance = carry[3]
    # rays still alive after max_ray_depth bounces contribute black
    # (lib/core/render.rs:34-36)
    return radiance
