"""Branchless material shading.

The reference's ``Material::scatter`` dynamic dispatch (lib/core/render.rs:40
-> lib/materials.rs) becomes masked evaluation of every lobe with a one-hot
blend over the material kind id — the wavefront stays fully dense
(SURVEY.md section 2.6, the expert-parallel analog).  All table lookups go
through one-hot matmuls (utils.lookup; ROADMAP A5 asks whether plain
gathers are faster on the GPU).  Semantics are lifted lobe-by-lobe from lib/materials.rs
and lib/volume.rs:75-88:

  * Lambertian — dir = normal + unit-sphere-surface sample, degenerate
    fallback to the normal, always scatters, attenuation = albedo.
  * Metal — dir = normalize(reflect(d_in, n)) + fuzz * sphere sample;
    absorbs (black, no scatter) when the fuzzed dir leaves the hemisphere.
  * Dielectric — Schlick vs U coin flip + total-internal-reflection test;
    attenuation = white.
  * Emission — attenuation = premultiplied color, never scatters.
  * Isotropic — dir = unit-sphere-VOLUME sample, attenuation = color.
  * Mix — resolved to a concrete material id BEFORE lobe evaluation with one
    fresh uniform per nesting level (lib/materials.rs:149-156).  Mix-free
    scenes skip resolution entirely (static ``has_mix`` flag), saving both
    the lookups and MAX_MIX_DEPTH uniform draws per bounce.

Per-bounce uniform layout (see shade_uniforms): [mix x MAX_MIX_DEPTH if the
scene has mixes] ++ [dir1, dir2, coin, radius] ++ [one per volume object].
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models import materials as M
from ..utils import rng, vec
from ..utils.lookup import tgather


def mix_uniforms(table: M.MaterialTable) -> int:
    return M.MAX_MIX_DEPTH if table.has_mix else 0


def shade_uniforms(table: M.MaterialTable) -> int:
    """Uniform draws consumed by mix-resolution + lobe sampling per bounce."""
    return mix_uniforms(table) + 4


def resolve_mix(table: M.MaterialTable, mat_id, u):
    """Collapse (possibly nested) MixMaterial ids to concrete material ids.

    One masked lookup step per nesting level; non-mix rows point at
    themselves so resolved ids are fixed points.  ``u`` is the bounce's full
    uniform block; the first MAX_MIX_DEPTH columns are the mix coins (the
    reference draws a fresh uniform per nested scatter call,
    lib/materials.rs:151).  No-op for mix-free scenes.
    """
    if not table.has_mix:
        return mat_id
    for level in range(M.MAX_MIX_DEPTH):
        is_mix = tgather(table.kind, mat_id) == M.MIX
        pick_first = u[:, level] >= tgather(table.mix_factor, mat_id)
        child = jnp.where(
            pick_first,
            tgather(table.mix_first, mat_id),
            tgather(table.mix_second, mat_id),
        )
        mat_id = jnp.where(is_mix, child, mat_id)
    return mat_id


def schlick(cosine, idx):
    """Dielectric::reflectance (lib/materials.rs:103-108)."""
    r0 = (1.0 - idx) / (1.0 + idx)
    r0 = r0 * r0
    return r0 + (1.0 - r0) * (1.0 - cosine) ** 5


def scatter(table: M.MaterialTable, mat_id, d_in, normal, front_face, u,
            clay: bool = False):
    """Evaluate all lobes, select by material kind.

    Args:
      mat_id: (R,) resolved material ids (post resolve_mix).
      d_in: (R, 3) incoming ray direction (unnormalized, as in reference).
      normal: (R, 3) front-face-flipped hit normal.
      front_face: (R,) bool.
      u: (R, >= shade_uniforms(table)) uniform block for this bounce; the 4
         columns after the mix coins are (dir1, dir2, coin, radius).
      clay: Clay render mode — force Lambertian(0.8 gray)
            (lib/core/render.rs:41).

    Returns (attenuation (R,3), new_dir (R,3), does_scatter (R,)).
    """
    k = mix_uniforms(table)
    u1, u2, u_coin, u_r = u[:, k], u[:, k + 1], u[:, k + 2], u[:, k + 3]
    sphere_dir = rng.unit_sphere_surface(u1, u2)  # shared across lobes: only
    # one lobe is selected per ray and selection is independent of the draw

    if clay:
        # Clay mode: every hit shades as Lambertian(0.8,0.8,0.8); no table
        # data is needed at all
        lam_dir = normal + sphere_dir
        lam_dir = jnp.where(
            vec.near_zero(lam_dir)[..., None], normal, lam_dir
        )
        return (
            jnp.full(normal.shape, 0.8),
            lam_dir,
            jnp.ones(mat_id.shape, bool),
        )

    present = set(table.kinds_present)
    kind = tgather(table.kind, mat_id)
    albedo = tgather(table.albedo, mat_id)
    white = jnp.ones_like(albedo)
    black = jnp.zeros_like(albedo)
    true_ = jnp.ones(kind.shape, bool)
    false_ = jnp.zeros(kind.shape, bool)

    # Each lobe is compiled ONLY if its kind exists in the scene
    # (kinds_present is static) — e.g. no cbrt unless there is an Isotropic.
    conds, attens, dirs, scats = [], [], [], []

    def lobe(k, atten, direction, scat):
        conds.append(kind == k)
        attens.append(atten)
        dirs.append(direction)
        scats.append(scat)

    if M.LAMBERTIAN in present:
        # Lambertian (lib/materials.rs:31-42)
        lam_dir = normal + sphere_dir
        lam_dir = jnp.where(
            vec.near_zero(lam_dir)[..., None], normal, lam_dir
        )
        lobe(M.LAMBERTIAN, albedo, lam_dir, true_)

    if M.METAL in present:
        # Metal (lib/materials.rs:58-70)
        reflected = vec.normalize(vec.reflect(d_in, normal))
        metal_dir = (
            reflected + tgather(table.fuzz, mat_id)[..., None] * sphere_dir
        )
        metal_ok = vec.dot(metal_dir, normal) > 0.0
        lobe(M.METAL, jnp.where(metal_ok[..., None], albedo, black),
             metal_dir, metal_ok)

    if M.DIELECTRIC in present:
        # Dielectric (lib/materials.rs:113-138)
        ir = tgather(table.ir, mat_id)
        ratio = jnp.where(front_face, 1.0 / ir, ir)
        ud = vec.normalize(d_in)
        cos_theta = jnp.minimum(vec.dot(normal, -ud), 1.0)
        # sin_theta feeds only the discrete TIR comparison — detach it so the
        # sqrt-at-0 (normal incidence) infinite derivative never enters AD
        sin_theta = jax.lax.stop_gradient(
            jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
        )
        cannot_refract = ratio * sin_theta > 1.0
        choose_reflect = cannot_refract | (
            schlick(cos_theta, ratio) > u_coin
        )
        diel_dir = jnp.where(
            choose_reflect[..., None],
            vec.reflect(ud, normal),
            vec.refract(ud, normal, ratio),
        )
        lobe(M.DIELECTRIC, white, diel_dir, true_)

    if M.EMISSION in present:
        lobe(M.EMISSION, tgather(table.emission, mat_id), normal, false_)

    if M.ISOTROPIC in present:
        # Isotropic (lib/volume.rs:75-88)
        iso_dir = sphere_dir * rng.cbrt01(u_r)[..., None]
        lobe(M.ISOTROPIC, albedo, iso_dir, true_)

    condc = [c[..., None] for c in conds]
    atten = jnp.select(condc, attens, default=black)
    new_dir = jnp.select(condc, dirs, default=normal)
    does_scatter = jnp.select(conds, scats, default=true_)
    return atten, new_dir, does_scatter
