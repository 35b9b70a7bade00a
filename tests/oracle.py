"""Reference-faithful NumPy oracle.

A deliberately naive, per-ray recursive re-implementation of the reference
algorithm (lib/core/render.rs trace_ray + calculate_pixel), used as the
golden model for the wavefront engines.  Geometry, shading, and accumulation math are
written independently (scalar NumPy, recursion, linear object scan — the
shape of the Rust code, none of the matmul/wavefront machinery), so a bug in
the wavefront formulation cannot hide.

The ONLY shared component is the uniform-random source
(raytracingrust_tpu.utils.rng): both implementations consume identical
U[0,1) draws per (ray, stream), which turns even the stochastic paths into
exact comparisons instead of statistical ones.
"""

from __future__ import annotations

import math

import numpy as np

from raytracingrust_tpu.models import materials as M
from raytracingrust_tpu.models.scene import (
    MODE_CLAY,
    MODE_NORMAL,
    MODE_RANDOM,
    SceneBuilder,
)
from raytracingrust_tpu.models.materials import MIX, MAX_MIX_DEPTH
from raytracingrust_tpu.utils import rng as rng_mod

T_MIN = 1e-5
INF = float("inf")


def _normalize(v):
    return v / np.linalg.norm(v)


def _sphere_surface(u1, u2):
    z = 1.0 - 2.0 * u1
    r = math.sqrt(max(0.0, 1.0 - z * z))
    phi = 2.0 * math.pi * u2
    return np.array([r * math.cos(phi), r * math.sin(phi), z])


class Oracle:
    def __init__(self, builder: SceneBuilder):
        self.builder = builder
        self.settings = builder.settings
        self.camera = builder.camera
        self.materials = builder.materials
        self.background = builder.background

        # linear object list: solid spheres first, then volume spheres, then
        # triangles — mirroring the partitioned SoA layout so that volume
        # RNG ordinals line up.
        solids, volumes = [], []
        self.triangles = []
        for rec in builder.objects:
            if rec["kind"] == "sphere":
                entry = dict(rec)
                if rec.get("neg_inv_density", 0.0) != 0.0:
                    volumes.append(entry)
                else:
                    solids.append(entry)
            else:
                mesh = rec["mesh"]
                v0s, e1s, e2s, ns = mesh.triangle_soa()
                for i in range(len(v0s)):
                    self.triangles.append(
                        (v0s[i], e1s[i], e2s[i], ns[i], mesh.material)
                    )
        self.spheres = solids + volumes
        self.num_volumes = len(volumes)
        # uniform-stream layout must mirror shade.shade_uniforms: mix coins
        # are only drawn when the scene actually contains a MixMaterial
        self.has_mix = any(
            isinstance(m, M.MixMaterial) for m in self.materials
        )
        self.mix_offset = MAX_MIX_DEPTH if self.has_mix else 0
        self.n_shade = self.mix_offset + 4

    # ------------------------------------------------------------ sampling
    def uniforms(self, ray_id: int, stream: int, n: int) -> np.ndarray:
        import jax.numpy as jnp

        return np.asarray(rng_mod.ray_uniforms(
            rng_mod.base_key(self.seed),
            jnp.asarray([ray_id], jnp.int32), stream, n,
        ))[0]

    # ---------------------------------------------------------- intersection
    def hit_sphere(self, c, r, o, d, tmin, tmax):
        """Sphere::hit (lib/objects.rs:22-51)."""
        oc = o - c
        a = float(d @ d)
        half_b = float(oc @ d)
        cq = float(oc @ oc) - r * r
        disc = half_b * half_b - a * cq
        if disc < 0:
            return None
        sq = math.sqrt(disc)
        root = (-half_b - sq) / a
        if root < tmin or tmax < root:
            root = (-half_b + sq) / a
            if root < tmin or tmax < root:
                return None
        return root

    def hit_volume(self, c, r, nid, o, d, tmin, tmax, u):
        """Volume::hit (lib/volume.rs:35-73) with an injected uniform."""
        oc = o - c
        a = float(d @ d)
        half_b = float(oc @ d)
        cq = float(oc @ oc) - r * r
        disc = half_b * half_b - a * cq
        if disc < 0:
            return None
        sq = math.sqrt(disc)
        h1 = (-half_b - sq) / a
        h2 = (-half_b + sq) / a
        if h2 < h1 + tmin:
            return None
        h1 = max(h1, tmin)
        h2 = min(h2, tmax)
        if h1 >= h2:
            return None
        h1 = max(h1, 0.0)
        ray_len = math.sqrt(a)
        dist_inside = (h2 - h1) * ray_len
        hit_dist = nid * math.log(max(u, 1e-37))
        if hit_dist > dist_inside:
            return None
        return h1 + hit_dist / ray_len

    def hit_triangle(self, v0, e1, e2, o, d, tmin, tmax):
        """Moller-Trumbore, classic form (lib/core/mesh.rs:146-197 with the
        Q5 fixes: proper det epsilon, tmax honored)."""
        h = np.cross(d, e2)
        a = float(e1 @ h)
        if abs(a) <= 1e-8:
            return None
        f = 1.0 / a
        s = o - v0
        u = f * float(s @ h)
        if u < 0.0 or u > 1.0:
            return None
        q = np.cross(s, e1)
        v = f * float(d @ q)
        if v < 0.0 or u + v > 1.0:
            return None
        t = f * float(e2 @ q)
        if t <= tmin or t > tmax:
            return None
        return t

    def closest_hit(self, o, d, u_vol):
        """Linear scan (lib/core/scene.rs:141-157)."""
        best_t, best = INF, None
        for i, s in enumerate(self.spheres):
            c = np.asarray(s["center"], np.float64)
            nid = s.get("neg_inv_density", 0.0)
            if nid != 0.0:
                ordinal = i - (len(self.spheres) - self.num_volumes)
                t = self.hit_volume(c, s["radius"], nid, o, d, T_MIN, INF,
                                    u_vol[ordinal])
                normal = np.array([1.0, 0.0, 0.0])
            else:
                t = self.hit_sphere(c, s["radius"], o, d, T_MIN, INF)
                normal = None
            if t is not None and t < best_t:
                best_t = t
                p = o + t * d
                n = normal if normal is not None else (p - c) / s["radius"]
                best = (t, p, n, s["material"])
        for v0, e1, e2, n, mat in self.triangles:
            t = self.hit_triangle(
                np.asarray(v0, np.float64), np.asarray(e1, np.float64),
                np.asarray(e2, np.float64), o, d, T_MIN, best_t
            )
            if t is not None and t < best_t:
                best_t = t
                best = (t, o + t * d, np.asarray(n, np.float64), mat)
        if best is None:
            return None
        t, p, outward, mat = best
        front = float(d @ outward) < 0.0
        return (t, p, outward if front else -outward, front, mat)

    # -------------------------------------------------------------- shading
    def scatter(self, mat, d_in, p, n, front, u, mix_level=0):
        k = self.mix_offset
        if isinstance(mat, M.MixMaterial):
            child = mat.first if u[mix_level] >= mat.factor else mat.second
            return self.scatter(child, d_in, p, n, front, u, mix_level + 1)
        if isinstance(mat, M.Lambertian):
            direction = n + _sphere_surface(u[k], u[k + 1])
            if np.all(np.abs(direction) < 1e-8):
                direction = n
            return np.asarray(mat.albedo, np.float64), direction
        if isinstance(mat, M.Metal):
            refl = _normalize(d_in - 2.0 * float(d_in @ n) * n)
            direction = refl + mat.fuzz * _sphere_surface(u[k], u[k + 1])
            if float(direction @ n) > 0.0:
                return np.asarray(mat.albedo, np.float64), direction
            return np.zeros(3), None
        if isinstance(mat, M.Dielectric):
            ratio = (1.0 / mat.ir) if front else mat.ir
            ud = _normalize(d_in)
            cos_t = min(float(n @ -ud), 1.0)
            sin_t = math.sqrt(max(0.0, 1.0 - cos_t * cos_t))
            r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
            schlick = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
            if ratio * sin_t > 1.0 or schlick > u[k + 2]:
                direction = ud - 2.0 * float(ud @ n) * n
            else:
                out_perp = ratio * (ud + cos_t * n)
                out_par = -math.sqrt(
                    abs(1.0 - float(out_perp @ out_perp))
                ) * n
                direction = out_perp + out_par
            return np.ones(3), direction
        if isinstance(mat, M.Emission):
            return np.asarray(mat.color, np.float64), None
        if isinstance(mat, M.Isotropic):
            direction = _sphere_surface(u[k], u[k + 1]) * u[k + 3] ** (1 / 3)
            return np.asarray(mat.color, np.float64), direction
        raise TypeError(mat)

    def sample_background(self, d):
        from raytracingrust_tpu.models.backgrounds import (
            GRADIENT, SKYMAP, UNIFORM,
        )
        bg = self.background
        if bg.kind == UNIFORM:
            return np.asarray(bg.color_a, np.float64)
        if bg.kind == GRADIENT:
            t = 0.5 * (_normalize(d)[1] + 1.0)
            return (
                np.asarray(bg.color_a) * (1.0 - t)
                + np.asarray(bg.color_b) * t
            )
        img = np.asarray(bg.image)
        h, w = img.shape[:2]
        dn = _normalize(d)
        theta = math.acos(max(-1.0, min(1.0, -dn[1])))
        phi = math.atan2(-dn[2], dn[0]) + math.pi
        u, v = theta / math.pi, phi / (2 * math.pi)
        x = int(v * w) % w
        y = (h - 1) - int(u * h) % h
        return img[y, x].astype(np.float64)

    # ---------------------------------------------------------------- trace
    def trace(self, ray_id, o, d, depth):
        """trace_ray (lib/core/render.rs:32-59)."""
        if depth >= self.settings.max_ray_depth:
            return np.zeros(3)
        u = self.uniforms(ray_id, 1 + depth, self.n_shade + self.num_volumes)
        hit = self.closest_hit(o, d, u[self.n_shade:])
        if hit is None:
            return self.sample_background(d)
        t, p, n, front, mat_id = hit
        mode = self.settings.mode
        if mode == MODE_NORMAL:
            return 0.5 * (_normalize(n) + 1.0)
        if mode == MODE_RANDOM:
            return np.zeros(3)
        mat = (
            M.Lambertian((0.8, 0.8, 0.8))
            if mode == MODE_CLAY
            else self.materials[mat_id]
        )
        atten, scattered = self.scatter(mat, d, p, n, front, u)
        if scattered is None:
            return atten
        return atten * self.trace(ray_id, p, scattered, depth + 1)

    def render_linear(self, width, height, seed=0):
        """calculate_pixel accumulation (lib/core/render.rs:75-107) minus the
        gamma/u8 step — comparable to render.render_linear."""
        self.seed = seed
        spp = self.settings.samples_per_pixel
        clamp = self.settings.clamp_indirect
        out = np.zeros((height, width, 3))
        for pid in range(width * height):
            x, y = pid % width, pid // width
            acc = np.zeros(3)
            for s in range(spp):
                ray_id = pid * spp + s
                jit = self.uniforms(ray_id, 0, 2)
                u = (x + jit[0]) / (width - 1)
                v = (y + jit[1]) / (height - 1)
                o, d = self.get_ray(u, v)
                col = self.trace(ray_id, o, d, 0)
                acc += np.clip(col, 0.0, clamp)
            out[y, x] = acc / spp
        return out

    def get_ray(self, s, t):
        """Camera::ray_origin + get_ray (lib/core/camera.rs:19-57)."""
        cam = self.camera
        lookfrom = np.asarray(cam.lookfrom, np.float64)
        lookat = np.asarray(cam.lookat, np.float64)
        vup = np.asarray(cam.vertical, np.float64)
        theta = math.radians(float(cam.vertical_fov))
        h = math.tan(theta / 2)
        vh = 2.0 * h
        vw = float(cam.aspect_ratio) * vh
        w = _normalize(lookfrom - lookat)
        u = _normalize(np.cross(vup, w))
        v = np.cross(w, u)
        horizontal = vw * u
        vertical = vh * v
        lower_left = lookfrom - horizontal / 2 + vertical / 2 - w
        d = lower_left + s * horizontal - t * vertical - lookfrom
        return lookfrom, d
