"""Scenes generated in code, from a seed.

``benchmark`` is the five-sphere benchmark scene (scenes/benchmark.json is
written from it by scripts/make_demo_scenes.py).  ``sphere_grid`` and
``mesh_scene`` are the ~100-sphere and ~1k-triangle scene classes that the
goldens and the chip smoke test use; they need no asset files.
"""

from __future__ import annotations

import numpy as np

from . import (Background, Camera, Dielectric, Emission, Lambertian, Metal,
               RenderSettings, SceneBuilder)
from .models.mesh import Mesh


def benchmark() -> SceneBuilder:
    """Ground, red diffuse ball, mirror, glass ball and an emissive sun
    under a uniform gray sky, at 5 spp and depth 6."""
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=5, max_ray_depth=6)
    b.background = Background.uniform((0.6, 0.6, 0.6))
    ground = b.add_material(Lambertian((0.8, 0.8, 0.4)))
    red = b.add_material(Lambertian((0.8, 0.1, 0.1)))
    mirror = b.add_material(Metal((1.0, 1.0, 1.0), 0.03))
    glass = b.add_material(Dielectric(1.5))
    sun = b.add_material(Emission((2.0, 2.0, 2.0)))
    b.add_sphere((10, 15.8, -1), 10.0, sun)
    b.add_sphere((1, 0, -1), 0.5, mirror)
    b.add_sphere((-1, 0, -1), 0.5, glass)
    b.add_sphere((0, -0.2, -1), 0.3, red)
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    return b


def sphere_grid(n_side: int = 11, n_rows: int = 9,
                seed: int = 0) -> SceneBuilder:
    """A ground sphere and an ``n_rows`` x ``n_side`` grid of small balls
    (99 + 1 = 100 spheres by default) with random diffuse, metal, glass and
    emissive materials, under a gradient sky."""
    rs = np.random.RandomState(seed)
    b = SceneBuilder()
    b.camera = Camera.create((0, 3.0, 7.0), (0, 0, -1.0), (0, 1, 0),
                             45.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=5, max_ray_depth=6,
                                enable_bvh_tree=False)
    b.background = Background.gradient((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    b.add_sphere((0, -1000.0, 0), 1000.0,
                 b.add_material(Lambertian((0.5, 0.5, 0.5))))
    for i in range(n_rows):
        for j in range(n_side):
            kind = rs.rand()
            col = tuple(float(c) for c in rs.rand(3) * 0.8 + 0.1)
            if kind < 0.55:
                m = Lambertian(col)
            elif kind < 0.8:
                m = Metal(col, float(rs.rand() * 0.4))
            elif kind < 0.93:
                m = Dielectric(1.5)
            else:
                m = Emission((2.0 * col[0], 2.0 * col[1], 2.0 * col[2]))
            x = (j - (n_side - 1) / 2) * 0.9 + rs.uniform(-0.2, 0.2)
            z = -i * 0.9 + rs.uniform(-0.2, 0.2)
            b.add_sphere((x, 0.3, z), 0.3, b.add_material(m))
    return b


def icosphere(center, radius: float, material: int, subdiv: int = 3,
              bump: float = 0.0, seed: int = 0) -> Mesh:
    """Subdivided icosahedron (20 * 4**subdiv triangles).  ``bump`` scales
    a random per-vertex radial displacement drawn from ``seed``."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    verts = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
             (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
             (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)]
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    verts = [np.asarray(v, np.float64) / np.linalg.norm(v) for v in verts]
    for _ in range(subdiv):
        new_faces = []
        cache = {}

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c),
                          (ab, bc, ca)]
        faces = new_faces
    v = np.asarray(verts)
    if bump:
        v = v * (1.0 + bump * np.random.RandomState(seed).uniform(
            -1.0, 1.0, (len(v), 1)))
    v = (v * radius + np.asarray(center)).astype(np.float32)
    return Mesh.from_buffers(v, v, np.asarray(faces, np.int32), material)


def mesh_scene(subdiv: int = 3, seed: int = 0) -> SceneBuilder:
    """A lumpy 1,280-triangle icosphere (at ``subdiv=3``) on a ground
    sphere beside a metal ball, lit by an emissive sphere and a gradient
    sky.  Above the dense-intersector threshold, so the XLA engine
    traverses its BVH."""
    b = SceneBuilder()
    b.camera = Camera.create((0, 0.6, 3.0), (0, 0.1, 0), (0, 1, 0), 40.0,
                             1.0)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=8)
    b.background = Background.gradient((1.0, 1.0, 1.0), (0.5, 0.7, 1.0))
    clay = b.add_material(Lambertian((0.7, 0.55, 0.45)))
    b.add_mesh(icosphere((0, 0.1, 0), 0.6, clay, subdiv=subdiv, bump=0.08,
                         seed=seed))
    b.add_sphere((0, -100.5, 0), 100.0,
                 b.add_material(Lambertian((0.4, 0.5, 0.4))))
    b.add_sphere((1.0, -0.2, 0.3), 0.3,
                 b.add_material(Metal((0.9, 0.9, 0.95), 0.1)))
    b.add_sphere((-1.2, 1.4, 0.5), 0.4,
                 b.add_material(Emission((3.0, 2.7, 2.2))))
    return b
