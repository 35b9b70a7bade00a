#!/usr/bin/env python3
"""Generate the repo's demo scenes (scenes/*.json).

Original content in the reference-compatible JSON schema.  The benchmark
scene and the ~100-sphere grid are written from raytracingrust_tpu/demo.py,
which builds them in code.  Regenerate with:

    python scripts/make_demo_scenes.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# scene authoring is host-side work
jax.config.update("jax_platforms", "cpu")

import numpy as np

from raytracingrust_tpu import (
    Background,
    Camera,
    Dielectric,
    Emission,
    Isotropic,
    Lambertian,
    Metal,
    MixMaterial,
    RenderSettings,
    SceneBuilder,
    demo,
)

OUT = os.path.join(os.path.dirname(__file__), "..", "scenes")


def cornell_spheres():
    """A Cornell-box-flavored sphere scene: emissive ceiling panel, colored
    walls approximated by giant spheres, glass and metal balls."""
    b = SceneBuilder()
    b.camera = Camera.create((0, 1.0, 3.2), (0, 1.0, 0), (0, 1, 0), 52.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=64, max_ray_depth=8)
    b.background = Background.uniform((0.0, 0.0, 0.0))
    white = b.add_material(Lambertian((0.73, 0.73, 0.73)))
    red = b.add_material(Lambertian((0.65, 0.05, 0.05)))
    green = b.add_material(Lambertian((0.12, 0.45, 0.15)))
    light = b.add_material(Emission.create((1.0, 0.9, 0.7), 14.0))
    glass = b.add_material(Dielectric(1.5))
    metal = b.add_material(Metal((0.85, 0.85, 0.9), 0.05))
    R = 1000.0
    b.add_sphere((0, -R, 0), R, white)          # floor
    b.add_sphere((0, R + 2.2, 0), R, white)     # ceiling
    b.add_sphere((0, 1.0, -R - 1.6), R, white)  # back wall
    b.add_sphere((-R - 1.6, 1.0, 0), R, red)    # left wall
    b.add_sphere((R + 1.6, 1.0, 0), R, green)   # right wall
    b.add_sphere((0, 2.65, -0.2), 0.55, light)  # ceiling light
    b.add_sphere((-0.55, 0.45, -0.4), 0.45, glass)
    b.add_sphere((0.6, 0.5, -0.7), 0.5, metal)
    return b


def material_zoo():
    """One of everything: all 5 material kinds + mix + a fog volume, under a
    gradient sky.  Exercises every shading path in one scene."""
    rs = np.random.RandomState(42)
    b = SceneBuilder()
    b.camera = Camera.create((0, 0.8, 4.0), (0, 0.3, 0), (0, 1, 0), 40.0, 1.5)
    b.settings = RenderSettings(samples_per_pixel=32, max_ray_depth=8)
    b.background = Background.gradient((0.55, 0.7, 0.95), (0.95, 0.95, 1.0))
    ground = b.add_material(Lambertian((0.45, 0.5, 0.35)))
    b.add_sphere((0, -200.5, 0), 200.0, ground)

    mats = [
        Lambertian((0.8, 0.3, 0.25)),
        Metal((0.9, 0.8, 0.6), 0.0),
        Metal((0.8, 0.8, 0.85), 0.35),
        Dielectric(1.5),
        Emission.create((0.9, 0.5, 1.0), 4.0),
        MixMaterial(Lambertian((0.2, 0.3, 0.9)), Metal((1, 1, 1), 0.0), 0.4),
    ]
    for i, m in enumerate(mats):
        h = b.add_material(m)
        x = -2.0 + i * 0.8
        b.add_sphere((x, 0.0, -0.5 - 0.3 * (i % 2)), 0.35, h)

    fog = b.add_material(Isotropic((0.85, 0.85, 0.95)))
    idx = b.add_sphere((0.6, 0.2, 1.2), 0.6, fog)
    b.add_volume(idx, density=1.2)

    # scatter of tiny random balls
    for _ in range(40):
        kind = rs.randint(3)
        col = tuple(rs.rand(3) * 0.8 + 0.1)
        if kind == 0:
            h = b.add_material(Lambertian(col))
        elif kind == 1:
            h = b.add_material(Metal(col, float(rs.rand() * 0.4)))
        else:
            h = b.add_material(Dielectric(1.5))
        x, z = rs.uniform(-3, 3), rs.uniform(-2.5, 2.0)
        b.add_sphere((x, -0.38, z), 0.12, h)
    return b


def bvh_stress(n_side=20):
    """Dense sphere grid mirroring the reference's bvh_tree_stress workload
    shape (benches/bvh_tree_stress.rs: 20x20x20 grid) with original
    materials/colors; exercises BVH build + traversal at 8000 primitives."""
    b = SceneBuilder()
    b.camera = Camera.create((30, 30, 30), (0, 0, 0), (0, 1, 0), 55.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=8, max_ray_depth=4)
    b.background = Background.gradient((0.2, 0.25, 0.4), (0.9, 0.9, 1.0))
    rs = np.random.RandomState(7)
    pal = [
        b.add_material(Lambertian((0.8, 0.4, 0.3))),
        b.add_material(Lambertian((0.35, 0.55, 0.8))),
        b.add_material(Metal((0.9, 0.9, 0.9), 0.1)),
        b.add_material(Emission.create((1.0, 0.8, 0.5), 3.0)),
    ]
    for i in range(n_side):
        for j in range(n_side):
            for k in range(n_side):
                if rs.rand() < 0.15:  # sparse fill keeps the file reasonable
                    b.add_sphere(
                        (i - n_side / 2, j - n_side / 2, k - n_side / 2),
                        0.3,
                        pal[rs.randint(len(pal))],
                    )
    return b


def main():
    os.makedirs(OUT, exist_ok=True)
    for name, builder in [
        ("benchmark", demo.benchmark()),
        ("sphere_grid", demo.sphere_grid()),
        ("cornell_spheres", cornell_spheres()),
        ("material_zoo", material_zoo()),
        ("bvh_stress", bvh_stress()),
    ]:
        path = os.path.join(OUT, f"{name}.json")
        builder.save(path)
        print(f"wrote {path} ({len(builder.objects)} objects, "
              f"{len(builder.materials)} materials)")


if __name__ == "__main__":
    main()
