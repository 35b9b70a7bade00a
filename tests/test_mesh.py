"""Triangle mesh / OBJ tests."""

import numpy as np
import jax.numpy as jnp

from raytracingrust_tpu import (
    Emission,
    Lambertian,
    Mesh,
    RenderSettings,
    SceneBuilder,
)
from raytracingrust_tpu.io.obj import load_obj
from raytracingrust_tpu.ops.intersect import intersect_brute
from raytracingrust_tpu.render.render import render_linear

QUAD_OBJ = """
# unit quad in the z=-2 plane
v -1.0 -1.0 -2.0
v  1.0 -1.0 -2.0
v  1.0  1.0 -2.0
v -1.0  1.0 -2.0
vn 0.0 0.0 1.0
f 1//1 2//1 3//1
f 1//1 3//1 4//1
"""


def quad_builder(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(QUAD_OBJ)
    b = SceneBuilder()
    b.settings = RenderSettings(samples_per_pixel=1, max_ray_depth=2)
    m = b.add_material(Lambertian((0.5, 0.5, 0.5)))
    b.add_mesh(Mesh.from_file(str(p), m))
    return b


def test_obj_loader(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(QUAD_OBJ)
    pos, nrm, faces = load_obj(str(p))
    assert pos.shape == (4, 3)
    assert faces.shape == (2, 3)
    np.testing.assert_allclose(nrm, [[0, 0, 1]] * 4)


def test_obj_fan_triangulation_and_negative_indices(tmp_path):
    p = tmp_path / "poly.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 2 0\n"
        "f -5 -4 -3 -2 -1\n"
    )
    pos, _, faces = load_obj(str(p))
    assert faces.shape == (3, 3)  # pentagon -> 3 triangles
    np.testing.assert_array_equal(faces[:, 0], [0, 0, 0])


def test_mesh_hit(tmp_path):
    scene = quad_builder(tmp_path).build(with_bvh=False)
    assert len(scene.triangles) == 2
    o = jnp.array([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0], [3.0, 3.0, 0.0]])
    d = jnp.array([[0.0, 0.0, -1.0], [0.0, 2.0, -1.0], [0.0, 0.0, -1.0]])
    hit = intersect_brute(scene, o, d, jnp.zeros((3, 0)))
    # straight -z: hits the quad at t=2
    assert bool(hit.hit[0]) and abs(float(hit.t[0]) - 2.0) < 1e-5
    # steep ray exits above the quad
    assert not bool(hit.hit[1])
    # parallel offset ray misses
    assert not bool(hit.hit[2])
    # reference normal convention: (v2-v1)x(v0-v1) normalized, then
    # front-face flipped toward the ray
    np.testing.assert_allclose(np.asarray(hit.normal[0]), [0, 0, 1],
                               atol=1e-6)


def test_mesh_bvh_equals_brute(tmp_path):
    from raytracingrust_tpu.demo import icosphere

    b = SceneBuilder()
    b.settings = RenderSettings(samples_per_pixel=1, max_ray_depth=2)
    m = b.add_material(Lambertian((0.7, 0.7, 0.7)))
    # a generated ~1k-triangle mesh, the size class of the reference's
    # monkey.obj (967 faces)
    mesh = icosphere((0, 0, 0), 0.8, m, subdiv=3, bump=0.1, seed=1)
    assert mesh.num_triangles == 1280
    b.add_mesh(mesh)
    from raytracingrust_tpu.models.camera import Camera
    b.camera = Camera.create((0, 0, 3), (0, 0, 0), (0, 1, 0), 40.0, 1.0)

    import dataclasses
    sb = b.build(with_bvh=False)
    sb = dataclasses.replace(
        sb, settings=dataclasses.replace(sb.settings, enable_bvh_tree=False)
    )
    sv = b.build(with_bvh=True)
    a = np.asarray(render_linear(sb, 10, 10, seed=0))
    c = np.asarray(render_linear(sv, 10, 10, seed=0))
    mismatched = (~np.isclose(a, c, atol=1e-6)).mean()
    assert mismatched <= 0.01
    # sanity: the monkey actually covers some pixels
    assert (a.sum(-1) > 0).any()


def test_mesh_scene_json_roundtrip(tmp_path):
    b = quad_builder(tmp_path)
    p = tmp_path / "scene.json"
    b.save(str(p))
    b2 = SceneBuilder.from_file(str(p))
    s1, s2 = b.build(), b2.build()
    np.testing.assert_array_equal(
        np.asarray(s1.triangles.v0), np.asarray(s2.triangles.v0)
    )
