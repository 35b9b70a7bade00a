"""Mesh-bounded constant-density volumes (Volume::new over ANY Object,
lib/volume.rs:25-31 — the reference accepts mesh boundaries; round 2 only
supported spheres).  The XLA intersector finds each volume's entry/exit
crossings among its own triangles and free-flights between them with the
volume's own uniform column.  Such scenes always run on the XLA engine's
dense intersector (the crossing set needs the whole boundary per ray), and
are differentiable through its reverse mode."""

import numpy as np
import jax.numpy as jnp
import pytest

from raytracingrust_tpu import (
    Camera,
    Emission,
    Isotropic,
    Lambertian,
    RenderSettings,
    SceneBuilder,
)
from raytracingrust_tpu.models.mesh import Mesh
from raytracingrust_tpu.render.render import render_linear


def _cube_mesh(center, half, material):
    c = np.asarray(center, np.float32)
    h = float(half)
    v = np.array([[x, y, z] for x in (-h, h) for y in (-h, h)
                  for z in (-h, h)], np.float32) + c
    # 12 triangles, outward winding irrelevant (volume uses crossings only)
    f = np.array([
        [0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
        [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
        [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3],
    ], np.int32)
    return Mesh.from_buffers(v, v, f, material)


def _icosphere(center, radius, material, subdiv=3):
    """Subdivided octahedron -> near-spherical triangle mesh."""
    verts = [(1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0),
             (0, 0, 1), (0, 0, -1)]
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    verts = [np.asarray(v, np.float64) for v in verts]
    for _ in range(subdiv):
        new_faces = []
        cache = {}

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = verts[i] + verts[j]
                m /= np.linalg.norm(m)
                verts.append(m)
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (ab, b, bc), (ca, bc, c),
                          (ab, bc, ca)]
        faces = new_faces
    v = (np.asarray(verts, np.float32) * radius
         + np.asarray(center, np.float32))
    return Mesh.from_buffers(v, v, np.asarray(faces, np.int32), material)


def test_mesh_volume_transmission():
    """Rays through a unit cube of density rho pass with probability
    exp(-rho * chord): check the empirical transmission over a dense
    uniform grid against the analytic law."""
    from raytracingrust_tpu.ops.intersect import mesh_volume_ts

    b = SceneBuilder()
    iso = b.add_material(Isotropic((0.5, 0.5, 0.5)))
    rho = 0.7
    mi = b.add_mesh(_cube_mesh((0, 0, -3), 1.0, iso))
    b.add_volume(mi, rho)
    scene = b.build(with_bvh=False)
    assert scene.num_mesh_volumes == 1
    assert int(np.asarray((scene.triangles.volume >= 0).sum())) == 12

    n = 4096
    o = jnp.tile(jnp.array([[0.2, -0.1, 0.0]], jnp.float32), (n, 1))
    d = jnp.tile(jnp.array([[0.0, 0.0, -1.0]], jnp.float32), (n, 1))
    u = ((jnp.arange(n, dtype=jnp.float32) + 0.5) / n)[:, None]
    ts = np.asarray(mesh_volume_ts(scene, o, d, u, 1e-5, np.inf))[:, 0]
    chord = 2.0  # cube spans z in [-4, -2] along the ray
    want_pass = np.exp(-rho * chord)
    got_pass = (~np.isfinite(ts)).mean()
    np.testing.assert_allclose(got_pass, want_pass, atol=0.01)
    # accepted scatter points lie inside the boundary window
    inside = ts[np.isfinite(ts)]
    assert inside.min() >= 2.0 - 1e-4 and inside.max() <= 4.0 + 1e-4


def test_mesh_volume_render_matches_sphere_volume():
    """An icosphere-bounded volume must render like the ANALYTIC sphere
    volume of the same center/radius/density (chord lengths agree to the
    tessellation error)."""
    def build(use_mesh):
        b = SceneBuilder()
        b.camera = Camera.create((0, 0, 2.5), (0, 0, -1), (0, 1, 0),
                                 60.0, 1.0)
        b.settings = RenderSettings(samples_per_pixel=48, max_ray_depth=6,
                                    enable_bvh_tree=False)
        lam = b.add_material(Lambertian((0.6, 0.5, 0.4)))
        glow = b.add_material(Emission((2.0, 1.6, 1.2)))
        iso = b.add_material(Isotropic((0.8, 0.8, 0.9)))
        b.add_sphere((0, -101.0, -1), 100.0, lam)
        b.add_sphere((1.5, 1.8, -2.0), 0.6, glow)
        if use_mesh:
            mi = b.add_mesh(_icosphere((0, 0, -1), 0.8, iso, subdiv=3))
            b.add_volume(mi, 2.5)
        else:
            si = b.add_sphere((0, 0, -1), 0.8, iso)
            b.add_volume(si, 2.5)
        return b.build(with_bvh=False)

    img_m = np.asarray(render_linear(build(True), 24, 24, seed=0,
                                     engine="xla"))
    img_s = np.asarray(render_linear(build(False), 24, 24, seed=0,
                                     engine="xla"))
    # same estimator, same RNG streams, boundary differs only by the
    # octahedron-subdiv-3 tessellation error
    assert abs(img_m.mean() - img_s.mean()) < 0.02
    assert np.abs(img_m - img_s).mean() < 0.05


def test_mesh_volume_json_roundtrip(tmp_path):
    """Volume-with-Mesh-boundary serializes as {type: Volume, boundary:
    {type: Mesh, ...}} and loads back identically."""
    obj = tmp_path / "cube.obj"
    c = _cube_mesh((0, 0, -2), 0.5, 0)
    with open(obj, "w") as f:
        tri = np.asarray(c.positions) if hasattr(c, "positions") else None
        # write a minimal OBJ for the cube
        h = 0.5
        for x in (-h, h):
            for y in (-h, h):
                for z in (-h, h):
                    f.write(f"v {x} {y} {z - 2}\n")
        faces = [(1, 2, 4), (1, 4, 3), (5, 7, 8), (5, 8, 6),
                 (1, 5, 6), (1, 6, 2), (3, 4, 8), (3, 8, 7),
                 (1, 3, 7), (1, 7, 5), (2, 6, 8), (2, 8, 4)]
        for a, b_, cc in faces:
            f.write(f"f {a} {b_} {cc}\n")

    b = SceneBuilder()
    iso = b.add_material(Isotropic((0.5, 0.5, 0.5)))
    mi = b.add_mesh(Mesh.from_file(str(obj), iso))
    b.add_volume(mi, 2.0)
    d = b.to_json()
    vol_entries = [o for o in d["objects"] if o["type"] == "Volume"]
    assert len(vol_entries) == 1
    assert vol_entries[0]["boundary"]["type"] == "Mesh"

    b2 = SceneBuilder.from_json(d)
    s2 = b2.build(with_bvh=False)
    assert s2.num_mesh_volumes == 1
    assert float(np.asarray(s2.mesh_volumes.neg_inv_density[0])) == -0.5
    assert b2.to_json() == d


def _mesh_vol_scene(density=2.0, with_bvh=True):
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 1), (0, 0, -2), (0, 1, 0), 60.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=5)
    iso = b.add_material(Isotropic((0.6, 0.7, 0.8)))
    lam = b.add_material(Lambertian((0.7, 0.4, 0.3)))
    em = b.add_material(Emission((2.0, 1.8, 1.5)))
    mi = b.add_mesh(_cube_mesh((0, 0, -2), 0.5, iso))
    b.add_volume(mi, density)
    b.add_sphere((1, 0, -2), 0.4, lam)
    b.add_sphere((-1, 0.8, -2), 0.3, em)
    return b.build(with_bvh=with_bvh)


def test_mesh_volume_on_bvh_kernel():
    """Mesh-bounded volumes stay out of the sphere kernel and take the XLA
    engine's dense crossing scan even when a BVH is built and traversal
    is forced: the render is the same with and without one."""
    from raytracingrust_tpu.ops import pallas_megakernel as PK
    from raytracingrust_tpu.render import integrator

    s = _mesh_vol_scene()
    assert not PK.supports(s)
    assert s.bvh is not None and s.num_mesh_volumes == 1
    threshold = integrator.BRUTE_FORCE_THRESHOLD
    integrator.BRUTE_FORCE_THRESHOLD = 0
    try:
        with_bvh = np.asarray(render_linear(s, 12, 12, seed=0,
                                            engine="xla"))
    finally:
        integrator.BRUTE_FORCE_THRESHOLD = threshold
    dense = np.asarray(render_linear(_mesh_vol_scene(with_bvh=False), 12,
                                     12, seed=0, engine="xla"))
    np.testing.assert_array_equal(with_bvh, dense)
    assert np.isfinite(dense).all() and dense.max() > 0


def test_mesh_volume_bvh_grad_fd():
    """XLA reverse mode through a mesh-volume hit: AD of the fixed-seed
    loss vs central finite differences in the phase-material albedo."""
    import dataclasses

    import jax

    s = _mesh_vol_scene(density=4.0)

    def loss(albedo):
        mats = dataclasses.replace(
            s.materials, albedo=s.materials.albedo.at[0].set(albedo))
        s2 = dataclasses.replace(s, materials=mats)
        img = render_linear(s2, 10, 10, seed=0, engine="xla")
        return jnp.sum(img ** 2)

    a0 = jnp.array([0.6, 0.7, 0.8], jnp.float32)
    g = jax.jit(jax.grad(loss))(a0)
    loss_j = jax.jit(loss)
    checked = 0
    for i in range(3):
        eps = 1e-3
        want = (float(loss_j(a0.at[i].add(eps)))
                - float(loss_j(a0.at[i].add(-eps)))) / (2 * eps)
        got = float(g[i])
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=5e-3)
        checked += abs(got) > 1e-6
    assert checked >= 2, "phase-material albedo gradient should be live"
