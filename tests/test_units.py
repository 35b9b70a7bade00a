"""Property/unit tests for the math substrate and model layer."""

import json

import numpy as np
import jax.numpy as jnp

from raytracingrust_tpu import (
    Background,
    Camera,
    Dielectric,
    Emission,
    Lambertian,
    Metal,
    MixMaterial,
    SceneBuilder,
)
from raytracingrust_tpu.io.png import read_png, write_png
from raytracingrust_tpu.models.materials import build_table
from raytracingrust_tpu.utils import aabb, rng, vec


def test_reflect():
    v = jnp.array([[1.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    np.testing.assert_allclose(
        np.asarray(vec.reflect(v, n)), [[1.0, 1.0, 0.0]], atol=1e-6
    )


def test_refract_straight_through():
    uv = jnp.array([[0.0, -1.0, 0.0]])
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = vec.refract(uv, n, jnp.array(1.0))
    np.testing.assert_allclose(np.asarray(out), [[0.0, -1.0, 0.0]], atol=1e-6)


def test_refract_snell():
    # 45 degrees into glass (eta ratio 1/1.5): sin(theta_t) = sin(45)/1.5
    uv = vec.normalize(jnp.array([[1.0, -1.0, 0.0]]))
    n = jnp.array([[0.0, 1.0, 0.0]])
    out = np.asarray(vec.refract(uv, n, jnp.array(1.0 / 1.5)))[0]
    sin_t = out[0] / np.linalg.norm(out)
    np.testing.assert_allclose(sin_t, np.sin(np.pi / 4) / 1.5, atol=1e-6)


def test_spherical_coords_matches_reference_convention():
    # straight up (y=+1): theta = acos(-1) = pi
    sph = np.asarray(vec.to_spherical_coords(jnp.array([[0.0, 1.0, 0.0]])))
    np.testing.assert_allclose(sph[0, 0], np.pi, atol=1e-6)
    # +x axis: phi = atan2(0, 1) + pi = pi
    sph = np.asarray(vec.to_spherical_coords(jnp.array([[1.0, 0.0, 0.0]])))
    np.testing.assert_allclose(sph[0], [np.pi / 2, np.pi], atol=1e-6)


def test_slab_hit():
    bmin = jnp.array([[0.0, 0.0, 0.0]])
    bmax = jnp.array([[1.0, 1.0, 1.0]])
    o = jnp.array([[-1.0, 0.5, 0.5]])
    inv_d = 1.0 / jnp.array([[1.0, 1e-9, 1e-9]])
    hit, entry = aabb.slab_hit(bmin, bmax, o, inv_d, 1e-5, jnp.inf)
    assert bool(hit[0])
    np.testing.assert_allclose(float(entry[0]), 1.0, atol=1e-5)
    # pointing away -> miss
    hit, _ = aabb.slab_hit(bmin, bmax, o, -inv_d, 1e-5, jnp.inf)
    assert not bool(hit[0])
    # t-pruned -> miss
    hit, _ = aabb.slab_hit(bmin, bmax, o, inv_d, 1e-5, 0.5)
    assert not bool(hit[0])


def test_unit_sphere_samplers():
    u = np.random.RandomState(0).rand(3, 10000).astype(np.float32)
    surf = np.asarray(rng.unit_sphere_surface(jnp.asarray(u[0]), jnp.asarray(u[1])))
    np.testing.assert_allclose(
        np.linalg.norm(surf, axis=-1), 1.0, atol=1e-5
    )
    # uniformity: mean ~ 0, E[z^2] = 1/3
    assert np.abs(surf.mean(0)).max() < 0.02
    np.testing.assert_allclose((surf ** 2).mean(0), 1 / 3, atol=0.02)
    vol = np.asarray(rng.unit_sphere_volume(
        jnp.asarray(u[0]), jnp.asarray(u[1]), jnp.asarray(u[2])
    ))
    r = np.linalg.norm(vol, axis=-1)
    assert r.max() <= 1.0 + 1e-5
    # E[r] for uniform ball = 3/4
    np.testing.assert_allclose(r.mean(), 0.75, atol=0.02)


def test_camera_matches_reference_geometry():
    cam = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0)
    o, d = cam.get_rays(jnp.array([0.5]), jnp.array([0.5]))
    # center ray looks straight down -z
    np.testing.assert_allclose(np.asarray(d)[0], [0, 0, -1], atol=1e-6)
    # t=0 is the TOP of the image (v subtracted)
    _, d_top = cam.get_rays(jnp.array([0.5]), jnp.array([0.0]))
    assert float(d_top[0, 1]) > 0.9
    # fov: at 90 degrees the viewport half-height equals the focal length
    _, d_corner = cam.get_rays(jnp.array([0.0]), jnp.array([0.0]))
    np.testing.assert_allclose(np.asarray(d_corner)[0], [-1, 1, -1], atol=1e-6)


def test_material_table_mix_flattening():
    mats = [
        Lambertian((0.1, 0.2, 0.3)),
        MixMaterial(Metal((1, 1, 1), 0.1),
                    MixMaterial(Lambertian((0, 0, 0)), Dielectric(1.5), 0.3),
                    0.7),
        Emission((2.0, 2.0, 2.0)),
    ]
    table = build_table(mats)
    # 3 top-level + 2 children of mix 1 + 2 children of nested mix
    assert len(table) == 7
    from raytracingrust_tpu.models.materials import MIX
    assert int(table.kind[1]) == MIX
    first = int(table.mix_first[1])
    second = int(table.mix_second[1])
    assert int(table.kind[first]) == 1  # metal
    assert int(table.kind[second]) == MIX
    # non-mix rows are fix-points
    assert int(table.mix_first[0]) == 0


def test_scene_json_roundtrip(tmp_path):
    b = SceneBuilder()
    m = b.add_material(Lambertian((0.5, 0.4, 0.3)))
    e = b.add_material(Emission((3.0, 2.0, 1.0)))
    b.add_sphere((1, 2, 3), 0.5, m)
    idx = b.add_sphere((0, 0, -3), 1.0, e)
    b.add_volume(idx, density=2.0)
    b.background = Background.gradient((0.1, 0.2, 0.3), (1, 1, 1))
    p = tmp_path / "scene.json"
    b.save(str(p))
    b2 = SceneBuilder.from_file(str(p))
    assert json.loads(json.dumps(b.to_json())) == b2.to_json()
    s1, s2 = b.build(), b2.build()
    np.testing.assert_array_equal(
        np.asarray(s1.spheres.center), np.asarray(s2.spheres.center)
    )
    np.testing.assert_array_equal(
        np.asarray(s1.spheres.neg_inv_density),
        np.asarray(s2.spheres.neg_inv_density),
    )


def test_reference_scene_schema_compat(reference_scenes, tmp_path):
    """Scenes load despite a missing clamp_indirect (Q1: the reference's
    shipped scene files omit it)."""
    import json

    for name in ("sphere_grid.json", "benchmark.json"):
        d = json.loads((reference_scenes / name).read_text())
        d["settings"].pop("clamp_indirect", None)
        path = tmp_path / name
        path.write_text(json.dumps(d))
        b = SceneBuilder.from_file(str(path))
        assert b.settings.clamp_indirect == 10.0
        scene = b.build()
        assert len(scene.spheres) == len(b.objects)


def test_png_roundtrip(tmp_path):
    img = (np.random.RandomState(0).rand(7, 5, 4) * 255).astype(np.uint8)
    p = tmp_path / "x.png"
    write_png(str(p), img)
    back = read_png(str(p))
    np.testing.assert_array_equal(img, back)


def test_color_raw_cast():
    from raytracingrust_tpu.utils.color import linear_to_raw
    vals = jnp.array([[-0.5, 0.0, 0.5], [1.0, 2.0, 0.999]])
    raw = np.asarray(linear_to_raw(vals))
    np.testing.assert_array_equal(raw, [[0, 0, 127], [255, 255, 254]])
