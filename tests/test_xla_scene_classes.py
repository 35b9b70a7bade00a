"""Scene classes the XLA engine serves on every platform: meshes, nested
mixes, mesh-bounded volumes, volumes inside the BVH, HDRI skies, HDRI
importance sampling and deep chains.

Each class renders through the BVH traversal (forced, so small scenes
exercise it) against the dense intersector of the same engine, and the
sphere- and triangle-only classes against the NumPy oracle.  BVH and dense
scan search with different f32 arithmetic, so only discrete flips of
grazing hits may differ (tests/test_bvh.py:_assert_renders_match).
"""

import dataclasses

import numpy as np
import pytest

from raytracingrust_tpu import (Background, Camera, Dielectric, Emission,
                                Isotropic, Lambertian, Mesh, Metal,
                                MixMaterial, RenderSettings, SceneBuilder,
                                demo)
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render import integrator
from raytracingrust_tpu.render.render import render_linear


def _base(spp=2, depth=4, **settings):
    b = SceneBuilder()
    b.camera = Camera.create((0, 0.5, 2.5), (0, 0, -1), (0, 1, 0), 55.0,
                             1.2)
    b.settings = RenderSettings(samples_per_pixel=spp, max_ray_depth=depth,
                                **settings)
    b.background = Background.gradient((1, 1, 1), (0.5, 0.7, 1.0))
    return b


def _ball_grid(b, mats, n=4, radius=0.22):
    for i in range(n):
        for j in range(n):
            b.add_sphere(((i - (n - 1) / 2) * 0.55, radius,
                          -1.0 - j * 0.55), radius, mats[(i + j) % len(mats)])


def mesh_scene():
    b = _base()
    clay = b.add_material(Lambertian((0.7, 0.5, 0.4)))
    b.add_mesh(demo.icosphere((0, 0.3, -1.2), 0.5, clay, subdiv=2,
                              bump=0.1))
    floor = np.array([[-3, -0.2, 1], [3, -0.2, 1], [3, -0.2, -5],
                      [-3, -0.2, -5]], np.float32)
    b.add_mesh(Mesh.from_buffers(floor, floor,
                                 np.array([[0, 1, 2], [0, 2, 3]], np.int32),
                                 b.add_material(Metal((0.6, 0.7, 0.6),
                                                      0.3))))
    return b


def nested_mix_scene():
    b = _base()
    inner = MixMaterial(Lambertian((0.8, 0.2, 0.2)), Metal((0.9, 0.9, 0.9),
                                                           0.1), 0.5)
    mats = [b.add_material(MixMaterial(inner, Dielectric(1.5), 0.3)),
            b.add_material(MixMaterial(Lambertian((0.2, 0.3, 0.8)),
                                       Emission((2.0, 1.5, 1.0)), 0.6)),
            b.add_material(Lambertian((0.5, 0.5, 0.5)))]
    _ball_grid(b, mats)
    return b


def mesh_volume_scene():
    b = _base(depth=5)
    iso = b.add_material(Isotropic((0.7, 0.8, 0.9)))
    b.add_volume(b.add_mesh(demo.icosphere((0, 0.3, -1.3), 0.5, iso,
                                           subdiv=1)), 2.0)
    b.add_mesh(demo.icosphere((0.8, 0.2, -1.0), 0.25,
                              b.add_material(Lambertian((0.8, 0.4, 0.2))),
                              subdiv=2))
    b.add_sphere((-0.8, 0.9, -1.0), 0.3,
                 b.add_material(Emission((2.0, 1.8, 1.5))))
    return b


def volume_bvh_scene():
    b = _base(depth=5)
    mats = [b.add_material(Lambertian((0.6, 0.3, 0.3))),
            b.add_material(Metal((0.8, 0.8, 0.9), 0.2))]
    _ball_grid(b, mats)
    fog = b.add_material(Isotropic((0.8, 0.8, 0.9)))
    b.add_volume(b.add_sphere((0, 0.4, -1.6), 0.5, fog), 1.5)
    return b


def skymap_scene(env_is=False):
    b = _base(env_importance_sampling=env_is)
    sky = (0.2 + np.random.RandomState(3).rand(8, 16, 3) ** 2).astype(
        np.float32)
    sky[2, 5] = (8.0, 7.0, 6.0)  # a sun texel
    b.background = Background.skymap_from_array(sky)
    mats = [b.add_material(Lambertian((0.7, 0.6, 0.5))),
            b.add_material(Metal((0.9, 0.9, 0.9), 0.05))]
    _ball_grid(b, mats)
    return b


def deep_chain_scene():
    b = _base(spp=1, depth=50)
    mats = [b.add_material(Metal((0.95, 0.95, 0.95), 0.0)),
            b.add_material(Dielectric(1.5)),
            b.add_material(Lambertian((0.8, 0.8, 0.8)))]
    _ball_grid(b, mats)
    return b


CLASSES = {
    "mesh": mesh_scene,
    "nested_mix": nested_mix_scene,
    "mesh_volume": mesh_volume_scene,
    "volume_in_bvh": volume_bvh_scene,
    "skymap": skymap_scene,
    "env_is": lambda: skymap_scene(env_is=True),
    "deep_chain": deep_chain_scene,
}


def _render(builder, bvh, w=12, h=10, seed=1):
    builder.settings = dataclasses.replace(builder.settings,
                                           enable_bvh_tree=bvh)
    return np.asarray(render_linear(builder.build(with_bvh=bvh), w, h,
                                    seed=seed, engine="xla"))


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_bvh_path_matches_dense_path(name, monkeypatch):
    monkeypatch.setattr(integrator, "BRUTE_FORCE_THRESHOLD", 0)
    dense = _render(CLASSES[name](), bvh=False)
    bvh = _render(CLASSES[name](), bvh=True)
    assert np.isfinite(bvh).all() and bvh.max() > 0
    mismatched = (~np.isclose(bvh, dense, atol=1e-6)).mean()
    assert mismatched <= 0.02, f"{mismatched:.4f} of channels differ"
    assert np.abs(bvh - dense).mean() < 5e-3


# (render, fit) engine that "auto" picks on a GPU for each class
AUTO_ON_GPU = {
    "mesh": ("xla", "xla"),
    "nested_mix": ("xla", "xla"),
    "mesh_volume": ("xla", "xla"),
    # 17 x 5 and 16 x 4 sphere-bounces: past the grad kernels' unroll
    # bound, so fits run on XLA
    "volume_in_bvh": ("pallas", "xla"),
    "skymap": ("pallas", "xla"),
    "env_is": ("xla", "xla"),
    "deep_chain": ("pallas", "xla"),
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_class_engine_under_auto(name, monkeypatch):
    from raytracingrust_tpu.render import render as render_mod

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(render_mod.jax, "devices", lambda *a: [_Gpu()])
    scene = CLASSES[name]().build()
    got = tuple(render_mod.select_engine(scene, "auto", use=use)
                for use in ("render", "fit"))
    assert got == AUTO_ON_GPU[name]
    assert PK.supports(scene) == (got[0] == "pallas")


@pytest.mark.parametrize("name", ["mesh", "volume_in_bvh", "nested_mix"])
def test_class_matches_oracle(name):
    """The engine against the independent scalar NumPy oracle (identical
    uniforms per ray and stream) at a tiny size."""
    import sys
    import os

    sys.path.insert(0, os.path.dirname(__file__))
    from oracle import Oracle

    builder = CLASSES[name]()
    builder.settings = dataclasses.replace(builder.settings,
                                           samples_per_pixel=1,
                                           max_ray_depth=3)
    w, h = 6, 5
    got = np.asarray(render_linear(builder.build(), w, h, seed=0,
                                   engine="xla"))
    want = Oracle(builder).render_linear(w, h, seed=0)
    close = np.isclose(got, want, atol=2e-3, rtol=1e-3)
    assert 1.0 - close.mean() <= 0.05
    assert np.abs(got - want).mean() < 0.02
