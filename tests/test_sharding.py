"""Multi-device tests on the 8-way virtual CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import jax
import numpy as np
import pytest

from raytracingrust_tpu import Lambertian, Metal, RenderSettings, SceneBuilder
from raytracingrust_tpu.parallel.sharding import (
    make_mesh,
    render_linear_sharded,
)
from raytracingrust_tpu.render.render import render_linear


def scene_builder():
    b = SceneBuilder()
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=4)
    m = b.add_material(Lambertian((0.6, 0.4, 0.3)))
    mm = b.add_material(Metal((0.9, 0.9, 0.9), 0.05))
    b.add_sphere((0, -100.5, -1), 100.0, m)
    b.add_sphere((0, 0, -1.2), 0.5, mm)
    return b


def test_eight_virtual_devices():
    assert jax.device_count() >= 8


def test_sharded_matches_single_device():
    """Shard-invariance: N-device render == 1-device render, bitwise-ish
    (the RNG is keyed by global ray id, never by shard)."""
    scene = scene_builder().build()
    single = np.asarray(render_linear(scene, 16, 8, seed=5, tile_rays=1 << 20))
    mesh8 = make_mesh(jax.devices()[:8])
    multi = np.asarray(render_linear_sharded(scene, 16, 8, mesh=mesh8, seed=5))
    np.testing.assert_allclose(single, multi, atol=1e-6)


def test_sharded_mesh_sizes_agree():
    scene = scene_builder().build()
    a = np.asarray(
        render_linear_sharded(scene, 12, 8, mesh=make_mesh(jax.devices()[:2]),
                              seed=1)
    )
    b = np.asarray(
        render_linear_sharded(scene, 12, 8, mesh=make_mesh(jax.devices()[:8]),
                              seed=1)
    )
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_non_divisible_pixel_count():
    """19x7 = 133 pixels does not divide 8 — padding must not corrupt."""
    scene = scene_builder().build()
    single = np.asarray(render_linear(scene, 19, 7, seed=2, tile_rays=1 << 20))
    multi = np.asarray(
        render_linear_sharded(scene, 19, 7, mesh=make_mesh(jax.devices()[:8]),
                              seed=2)
    )
    np.testing.assert_allclose(single, multi, atol=1e-6)


@pytest.mark.parametrize("n_dev", [2, 4])
def test_sharded_kernel_render_matches_single(n_dev):
    """The sphere kernel per shard inside shard_map (interpret mode here):
    the N-device kernel render equals the 1-device kernel render."""
    scene = scene_builder().build()
    single = np.asarray(render_linear(scene, 12, 8, seed=4,
                                      engine="pallas"))
    multi = render_linear_sharded(scene, 12, 8, seed=4, engine="pallas",
                                  mesh=make_mesh(jax.devices()[:n_dev]))
    np.testing.assert_allclose(single, multi, atol=1e-6)
