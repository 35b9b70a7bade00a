"""Normal/Random inspection views (the reference's trace_ray mode switch,
lib/core/render.rs:42-49) on the XLA engine, through its BVH traversal and
through the dense intersector.  The sphere kernel has no debug-view pass,
so these modes always run on XLA.
"""

import dataclasses

import numpy as np

from raytracingrust_tpu import (Camera, Lambertian, Mesh, Metal,
                                RenderSettings, SceneBuilder)
from raytracingrust_tpu.models.scene import (MODE_NORMAL, MODE_RANDOM,
                                             Background)
from raytracingrust_tpu.render.render import render_linear, select_engine


def scene(mode, bvh=True):
    """A 299-triangle fan (past the dense-intersector threshold, so the
    BVH build is traversed) over a ground sphere, beside a metal ball."""
    b = SceneBuilder()
    ml = b.add_material(Lambertian((0.7, 0.35, 0.2)))
    mm = b.add_material(Metal((0.85, 0.85, 0.9), 0.15))
    n = 300
    ang = np.linspace(0, 2 * np.pi, n, dtype=np.float32)
    rim = np.stack([0.7 * np.cos(ang), 0.25 + 0.12 * np.sin(3 * ang),
                    -1.0 + 0.7 * np.sin(ang)], 1)
    verts = np.concatenate([[[0, 0.45, -1.0]], rim]).astype(np.float32)
    faces = np.stack([np.zeros(n - 1, np.int32),
                      np.arange(1, n, dtype=np.int32),
                      1 + (np.arange(1, n, dtype=np.int32) % (n - 1))], -1)
    b.add_mesh(Mesh.from_buffers(verts, verts, faces, ml))
    b.add_sphere((0, -100.35, -1), 100.0, ml)
    b.add_sphere((0.55, 0.0, -0.6), 0.18, mm)
    b.camera = Camera.create((0, 0.4, 1.6), (0, 0.1, -1), (0, 1, 0),
                             60.0, 4 / 3)
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=6,
                                mode=mode, enable_bvh_tree=bvh)
    b.background = Background.gradient((0.9, 0.9, 1.0), (0.4, 0.55, 0.9))
    return b.build(with_bvh=bvh)


def _check_mode(mode):
    s = scene(mode)
    assert s.bvh is not None and s.num_primitives > 256
    bvh = np.asarray(render_linear(s, 20, 16, seed=3, engine="xla"))
    dense = np.asarray(render_linear(scene(mode, bvh=False), 20, 16, seed=3,
                                     engine="xla"))
    # single intersection pass: traversal and the dense scan pick the same
    # winners except on a handful of grazing rays
    neq = (np.abs(bvh - dense) > 1e-5).any(-1)
    assert neq.mean() <= 4 / (20 * 16), f"{neq.sum()} pixels differ"
    assert np.isfinite(bvh).all() and bvh.max() > 0


def test_normal_mode_kernel_parity():
    _check_mode(MODE_NORMAL)


def test_random_mode_kernel_parity():
    _check_mode(MODE_RANDOM)


def test_debug_modes_dispatch_to_kernel(monkeypatch):
    """Debug views never take the sphere kernel, even on a GPU and even on
    a sphere-only scene (it has no debug-view pass)."""
    from raytracingrust_tpu.ops.pallas_megakernel import supports
    from raytracingrust_tpu.render import render as render_mod

    class _Gpu:
        platform = "gpu"

    monkeypatch.setattr(render_mod.jax, "devices", lambda *a: [_Gpu()])
    s = scene(MODE_NORMAL)
    assert not supports(s)
    assert select_engine(s, "auto") == "xla"
    b = SceneBuilder()
    b.add_sphere((0, 0, -1), 0.5, b.add_material(Lambertian((1, 1, 1))))
    for mode in (MODE_NORMAL, MODE_RANDOM):
        b.settings = dataclasses.replace(b.settings, mode=mode)
        assert select_engine(b.build(), "auto") == "xla"
