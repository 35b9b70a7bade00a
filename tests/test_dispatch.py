"""The engine rule (render.resolve_engine).

"auto" picks the Triton sphere kernel only on a GPU and only within the
kernel's envelope for the use (renders, or fits with a bounded unrolled
size); everything else runs on the XLA engine.  An explicit
engine="pallas" interprets on the CPU (the tests) and raises on any other
platform.  Tests fake the platform by monkeypatching ``jax.devices``.
"""

import dataclasses

import numpy as np
import pytest

from raytracingrust_tpu import (Camera, Lambertian, Mesh, Metal,
                                MixMaterial, RenderSettings, SceneBuilder)
from raytracingrust_tpu.render import render as render_mod


class _FakeDevice:
    def __init__(self, platform):
        self.platform = platform


def _fake_platform(monkeypatch, platform):
    monkeypatch.setattr(render_mod.jax, "devices",
                        lambda *a: [_FakeDevice(platform)])


@pytest.fixture()
def on_gpu(monkeypatch):
    _fake_platform(monkeypatch, "gpu")


def sphere_scene(n=5, depth=6, with_bvh=True):
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=depth)
    m = b.add_material(Lambertian((0.5, 0.5, 0.5)))
    for i in range(n):
        b.add_sphere((float(i), 0, -2), 0.4, m)
    return b.build(with_bvh=with_bvh)


def tri_scene(depth=6):
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 3), (0, 0, 0), (0, 1, 0), 40.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=depth)
    m = b.add_material(Lambertian((0.7, 0.7, 0.7)))
    pos = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]],
                   np.float32)
    faces = np.array([[0, 1, 2], [1, 3, 2]], np.int32)
    b.add_mesh(Mesh.from_buffers(pos, np.zeros_like(pos), faces, m))
    return b.build(with_bvh=True)


def test_cpu_always_xla():
    assert render_mod.select_engine(sphere_scene(), "auto") == "xla"
    assert render_mod.select_engine(sphere_scene(), "auto",
                                    use="fit") == "xla"


def test_explicit_engine_passes_through(on_gpu):
    assert render_mod.select_engine(sphere_scene(), "xla") == "xla"
    assert render_mod.select_engine(sphere_scene(), "pallas") == "pallas"


def test_shallow_sphere_scene_takes_brute(on_gpu):
    # the benchmark scene's class: the sphere kernel, compiled (not
    # interpreted), for both the forward render and the fit
    assert render_mod.resolve_engine(sphere_scene(depth=6)) == \
        ("pallas", False)
    assert render_mod.resolve_engine(sphere_scene(depth=6), use="fit") == \
        ("pallas", False)


@pytest.mark.parametrize("n,depth,fit_engine", [
    (5, 6, "pallas"), (5, 12, "pallas"), (10, 6, "pallas"),
    (5, 13, "xla"), (11, 6, "xla"), (100, 6, "xla"),
])
def test_fit_envelope_bounds_unrolled_size(on_gpu, n, depth, fit_engine):
    """Fits take the kernel while spheres x bounces <= MAX_GRAD_UNROLL
    (the grad kernels' compile time grows faster than that product);
    forward renders take it at any size inside the envelope."""
    scene = sphere_scene(n=n, depth=depth)
    assert render_mod.select_engine(scene, "auto") == "pallas"
    assert render_mod.select_engine(scene, "auto", use="fit") == fit_engine


def test_triangle_scene_takes_xla(on_gpu):
    # triangles left the kernel; meshes run on the XLA engine's BVH
    assert render_mod.select_engine(tri_scene(), "auto") == "xla"
    assert render_mod.select_engine(tri_scene(), "auto", use="fit") == "xla"


def test_deep_chain_fit_takes_xla(on_gpu):
    # the forward keeps its early-out while_loop at any depth; the grad
    # kernels unroll, so deep fits run on XLA
    deep = sphere_scene(depth=50)
    assert render_mod.select_engine(deep, "auto") == "pallas"
    assert render_mod.select_engine(deep, "auto", use="fit") == "xla"
    with pytest.raises(ValueError, match="envelope"):
        render_mod.resolve_engine(deep, "pallas", use="fit")


def test_big_sphere_scene_takes_xla(on_gpu):
    from raytracingrust_tpu.ops.pallas_megakernel import MAX_UNROLLED_SPHERES

    big = sphere_scene(n=MAX_UNROLLED_SPHERES + 1)
    assert render_mod.select_engine(big, "auto") == "xla"


def test_explicit_pallas_interprets_on_cpu():
    assert render_mod.resolve_engine(sphere_scene(), "pallas") == \
        ("pallas", True)


@pytest.mark.parametrize("platform", ["rocm", "neuron"])
def test_explicit_pallas_raises_off_gpu(monkeypatch, platform):
    _fake_platform(monkeypatch, platform)
    with pytest.raises(ValueError, match="needs a GPU"):
        render_mod.resolve_engine(sphere_scene(), "pallas")
    # auto never reaches the kernel there
    assert render_mod.select_engine(sphere_scene(), "auto") == "xla"


def test_explicit_pallas_rejects_unsupported_scene(on_gpu):
    with pytest.raises(ValueError, match="envelope"):
        render_mod.resolve_engine(tri_scene(), "pallas")


def test_unknown_engine_raises():
    with pytest.raises(ValueError, match="unknown engine"):
        render_mod.resolve_engine(sphere_scene(), "packet")


def test_env_is_dispatch(on_gpu):
    # the kernel implements only the naive escape-lookup estimator: scenes
    # that ask for the MIS environment sampler always run on XLA
    from raytracingrust_tpu.models.backgrounds import Background

    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=6,
                                env_importance_sampling=True)
    m = b.add_material(Lambertian((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -2), 0.3, m)
    b.background = Background.skymap_from_array(
        np.ones((8, 16, 3), np.float32))
    env = b.build(with_bvh=True)
    assert render_mod.select_engine(env, "auto") == "xla"
    with pytest.raises(ValueError, match="envelope"):
        render_mod.resolve_engine(env, "pallas")
    # the same scene without the flag is kernel-eligible (skymap misses
    # are recorded and looked up after the kernel)
    plain = dataclasses.replace(env, settings=dataclasses.replace(
        env.settings, env_importance_sampling=False))
    assert render_mod.select_engine(plain, "auto") == "pallas"


def test_mix_scene_keeps_brute_kernel(on_gpu):
    # single-level mixes are inside the kernel; mix-of-mix is not
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.0)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=6)
    m = b.add_material(MixMaterial(
        Lambertian((0.5, 0.5, 0.5)), Metal((0.9, 0.9, 0.9), 0.1), 0.5))
    b.add_sphere((0, 0, -2), 0.5, m)
    assert render_mod.select_engine(b.build(), "auto") == "pallas"
    nested = b.add_material(MixMaterial(
        MixMaterial(Lambertian((0.1, 0.2, 0.3)), Metal((1, 1, 1), 0.0), 0.5),
        Lambertian((0.5, 0.5, 0.5)), 0.5))
    b.add_sphere((1, 0, -2), 0.5, nested)
    assert render_mod.select_engine(b.build(), "auto") == "xla"


def test_fused_mse_spp_gate():
    """ANY spp <= 256 runs the fused render->MSE->grad kernel: non-
    power-of-two spp pads each pixel's ray group to the next power of two
    with throwaway rays the loss ignores.  The reference DEFAULT spp=5
    (lib/core/scene.rs:42-65) must (a) pass the gate, (b) agree with the
    two-pass path near-exactly (real rays keep the global ray ids
    pixel*spp+s, so same winners + same uniforms), and (c) agree with XLA
    to engine tolerance."""
    import jax
    import jax.numpy as jnp

    from raytracingrust_tpu.diff.grad import (apply_params, extract_params,
                                              make_loss)
    from raytracingrust_tpu.ops.pallas_megakernel import supports_fused_mse
    from raytracingrust_tpu.render.render import render_linear

    s5 = sphere_scene(depth=4)
    s5 = dataclasses.replace(
        s5, settings=dataclasses.replace(s5.settings, samples_per_pixel=5))
    s8 = dataclasses.replace(
        s5, settings=dataclasses.replace(s5.settings, samples_per_pixel=8))
    s_big = dataclasses.replace(
        s5, settings=dataclasses.replace(s5.settings,
                                         samples_per_pixel=257))
    assert supports_fused_mse(s5)
    assert supports_fused_mse(s8)
    assert not supports_fused_mse(s_big)  # a pixel group must fit a block

    # spp=5 end to end: the FUSED kernel against the two-pass pallas loss
    # (same winners, same uniforms -> near-exact) and against XLA
    target = jnp.asarray(render_linear(s5, 8, 6, seed=9)) * 0.9
    params = extract_params(s5, ("albedo",))

    def twopass(p, key=None):
        img = render_linear(apply_params(s5, p), 8, 6, seed=0, key=key,
                            engine="pallas")
        return jnp.mean((img - target) ** 2)

    g_f = jax.value_and_grad(
        make_loss(s5, target, 8, 6, seed=0, engine="pallas"))(params)
    g_2 = jax.value_and_grad(twopass)(params)
    g_x = jax.value_and_grad(
        make_loss(s5, target, 8, 6, seed=0, engine="xla"))(params)
    # interpret-mode kernels are ulp-sensitive to the surrounding
    # compilation: borderline paths can flip between the fused and
    # two-pass programs, so the engine-family tolerances apply
    np.testing.assert_allclose(float(g_f[0]), float(g_2[0]), rtol=3e-2)
    np.testing.assert_allclose(np.asarray(g_f[1]["albedo"]),
                               np.asarray(g_2[1]["albedo"]),
                               rtol=5e-2, atol=2e-3)
    np.testing.assert_allclose(float(g_f[0]), float(g_x[0]), rtol=1e-2)
    a = np.asarray(g_f[1]["albedo"])
    b = np.asarray(g_x[1]["albedo"])
    rel = np.abs(a - b) / (np.abs(b) + 1e-3)
    assert rel.max() < 5e-2, f"grad rel err {rel.max()}"
