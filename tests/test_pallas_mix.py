"""Megakernel coverage of mix + isotropic materials (interpret mode, CPU).

The reference blends materials stochastically per scatter call
(lib/materials.rs:141-157) and scatters isotropically inside volumes
(lib/volume.rs:75-88).  The sphere kernel bakes single-level
mixes as TWO leaf parameter sets per primitive, resolved with the same
level-0 mix coin the XLA engine draws (ops/shade.py resolve_mix), so
sphere-only scenes must stay bit-identical across engines.
"""

import numpy as np
import jax
import jax.numpy as jnp

from raytracingrust_tpu import (
    Camera,
    Dielectric,
    Emission,
    Isotropic,
    Lambertian,
    Metal,
    MixMaterial,
    RenderSettings,
    SceneBuilder,
)
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render.render import render_linear


def _mix_sphere_scene(spp=2, depth=4, unit_scale=True):
    """Mix + isotropic sphere scene.  ``unit_scale`` keeps all spheres
    small so the kernel's direct quadratic and XLA's matmul expansion agree
    bitwise (test_pallas.py:test_pallas_near_bit_identical_unit_scale); with a
    radius-100 ground the acne re-hit near tmin can flip per sample."""
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=spp, max_ray_depth=depth,
                                enable_bvh_tree=False)
    mmix = b.add_material(MixMaterial(
        Lambertian((0.8, 0.2, 0.2)), Metal((0.9, 0.9, 0.9), 0.1), 0.4))
    mmix2 = b.add_material(MixMaterial(
        Dielectric(1.5), Emission((1.5, 1.2, 0.9)), 0.7))
    mlam = b.add_material(Lambertian((0.2, 0.6, 0.3)))
    miso = b.add_material(Isotropic((0.7, 0.7, 0.9)))
    if unit_scale:
        b.add_sphere((0, -0.9, -1.2), 0.5, mlam)
    else:
        b.add_sphere((0, -100.5, -1), 100.0, mlam)
    b.add_sphere((0, 0, -1), 0.5, mmix)
    b.add_sphere((1.1, 0.1, -1.3), 0.5, mmix2)
    b.add_sphere((-1.1, 0, -1), 0.5, miso)
    return b.build(with_bvh=False)


def test_repo_demo_scenes_on_fast_path():
    """VERDICT round-1 item 4: the shipped demo scenes (mixes in
    material_zoo, a volume in cornell_spheres) must be inside the sphere
    kernel's envelope."""
    import pathlib

    from raytracingrust_tpu.models.scene import load_scene

    root = pathlib.Path(__file__).resolve().parent.parent / "scenes"
    zoo = load_scene(str(root / "material_zoo.json"))
    cornell = load_scene(str(root / "cornell_spheres.json"))
    assert PK.supports(zoo), "material_zoo (mix materials) off the fast path"
    assert PK.supports(cornell), "cornell_spheres (volume) off the fast path"


def test_supports_single_level_mix_and_iso():
    scene = _mix_sphere_scene()
    assert scene.materials.has_mix
    assert PK.supports(scene)


def test_supports_rejects_nested_mix():
    b = SceneBuilder()
    nested = MixMaterial(
        MixMaterial(Lambertian((0.5, 0.5, 0.5)), Metal((0.9, 0.9, 0.9),
                                                       0.0), 0.5),
        Lambertian((0.1, 0.1, 0.1)), 0.3)
    m = b.add_material(nested)
    b.add_sphere((0, 0, -1), 0.5, m)
    scene = b.build(with_bvh=False)
    assert not PK.supports(scene)


def test_mix_iso_spheres_bit_identical_unit_scale():
    """Unit-scale mix+iso scene: both engines draw the same mix coins and
    bake identical leaf parameters, so samples are bit-identical except
    for the usual couple of borderline intersector flips."""
    scene = _mix_sphere_scene()
    xla = np.asarray(render_linear(scene, 24, 24, seed=0, engine="xla"))
    pal = np.asarray(render_linear(scene, 24, 24, seed=0, engine="pallas"))
    neq = (xla != pal).any(-1)
    assert neq.mean() <= 2 / (24 * 24), f"{neq.sum()} pixels differ"
    np.testing.assert_array_equal(pal[~neq], xla[~neq])


def test_mix_iso_spheres_with_ground_close():
    """With the radius-100 ground the engines keep the usual acne-flip
    tolerance (same bound as test_pallas.py:assert_engines_agree)."""
    scene = _mix_sphere_scene(unit_scale=False)
    xla = np.asarray(render_linear(scene, 16, 12, seed=0, engine="xla"))
    pal = np.asarray(render_linear(scene, 16, 12, seed=0, engine="pallas"))
    mismatched = (~np.isclose(xla, pal, atol=1e-4, rtol=1e-3)).mean()
    assert mismatched <= 0.08, f"{mismatched:.4f} channels differ"
    assert np.abs(xla - pal).mean() < 4e-2


def test_mix_uniform_column_alignment():
    """has_mix shifts every bounce's lobe-uniform columns by MAX_MIX_DEPTH
    in BOTH engines: rendering the same geometry with an all-A mix (factor 0
    -> always first leaf) must equal the plain-material render only when
    both sides carry the mix (stream alignment), and differ from the
    mix-free scene (shifted columns -> different sample paths)."""
    def build(use_mix):
        b = SceneBuilder()
        b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
        b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=3,
                                    enable_bvh_tree=False)
        lam = Lambertian((0.7, 0.4, 0.2))
        # factor = 0.0: u >= 0 always -> always leaf A
        m = b.add_material(MixMaterial(lam, Metal((1, 1, 1), 0.0), 0.0)
                           if use_mix else lam)
        b.add_sphere((0, 0, -1), 0.5, m)
        b.add_sphere((0, -0.9, -1.2), 0.5, b.add_material(
            Lambertian((0.4, 0.4, 0.4))))
        return b.build(with_bvh=False)

    mix_x = np.asarray(render_linear(build(True), 16, 16, seed=0,
                                     engine="xla"))
    mix_p = np.asarray(render_linear(build(True), 16, 16, seed=0,
                                     engine="pallas"))
    plain = np.asarray(render_linear(build(False), 16, 16, seed=0,
                                     engine="xla"))
    neq = (mix_x != mix_p).any(-1)
    assert neq.mean() <= 2 / (16 * 16), f"{neq.sum()} pixels differ"
    assert not np.array_equal(mix_x, plain)


def test_mix_grad_matches_xla():
    """Gradients w.r.t. leaf albedos/fuzz flow through both baked parameter
    sets in the fused Pallas backward; must match the XLA reverse chain."""
    from raytracingrust_tpu.diff.grad import apply_params, extract_params

    scene = _mix_sphere_scene(spp=2, depth=3)
    params = extract_params(scene, ("albedo", "fuzz", "emission"))

    def make_loss(engine):
        def loss(p):
            s = apply_params(scene, p)
            img = render_linear(s, 12, 8, seed=0, engine=engine,
                                tile_rays=1 << 20)
            return jnp.mean(img * jnp.cos(img))
        return loss

    g_xla = jax.grad(make_loss("xla"))(params)
    g_pal = jax.grad(make_loss("pallas"))(params)
    for k in g_xla:
        np.testing.assert_allclose(
            np.asarray(g_pal[k]), np.asarray(g_xla[k]),
            rtol=2e-3, atol=2e-5, err_msg=f"param {k}",
        )
    # the mix children's rows must actually receive gradient
    assert np.abs(np.asarray(g_xla["albedo"])[4:]).sum() > 0


def _volume_scene(depth=5):
    """Constant-density volume sphere + solid spheres + an emitter."""
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=depth,
                                enable_bvh_tree=False)
    miso = b.add_material(Isotropic((0.8, 0.8, 0.9)))
    mlam = b.add_material(Lambertian((0.5, 0.3, 0.2)))
    me = b.add_material(Emission((2.0, 1.8, 1.6)))
    s0 = b.add_sphere((0, 0, -1.2), 0.5, miso)
    b.add_volume(s0, 3.0)
    b.add_sphere((0, -0.9, -1.2), 0.5, mlam)
    b.add_sphere((1.0, 0.6, -1.0), 0.3, me)
    return b.build(with_bvh=False)


def test_volume_scene_supported_and_bit_identical():
    """Volumes in the brute kernel: each volume's free-flight uniform
    column is statically indexed in the unrolled sphere loop (volumes sort
    last in the sphere SoA), and the free-flight math follows
    ops/intersect.py sphere_ts op-for-op — renders are bit-identical."""
    scene = _volume_scene()
    assert scene.spheres.num_volumes == 1
    assert PK.supports(scene)
    xla = np.asarray(render_linear(scene, 16, 12, seed=0, engine="xla"))
    pal = np.asarray(render_linear(scene, 16, 12, seed=0, engine="pallas"))
    np.testing.assert_array_equal(pal, xla)


def test_volume_grad_matches_xla():
    """Gradients through a volume scene (albedo of the phase function and
    the solid spheres, emission) via the fused Pallas backward."""
    from raytracingrust_tpu.diff.grad import apply_params, extract_params

    scene = _volume_scene(depth=4)
    params = extract_params(scene, ("albedo", "emission"))

    def make_loss(engine):
        def loss(p):
            s = apply_params(scene, p)
            img = render_linear(s, 12, 8, seed=0, engine=engine,
                                tile_rays=1 << 20)
            return jnp.mean(img * jnp.cos(img))
        return loss

    g_xla = jax.grad(make_loss("xla"))(params)
    g_pal = jax.grad(make_loss("pallas"))(params)
    for k in g_xla:
        np.testing.assert_allclose(
            np.asarray(g_pal[k]), np.asarray(g_xla[k]),
            rtol=2e-3, atol=2e-5, err_msg=f"param {k}",
        )
    assert np.abs(np.asarray(g_xla["albedo"])).sum() > 0
