"""The sphere kernel's Triton-route plumbing, checked on the CPU.

* interpret mode: cross-block cotangent sums, ray counts that do not fill
  a block, launch shapes, spp that is not a power of two;
* the wrapper: ray layout, padding, parameter packing;
* lowering: every kernel lowers to Triton IR for CUDA (``jax.jit(...)
  .trace(...).lower(lowering_platforms=("cuda",))`` needs no GPU), which
  catches an operation the Triton route cannot express before the card
  does.  Compiling that IR to PTX happens only on the card (chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracingrust_tpu import (Background, Camera, Dielectric, Emission,
                                Isotropic, Lambertian, Metal, MixMaterial,
                                RenderSettings, SceneBuilder)
from raytracingrust_tpu.diff.grad import apply_params, extract_params
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render.render import pixel_radiance
from raytracingrust_tpu.utils import rng


def unit_scene(spp=2, depth=3, variant="plain"):
    """Unit-scale spheres (the engines agree bitwise on these)."""
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=spp, max_ray_depth=depth,
                                enable_bvh_tree=False,
                                mode="Clay" if variant == "clay" else "Full")
    if variant == "gradient":
        b.background = Background.gradient((0.5, 0.7, 1.0), (1, 1, 1))
    if variant == "skymap":
        sky = (0.2 + np.random.RandomState(1).rand(4, 8, 3)).astype(
            np.float32)
        b.background = Background.skymap_from_array(sky)
    m1 = b.add_material(Lambertian((0.7, 0.4, 0.2)))
    m2 = b.add_material(Metal((0.9, 0.9, 0.9), 0.1))
    m3 = b.add_material(Emission((1.5, 1.2, 0.9)))
    m4 = b.add_material(Dielectric(1.5))
    if variant == "mix":
        m1 = b.add_material(MixMaterial(Lambertian((0.8, 0.2, 0.2)),
                                        Metal((0.9, 0.9, 0.9), 0.1), 0.4))
    b.add_sphere((0, -0.3, -1.2), 0.4, m1)
    b.add_sphere((0.8, 0.2, -1.5), 0.4, m2)
    b.add_sphere((-0.8, 0.2, -1.5), 0.4, m3)
    b.add_sphere((0.1, 0.5, -1.0), 0.25, m4)
    if variant == "volume":
        fog = b.add_material(Isotropic((0.8, 0.8, 0.9)))
        b.add_volume(b.add_sphere((0, 0.1, -2.0), 0.6, fog), 2.0)
    return b.build(with_bvh=False)


def kernel_pixels(scene, w, h, key, interpret=True, **launch):
    ids = jnp.arange(w * h, dtype=jnp.int32)
    return PK.pixel_radiance_pallas(scene, ids, w, h, key.astype(jnp.int32),
                                    kinds=PK.sphere_kinds(scene),
                                    interpret=interpret, **launch)


def xla_pixels(scene, w, h, key):
    ids = jnp.arange(w * h, dtype=jnp.int32)
    return pixel_radiance(scene, ids, w, h, key.astype(jnp.uint32))


# ---------------------------------------------------------------- wrapper

@pytest.mark.parametrize("n_pix,spp,block", [(7, 3, 8), (16, 4, 64),
                                             (5, 1, 32)])
def test_prep_rays_layout(n_pix, spp, block):
    """Ray ids are global (pixel * spp + sample); the tail pads to a whole
    block with ray 0 at pixel (0, 0)."""
    ids = jnp.arange(n_pix, dtype=jnp.int32) + 3
    ray_ids, px, py, n = PK._prep_rays(ids, spp, 4, block)
    assert n == n_pix * spp and ray_ids.shape[0] % block == 0
    assert ray_ids.shape[0] - n < block
    want = (np.arange(n_pix)[:, None] + 3) * spp + np.arange(spp)
    np.testing.assert_array_equal(np.asarray(ray_ids[:n]), want.ravel())
    np.testing.assert_array_equal(np.asarray(px[:n]),
                                  np.repeat((np.arange(n_pix) + 3) % 4, spp))
    np.testing.assert_array_equal(np.asarray(py[:n]),
                                  np.repeat((np.arange(n_pix) + 3) // 4, spp))
    assert not np.asarray(ray_ids[n:]).any()


def test_prep_rays_sample_slice():
    """A sample slice keeps the global ids of the full fan-out."""
    ids = jnp.arange(6, dtype=jnp.int32)
    full, *_ = PK._prep_rays(ids, 8, 3, 16)
    part, _, _, n = PK._prep_rays(ids, 8, 3, 16, sample_offset=2,
                                  n_samples=4)
    np.testing.assert_array_equal(
        np.asarray(part[:n]).reshape(6, 4),
        np.asarray(full[:48]).reshape(6, 8)[:, 2:6])


@pytest.mark.parametrize("variant", ["plain", "mix", "volume"])
def test_pack_fparams_layout(variant):
    scene = unit_scene(variant=variant)
    mix = bool(scene.materials.has_mix)
    fp = PK._pack_fparams(scene, 16, 12, mix=mix)
    stride = PK._sphere_stride(mix, scene.spheres.num_volumes > 0)
    assert fp.shape == (PK._SPHERES + len(scene.spheres) * stride,)
    rows = np.asarray(fp[PK._SPHERES:]).reshape(len(scene.spheres), stride)
    np.testing.assert_array_equal(rows[:, :3],
                                  np.asarray(scene.spheres.center))
    np.testing.assert_allclose(np.asarray(fp[PK._INV_W]), 1 / 15)


@pytest.mark.parametrize("n,want", [(1, 1), (5, 8), (64, 64), (80, 128)])
def test_pow2(n, want):
    assert PK._pow2(n) == want


# -------------------------------------------------------------- interpret

@pytest.mark.parametrize("block,warps", [(32, 1), (64, 2), (256, 4)])
def test_forward_launch_shapes_agree(block, warps):
    """The launch shape only regroups rays: every block size renders the
    same image, bitwise, and matches the XLA engine."""
    scene = unit_scene()
    key = rng.base_key(2)
    got = np.asarray(kernel_pixels(scene, 9, 7, key, block=block,
                                   num_warps=warps))
    want = np.asarray(xla_pixels(scene, 9, 7, key))
    np.testing.assert_array_equal(got, want)


def test_ray_count_not_filling_a_block():
    """7x5 pixels x 3 spp = 105 rays in one 128-ray block: the pad rays
    are traced and dropped."""
    scene = unit_scene(spp=3)
    key = rng.base_key(5)
    got = np.asarray(kernel_pixels(scene, 7, 5, key, block=128))
    np.testing.assert_array_equal(got, np.asarray(xla_pixels(scene, 7, 5,
                                                             key)))


def _grad_pair(scene, w, h, **launch):
    names = ("albedo", "emission", "bg_color_a")
    params = extract_params(scene, names)
    key = rng.base_key(0)

    def loss(p, fn):
        img = fn(apply_params(scene, p), w, h, key)
        return jnp.mean(img * jnp.cos(img))

    g_k = jax.grad(loss)(params, lambda *a: kernel_pixels(*a, **launch))
    g_x = jax.grad(loss)(params, xla_pixels)
    return g_k, g_x


def test_partial_cotangents_sum_over_blocks():
    """The grad kernel writes one partial cotangent row per program; with
    6 programs of 32 rays the rows must sum to the XLA gradient."""
    scene = unit_scene()
    g_k, g_x = _grad_pair(scene, 12, 8, grad_block=32, grad_warps=1)
    for k in g_x:
        np.testing.assert_allclose(np.asarray(g_k[k]), np.asarray(g_x[k]),
                                   rtol=2e-3, atol=2e-6, err_msg=k)


@pytest.mark.parametrize("spp", [3, 6])
def test_fused_mse_spp_not_power_of_two(spp):
    """Each pixel's rays pad to a power-of-two group; the throwaway rays
    must not reach the loss or its gradient.  The fused kernel must equal
    the MSE of the forward kernel's own image and the two-pass gradient
    (same paths), and XLA up to a borderline-hit flip."""
    from raytracingrust_tpu.diff.grad import make_loss

    scene = unit_scene(spp=spp)
    w, h = 6, 5
    key = rng.base_key(0)
    target = jnp.asarray(np.random.RandomState(spp).rand(h, w, 3),
                         jnp.float32)
    params = extract_params(scene, ("albedo", "emission"))
    v_k, g_k = jax.value_and_grad(
        make_loss(scene, target, w, h, engine="pallas"))(params)

    def twopass(p):
        img = kernel_pixels(apply_params(scene, p), w, h, key)
        return jnp.mean((img.reshape(h, w, 3) - target) ** 2)

    v_2, g_2 = jax.value_and_grad(twopass)(params)
    np.testing.assert_allclose(float(v_k), float(v_2), rtol=1e-6)
    for k in g_2:
        np.testing.assert_allclose(np.asarray(g_k[k]), np.asarray(g_2[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    v_x = make_loss(scene, target, w, h, engine="xla")(params)
    np.testing.assert_allclose(float(v_k), float(v_x), rtol=2e-2)


def test_fused_mse_partial_losses_over_blocks():
    """The fused kernel writes one partial loss per program: with 16-ray
    blocks the loss is the sum of 12 partials and equals the forward
    kernel's MSE."""
    scene = unit_scene(spp=4)
    w, h = 8, 6
    target = jnp.full((h, w, 3), 0.3, jnp.float32)
    key = rng.base_key(1).astype(jnp.int32)
    kinds = PK.sphere_kinds(scene)

    def fused(s):
        return PK.mse_loss_pallas(s, target, w, h, key, kinds=kinds,
                                  interpret=True, grad_block=16,
                                  grad_warps=1)

    v_fused = float(jax.value_and_grad(
        lambda p: fused(apply_params(scene, p)))(
            extract_params(scene, ("albedo",)))[0])
    v_plain = float(fused(scene))
    img = np.asarray(kernel_pixels(scene, w, h, rng.base_key(1)))
    v_img = float(np.mean((img.reshape(h, w, 3) - 0.3) ** 2))
    np.testing.assert_allclose(v_fused, v_img, rtol=1e-6)
    np.testing.assert_allclose(v_plain, v_img, rtol=1e-6)


# --------------------------------------------------------------- lowering

def _lower_for_cuda(fn, *args):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("variant", ["plain", "gradient", "skymap", "mix",
                                     "volume", "clay"])
@pytest.mark.parametrize("kernel", ["forward", "grad", "fused_mse"])
def test_kernels_lower_to_triton(variant, kernel):
    """Every kernel of every envelope class lowers through the Triton
    route (no Mosaic GPU) with ``interpret=False``."""
    scene = unit_scene(variant=variant)
    if kernel == "fused_mse" and not PK.supports_fused_mse(scene):
        kernel = "grad"  # skymap: the two-pass grad kernel serves fits
    w, h = 8, 4
    key = rng.base_key(0)
    params = extract_params(scene, ("albedo", "emission"))

    def fwd(p):
        return kernel_pixels(apply_params(scene, p), w, h, key,
                             interpret=False)

    if kernel == "forward":
        fn = fwd
    elif kernel == "grad":
        fn = jax.grad(lambda p: jnp.sum(fwd(p) ** 2))
    else:
        target = jnp.zeros((h, w, 3), jnp.float32)
        fn = jax.value_and_grad(lambda p: PK.mse_loss_pallas(
            apply_params(scene, p), target, w, h, key.astype(jnp.int32),
            kinds=PK.sphere_kinds(scene)))
    text = _lower_for_cuda(fn, params)
    n_calls = {"forward": 1, "grad": 2, "fused_mse": 1}[kernel]
    assert text.count("__gpu$xla.gpu.triton") == n_calls
    assert "mosaic" not in text.lower()


def test_kernel_names_are_stable():
    """Trace reductions find the kernels by name."""
    scene = unit_scene()
    key = rng.base_key(0)
    params = extract_params(scene, ("albedo",))
    text = _lower_for_cuda(
        jax.grad(lambda p: jnp.sum(kernel_pixels(
            apply_params(scene, p), 4, 4, key, interpret=False))), params)
    for name in ("rtrt_sphere_fwd", "rtrt_sphere_grad"):
        assert name in text


def test_unroll_limit_of_grad_envelope():
    """5 spheres at depth 12 is the largest measured grad kernel; one
    bounce more leaves the envelope (forward renders stay in it)."""
    assert PK.MAX_GRAD_UNROLL == 5 * 12
    ok = unit_scene(depth=3)
    ok = dataclasses.replace(ok, settings=dataclasses.replace(
        ok.settings, max_ray_depth=PK.MAX_GRAD_UNROLL // len(ok.spheres)))
    assert PK.supports_grad(ok) and PK.supports_fused_mse(ok)
    deep = dataclasses.replace(ok, settings=dataclasses.replace(
        ok.settings, max_ray_depth=ok.settings.max_ray_depth + 1))
    assert PK.supports(deep)
    assert not PK.supports_grad(deep) and not PK.supports_fused_mse(deep)
