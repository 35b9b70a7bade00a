"""Sphere kernel tests (the Triton-route Pallas kernels in interpret mode
on CPU).

The kernel's in-lane threefry must be bit-exact with jax.random's cipher and
derivation chain, and the rendered image must match the XLA integrator up to
f32 arithmetic-order noise (the two consume identical uniform draws).
"""

import numpy as np
import jax
import jax.numpy as jnp

from raytracingrust_tpu import (
    Background,
    Camera,
    Dielectric,
    Emission,
    Lambertian,
    Metal,
    RenderSettings,
    SceneBuilder,
)
from raytracingrust_tpu.ops import pallas_megakernel as PK
from raytracingrust_tpu.render.render import render_linear


def _np_threefry2x32(k0, k1, x0, x1, rounds):
    """Independent NumPy Threefry-2x32 (Random123 general-R loop) — the
    ground truth for the production 13-round cipher."""
    rots = (13, 15, 26, 6, 17, 29, 16, 24)
    u32 = np.uint32
    with np.errstate(over="ignore"):
        ks = (k0, k1, (k0 ^ k1 ^ u32(0x1BD11BDA)).astype(np.uint32))
        x0 = (x0 + ks[0]).astype(u32)
        x1 = (x1 + ks[1]).astype(u32)
        for i in range(rounds):
            r = rots[i % 8]
            x0 = (x0 + x1).astype(u32)
            x1 = (((x1 << u32(r)) | (x1 >> u32(32 - r))).astype(u32)
                  ^ x0)
            if i % 4 == 3:
                j = i // 4 + 1
                x0 = (x0 + ks[j % 3]).astype(u32)
                x1 = (x1 + ks[(j + 1) % 3] + u32(j)).astype(u32)
    return x0, x1


def test_threefry_cipher():
    """The general-R loop at 20 rounds is bit-exact with jax.random's
    reference cipher (validates the round/injection schedule); the
    production 13-round cipher matches an independent NumPy
    implementation (validates what both engines actually consume)."""
    from raytracingrust_tpu.utils.rng import THREEFRY_ROUNDS

    assert THREEFRY_ROUNDS == 13  # Random123's BigCrush-validated variant
    rs = np.random.RandomState(0)
    k = rs.randint(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)
    x = rs.randint(0, 2**32, size=(2, 64), dtype=np.uint64).astype(np.uint32)

    got20 = PK.threefry2x32(
        jnp.asarray(k[0]), jnp.asarray(k[1]),
        jnp.asarray(x[0]), jnp.asarray(x[1]), rounds=20,
    )
    from jax.extend.random import threefry_2x32
    want = np.stack([
        np.asarray(
            threefry_2x32(jnp.asarray([k[0][i], k[1][i]]),
                          jnp.asarray([x[0][i], x[1][i]], jnp.uint32))
        )
        for i in range(64)
    ])
    np.testing.assert_array_equal(np.asarray(got20[0]), want[:, 0])
    np.testing.assert_array_equal(np.asarray(got20[1]), want[:, 1])

    got13 = PK.threefry2x32(
        jnp.asarray(k[0]), jnp.asarray(k[1]),
        jnp.asarray(x[0]), jnp.asarray(x[1]),
    )
    want13 = _np_threefry2x32(k[0], k[1], x[0], x[1], 13)
    np.testing.assert_array_equal(np.asarray(got13[0]), want13[0])
    np.testing.assert_array_equal(np.asarray(got13[1]), want13[1])


def test_kernel_uniform_layout_matches_rng_module():
    """The kernel-side uniform construction must be byte-identical to
    rng.ray_uniforms — that equality is what makes megakernel and XLA
    integrator renders comparable sample-for-sample."""
    from raytracingrust_tpu.utils import rng

    seed = 1234
    ray_ids = jnp.arange(32, dtype=jnp.int32) * 7 + 3
    stream = 5
    key = rng.base_key(seed)

    k0 = jnp.full((32,), 0, jnp.uint32) + key[0]
    k1 = jnp.full((32,), 0, jnp.uint32) + key[1]
    got = np.stack([
        np.asarray(u)
        for u in PK._stream_uniforms(k0, k1, ray_ids.astype(jnp.uint32),
                                     stream, 3)
    ], axis=1)

    want = np.asarray(rng.ray_uniforms(key, ray_ids, stream, 3))
    np.testing.assert_array_equal(got, want)

    # uniforms are well-distributed and distinct across rays/streams
    other = np.asarray(rng.ray_uniforms(key, ray_ids, stream + 1, 3))
    assert (got >= 0).all() and (got < 1).all()
    assert not np.array_equal(got, other)


def benchmark_like_builder(mode="Full", bg=None):
    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=4,
                                enable_bvh_tree=False, mode=mode)
    if bg is not None:
        b.background = bg
    ground = b.add_material(Lambertian((0.8, 0.8, 0.4)))
    red = b.add_material(Lambertian((0.8, 0.1, 0.1)))
    mirror = b.add_material(Metal((1.0, 1.0, 1.0), 0.03))
    glass = b.add_material(Dielectric(1.5))
    sun = b.add_material(Emission((2.0, 2.0, 2.0)))
    b.add_sphere((10, 15.8, -1), 10.0, sun)
    b.add_sphere((1, 0, -1), 0.5, mirror)
    b.add_sphere((-1, 0, -1), 0.5, glass)
    b.add_sphere((0, -0.2, -1), 0.3, red)
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    return b


def assert_engines_agree(builder, w=16, h=12, seed=0, frac=0.08):
    """The kernel searches with the direct quadratic, XLA brute force with
    the matmul expansion — on huge spheres (radius 100 ground) the f32 acne
    re-hit near tmin can flip per sample, like BVH-vs-brute.  On unit-scale
    scenes the engines are BIT-IDENTICAL (test below)."""
    scene = builder.build(with_bvh=False)
    assert PK.supports(scene)
    xla = np.asarray(render_linear(scene, w, h, seed=seed, engine="xla"))
    pal = np.asarray(render_linear(scene, w, h, seed=seed, engine="pallas"))
    mismatched = (~np.isclose(xla, pal, atol=1e-4, rtol=1e-3)).mean()
    assert mismatched <= frac, (
        f"{mismatched:.4f} channels differ; max "
        f"{np.abs(xla - pal).max():.5f}"
    )
    assert np.abs(xla - pal).mean() < 4e-2


def test_pallas_near_bit_identical_unit_scale():
    # "near": shared RNG makes samples bit-identical EXCEPT where a
    # borderline hit decision flips between intersector formulations
    # (matmul vs direct quadratic); at most a couple of pixels may differ,
    # and every non-flipped pixel must match exactly.
    from raytracingrust_tpu import Isotropic  # noqa: F401  (import parity)

    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=4,
                                enable_bvh_tree=False)
    m1 = b.add_material(Lambertian((0.7, 0.4, 0.2)))
    m2 = b.add_material(Metal((0.9, 0.9, 0.9), 0.1))
    m3 = b.add_material(Emission((1.5, 1.2, 0.9)))
    m4 = b.add_material(Dielectric(1.5))
    b.add_sphere((0, -0.3, -1.2), 0.4, m1)
    b.add_sphere((0.8, 0.2, -1.5), 0.4, m2)
    b.add_sphere((-0.8, 0.2, -1.5), 0.4, m3)
    b.add_sphere((0.1, 0.5, -1.0), 0.25, m4)
    scene = b.build(with_bvh=False)
    xla = np.asarray(render_linear(scene, 16, 12, seed=0, engine="xla"))
    pal = np.asarray(render_linear(scene, 16, 12, seed=0, engine="pallas"))
    # identical uniforms -> identical samples, except where a borderline
    # hit decision flips between the two intersector formulations (matmul
    # vs direct quadratic); allow at most a couple of such pixels
    neq = (xla != pal).any(-1)
    assert neq.mean() <= 2 / (16 * 12), f"{neq.sum()} pixels differ"
    np.testing.assert_array_equal(xla[~neq], pal[~neq])


def test_pallas_matches_xla_full():
    assert_engines_agree(benchmark_like_builder())


def test_pallas_matches_xla_clay():
    # clay scatters at EVERY hit, so rays interact with the acne-prone
    # ground sphere more often -> more per-sample flips
    assert_engines_agree(benchmark_like_builder(mode="Clay"), frac=0.12)


def test_pallas_matches_xla_gradient_bg():
    assert_engines_agree(
        benchmark_like_builder(bg=Background.gradient((0.5, 0.7, 1.0),
                                                      (1.0, 1.0, 1.0)))
    )


def test_supports_gate():
    from raytracingrust_tpu import Isotropic, MixMaterial

    b = benchmark_like_builder()
    assert PK.supports(b.build(with_bvh=False))
    # round 2: single-level mixes, isotropic, and volumes are IN the
    # kernel envelope (tests/test_pallas_mix.py has the parity tests)
    b2 = benchmark_like_builder()
    b2.add_material(MixMaterial(Lambertian((1, 0, 0)), Dielectric(1.5), 0.5))
    assert PK.supports(b2.build(with_bvh=False))
    b3 = benchmark_like_builder()
    iso = b3.add_material(Isotropic((0.5, 0.5, 0.5)))
    idx = b3.add_sphere((0, 3, -1), 0.5, iso)
    b3.add_volume(idx, 2.0)
    assert PK.supports(b3.build(with_bvh=False))
    # still out: mix-of-mix (needs per-lane table gathers) and the debug
    # view modes
    b4 = benchmark_like_builder()
    b4.add_material(MixMaterial(
        MixMaterial(Lambertian((1, 0, 0)), Lambertian((0, 1, 0)), 0.5),
        Dielectric(1.5), 0.5))
    assert not PK.supports(b4.build(with_bvh=False))
    b5 = benchmark_like_builder(mode="Normal")
    assert not PK.supports(b5.build(with_bvh=False))


# ------------------------------------------------------- differentiable path

def _pallas_grad_setup(w=12, h=8):
    """Loss grads via both engines on the unit-scale scene (where the
    engines are bit-identical forward, so reparameterized gradients must
    agree too — both consume the same uniforms)."""
    from raytracingrust_tpu.diff.grad import apply_params, extract_params

    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=3,
                                enable_bvh_tree=False)
    m1 = b.add_material(Lambertian((0.7, 0.4, 0.2)))
    m2 = b.add_material(Metal((0.9, 0.9, 0.9), 0.1))
    m3 = b.add_material(Emission((1.5, 1.2, 0.9)))
    m4 = b.add_material(Dielectric(1.5))
    b.add_sphere((0, -0.3, -1.2), 0.4, m1)
    b.add_sphere((0.8, 0.2, -1.5), 0.4, m2)
    b.add_sphere((-0.8, 0.2, -1.5), 0.4, m3)
    b.add_sphere((0.1, 0.5, -1.0), 0.25, m4)
    scene = b.build(with_bvh=False)

    names = ("albedo", "fuzz", "ir", "emission", "cam_lookfrom", "bg_color_a")
    params = extract_params(scene, names)

    def make_loss(engine):
        def loss(p):
            s = apply_params(scene, p)
            img = render_linear(s, w, h, seed=0, engine=engine,
                                tile_rays=1 << 20)
            return jnp.mean(img * jnp.cos(img))  # nontrivial cotangents
        return loss

    return params, make_loss


def test_pallas_grad_matches_xla():
    """The fused Pallas fwd+bwd kernel must reproduce the XLA reverse-mode
    gradients (identical RNG -> identical paths -> same derivative chain)."""
    params, make_loss = _pallas_grad_setup()
    g_xla = jax.grad(make_loss("xla"))(params)
    g_pal = jax.grad(make_loss("pallas"))(params)
    for k in g_xla:
        np.testing.assert_allclose(
            np.asarray(g_pal[k]), np.asarray(g_xla[k]),
            rtol=2e-3, atol=2e-5,
            err_msg=f"param {k}",
        )


def test_pallas_value_and_grad_consistent():
    """value_and_grad primal via the custom_vjp forward must equal the plain
    forward render (the early-out while_loop and the unrolled replay are the
    same math)."""
    params, make_loss = _pallas_grad_setup()
    loss = make_loss("pallas")
    v_plain = loss(params)
    v_vjp, _ = jax.value_and_grad(loss)(params)
    np.testing.assert_allclose(float(v_plain), float(v_vjp), rtol=1e-6)


def test_pallas_skymap_background():
    """SKYMAP scenes run the miss-record path: the kernel returns
    (radiance, miss dir, miss throughput) and the driver adds
    throughput * sky(dir) with one batched XLA gather.  Must agree with
    the XLA engine like the other backgrounds — and since the records ride
    the custom_vjp, supports() (differentiable) now includes SKYMAP."""
    rs = np.random.RandomState(5)
    img = (0.2 + rs.rand(8, 16, 3) ** 2).astype(np.float32)
    img[1, 3] = (9.0, 7.0, 5.0)  # bright sun texel
    b = benchmark_like_builder(bg=Background.skymap_from_array(img))
    scene = b.build(with_bvh=False)
    assert PK.supports(scene)
    xla = np.asarray(render_linear(scene, 24, 20, seed=0, engine="xla"))
    pal = np.asarray(render_linear(scene, 24, 20, seed=0, engine="pallas"))
    # most channels are EXACTLY equal; the rest are isolated borderline-hit
    # flips whose magnitude the bright sun texel amplifies (cf. the 0.12
    # clay tolerance)
    assert (xla == pal).mean() > 0.9
    mismatched = (~np.isclose(xla, pal, atol=1e-4, rtol=1e-3)).mean()
    assert mismatched <= 0.08, f"{mismatched:.4f} channels differ"
    assert np.abs(xla - pal).mean() < 4e-2


def test_pallas_skymap_grad_matches_xla():
    """SKYMAP differentiability through the custom_vjp pair: the 6 miss-
    record outputs carry the equirect gather's cotangents (throughput terms)
    into the fused backward kernel.  Gradients w.r.t. material albedo
    (kernel-side) AND the sky texels (_env_finish-side) must match XLA."""
    import dataclasses

    rs = np.random.RandomState(7)
    img0 = (0.2 + rs.rand(6, 12, 3) ** 2).astype(np.float32)
    b = benchmark_like_builder(bg=Background.skymap_from_array(img0))
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=2,
                                     max_ray_depth=3)
    scene = b.build(with_bvh=False)
    assert PK.supports(scene)

    def make_loss(engine):
        def loss(p):
            mats = dataclasses.replace(
                scene.materials,
                albedo=scene.materials.albedo.at[0].set(p["albedo"]))
            bg = dataclasses.replace(scene.background, image=p["sky"])
            s2 = dataclasses.replace(scene, materials=mats, background=bg)
            img = render_linear(s2, 16, 12, seed=0, engine=engine)
            return jnp.sum(img ** 2)
        return loss

    p0 = {"albedo": jnp.array([0.7, 0.4, 0.2], jnp.float32),
          "sky": jnp.asarray(img0)}
    v_x = float(make_loss("xla")(p0))
    loss_p = jax.jit(make_loss("pallas"))
    v_p, g_p = jax.jit(jax.value_and_grad(make_loss("pallas")))(p0)
    # engines agree up to borderline-hit flips (a flipped sample under a
    # bright sky texel moves the sum-of-squares loss by ~1%)
    np.testing.assert_allclose(float(v_p), v_x, rtol=3e-2)

    # AD of the custom_vjp vs central finite differences of the SAME
    # (pallas) loss — exact up to f32 noise, immune to engine flips.
    # Albedo: all 3 components; sky: a handful of texels.
    eps = 1e-3

    def fd(path, idx):
        def bump(sign):
            p = dict(p0)
            p[path] = p0[path].at[idx].add(sign * eps)
            return float(loss_p(p))
        return (bump(+1) - bump(-1)) / (2 * eps)

    for i in range(3):
        want = fd("albedo", i)
        got = float(g_p["albedo"][i])
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-2)
    checked_nonzero = 0
    for (y, x, c) in [(0, 0, 0), (2, 5, 1), (5, 11, 2), (3, 7, 0)]:
        want = fd("sky", (y, x, c))
        got = float(g_p["sky"][y, x, c])
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-2)
        checked_nonzero += abs(got) > 0
    # the sky-texel gradient must actually be live (gather cotangents flow)
    assert checked_nonzero >= 1
    assert float(jnp.abs(g_p["sky"]).sum()) > 0.0


def test_make_loss_fit_path_via_pallas():
    """The PRODUCT fit path (diff.grad.make_loss) must route through the
    Pallas custom_vjp when asked and reproduce the XLA gradients, including
    with a per-step TRACED key (diff.inverse.fit reseeds without
    recompiling)."""
    from raytracingrust_tpu.diff.grad import (apply_params, extract_params,
                                              make_loss)
    from raytracingrust_tpu.utils import rng

    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=2, max_ray_depth=3,
                                enable_bvh_tree=False)
    m1 = b.add_material(Lambertian((0.7, 0.4, 0.2)))
    m2 = b.add_material(Emission((1.5, 1.2, 0.9)))
    b.add_sphere((0, -0.3, -1.2), 0.4, m1)
    b.add_sphere((-0.8, 0.2, -1.5), 0.4, m2)
    scene = b.build(with_bvh=False)
    target = render_linear(scene, 12, 8, seed=3, engine="xla")
    params = extract_params(scene, ("albedo", "emission"))

    for key in (None, rng.base_key(11)):
        l_xla = make_loss(scene, target, 12, 8, seed=0, engine="xla")
        l_pal = make_loss(scene, target, 12, 8, seed=0, engine="pallas")
        v_x, g_x = jax.value_and_grad(l_xla)(params, key)
        v_p, g_p = jax.value_and_grad(l_pal)(params, key)
        np.testing.assert_allclose(float(v_p), float(v_x), rtol=1e-5)
        for k in g_x:
            np.testing.assert_allclose(np.asarray(g_p[k]),
                                       np.asarray(g_x[k]),
                                       rtol=2e-3, atol=2e-5, err_msg=k)

    # traced key: two seeds through ONE jitted function -> different losses,
    # no retrace of the underlying render
    l_pal = jax.jit(make_loss(scene, target, 12, 8, engine="pallas"))
    va = float(l_pal(params, rng.base_key(1)))
    vb = float(l_pal(params, rng.base_key(2)))
    assert va != vb


def test_fused_mse_loss_matches_twopass():
    """The fused render->MSE->grad kernel (one pass per value_and_grad
    step) must reproduce the two-pass loss value and gradients: both the
    no-grad primal (fwd kernel + XLA reduction) and the fused kernel's
    in-kernel loss/cotangents against the generic pallas path and XLA."""
    from raytracingrust_tpu.diff.grad import extract_params, make_loss
    from raytracingrust_tpu.ops.pallas_megakernel import supports_fused_mse
    from raytracingrust_tpu.utils import rng

    b = SceneBuilder()
    b.camera = Camera.create((0, 0, 0), (0, 0, -1), (0, 1, 0), 90.0, 1.2)
    b.settings = RenderSettings(samples_per_pixel=4, max_ray_depth=3,
                                enable_bvh_tree=False)
    m1 = b.add_material(Lambertian((0.7, 0.4, 0.2)))
    m2 = b.add_material(Metal((0.9, 0.9, 0.9), 0.1))
    m3 = b.add_material(Emission((1.5, 1.2, 0.9)))
    b.add_sphere((0, -0.3, -1.2), 0.4, m1)
    b.add_sphere((0.8, 0.2, -1.5), 0.4, m2)
    b.add_sphere((-0.8, 0.2, -1.5), 0.4, m3)
    scene = b.build(with_bvh=False)
    assert supports_fused_mse(scene)
    target = render_linear(scene, 20, 10, seed=7, engine="xla") * 0.9
    params = extract_params(scene, ("albedo", "emission", "cam_lookfrom"))

    import dataclasses

    from raytracingrust_tpu.diff.grad import apply_params

    # two-pass pallas reference: same engine, same RNG, same winners — the
    # fused kernel must match it near-EXACTLY (same math, one pass)
    def twopass(p, key=None):
        img = render_linear(apply_params(scene, p), 20, 10, seed=0, key=key,
                            engine="pallas")
        return jnp.mean((img - target) ** 2)

    loss_f = make_loss(scene, target, 20, 10, seed=0, engine="pallas")
    loss_x = make_loss(scene, target, 20, 10, seed=0, engine="xla")
    for key in (None, rng.base_key(5)):
        v_f, g_f = jax.value_and_grad(loss_f)(params, key)
        v_2, g_2 = jax.value_and_grad(twopass)(params, key)
        # interpret-mode kernels are ulp-sensitive to the surrounding
        # compilation (different programs fuse differently on CPU), so a
        # borderline path can flip between the fused and two-pass kernels;
        # tolerances cover one flipped sample
        np.testing.assert_allclose(float(v_f), float(v_2), rtol=1e-2)
        for k in g_f:
            np.testing.assert_allclose(np.asarray(g_f[k]),
                                       np.asarray(g_2[k]),
                                       rtol=5e-2, atol=1e-3, err_msg=k)
        # XLA cross-check: loose (borderline-hit flips between the
        # intersector formulations shift tiny grads at the 1e-4 scale)
        v_x, g_x = jax.value_and_grad(loss_x)(params, key)
        np.testing.assert_allclose(float(v_f), float(v_x), rtol=5e-3)
        for k in g_f:
            np.testing.assert_allclose(np.asarray(g_f[k]),
                                       np.asarray(g_x[k]),
                                       rtol=5e-2, atol=5e-4, err_msg=k)
    # no-grad primal (fwd kernel + XLA reduction) == fused kernel value
    v_plain = float(loss_f(params))
    v_vag = float(jax.value_and_grad(loss_f)(params)[0])
    np.testing.assert_allclose(v_plain, v_vag, rtol=1e-5)
