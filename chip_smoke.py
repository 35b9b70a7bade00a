#!/usr/bin/env python3
"""Smoke test of the path tracer on one GPU (or, with --four-cards, four).

    python chip_smoke.py               # one card, every phase below
    python chip_smoke.py --four-cards  # the 4-card sharded fit only

Phases (one card):
  render   ``rtrt render scenes/benchmark.json`` at 1000x1000, spp 8,
           depth 6, in-process: the PNG is written, engine and mean RGB
           printed; first call (compile + run) and a second call timed apart.
  parity   the Triton sphere kernel against the XLA engine on the card at
           512x512, spp 8, depth 6: depth-1 image, full-depth image within
           cross-seed noise, fused MSE loss, and the kernel's gradient
           against central finite differences of its own loss.
  cpu      the XLA engine on the card against the XLA engine on the CPU of
           the same process, on the benchmark scene and on a generated
           1,280-triangle mesh scene (the BVH path), plus the mesh scene's
           gradient against finite differences on the card.
  fit      5 Adam steps of diff.inverse.fit on the benchmark scene at
           512x512, spp 8, depth 6, engine "auto": the loss is finite and
           falls.

--four-cards runs ``make_loss(mesh=)`` / ``fit(mesh=)`` and
``render_linear_sharded`` over four cards against one card, and nothing
else.  Any failed phase exits non-zero.  Without a GPU the script exits
non-zero before any phase.  The last line of a passing run is one JSON
object: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "out", "chip_smoke")
BENCH_SCENE = os.path.join(ROOT, "scenes", "benchmark.json")
W, H, SPP, DEPTH = 512, 512, 8, 6


def log(msg: str) -> None:
    print(msg, flush=True)


def bench_scene(spp=SPP, depth=DEPTH):
    from raytracingrust_tpu.models.scene import SceneBuilder

    b = SceneBuilder.from_file(BENCH_SCENE)
    b.settings = dataclasses.replace(b.settings, samples_per_pixel=spp,
                                     max_ray_depth=depth,
                                     enable_bvh_tree=False)
    return b.build()


def timed(fn, *args):
    """-> (result, seconds), blocking on the result."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def fd_check(loss, params, *, eps=1e-3, rtol=0.05):
    """AD directional derivative against a central finite difference of
    the same fixed-key loss -> (ad, fd, ok)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingrust_tpu.utils import rng

    key = rng.base_key(3)
    gen = np.random.default_rng(0)
    v = {k: jnp.asarray(gen.standard_normal(np.shape(p)), jnp.float32)
         for k, p in params.items()}
    _, g = jax.jit(jax.value_and_grad(loss))(params, key)
    ad = sum(float(jnp.vdot(g[k], v[k])) for k in params)
    f = jax.jit(loss)
    plus = {k: params[k] + eps * v[k] for k in params}
    minus = {k: params[k] - eps * v[k] for k in params}
    fd = (float(f(plus, key)) - float(f(minus, key))) / (2 * eps)
    return ad, fd, abs(ad - fd) <= rtol * max(abs(fd), 1e-6)


# ------------------------------------------------------------------ phases

def phase_render(width=1000, height=1000):
    import numpy as np

    from raytracingrust_tpu import cli
    from raytracingrust_tpu.io.png import read_png
    from raytracingrust_tpu.render.render import select_engine

    os.makedirs(OUT, exist_ok=True)
    png = os.path.join(OUT, "render.png")
    argv = ["render", BENCH_SCENE, "--width", str(width), "--height",
            str(height), "--spp", str(SPP), "--depth", str(DEPTH), "-o", png]
    times = []
    for _ in range(2):
        if os.path.exists(png):
            os.remove(png)
        t0 = time.perf_counter()
        assert cli.main(argv) == 0
        times.append(time.perf_counter() - t0)
        assert os.path.exists(png), "no PNG written"
    img = read_png(png)[..., :3].astype(np.float64)
    mean = img.mean(axis=(0, 1))
    assert img.shape == (height, width, 3) and 0 < mean.min() < 255
    engine = select_engine(bench_scene(), "auto")
    return (f"engine {engine}, mean RGB {np.round(mean, 2).tolist()}, "
            f"compile+run {times[0]:.2f} s, steady {times[1]:.3f} s")


def phase_parity(w=W, h=H):
    import jax.numpy as jnp
    import numpy as np

    from raytracingrust_tpu.diff.grad import extract_params, make_loss
    from raytracingrust_tpu.render.render import render_linear

    scene = bench_scene()
    notes = []

    # Depth 1: camera ray, one intersection, emission or background.  The
    # engines differ only in f32 rounding (Triton's and XLA's sqrt and
    # division, FMA contraction), so a sample can flip only where a ray
    # grazes a sphere.  Tolerance: 1e-4 on all but 0.01% of pixels, and
    # nowhere more than one sample's worth (brightest sample / spp).
    s1 = dataclasses.replace(
        scene, settings=dataclasses.replace(scene.settings, max_ray_depth=1))
    p1 = np.asarray(render_linear(s1, w, h, seed=11, engine="pallas"))
    x1 = np.asarray(render_linear(s1, w, h, seed=11, engine="xla"))
    d1 = np.abs(p1 - x1).max(axis=-1)
    one_sample = float(max(np.max(np.asarray(scene.materials.emission)),
                           np.max(np.asarray(scene.background.color_a)))
                       ) / SPP
    off = float((d1 > 1e-4).mean())
    notes.append(f"depth-1 max|d| {d1.max():.3g} (bound {one_sample:.3g}), "
                 f"pixels >1e-4: {off:.2e}")
    assert off <= 1e-4 and d1.max() <= one_sample + 1e-4, notes[-1]

    # Full depth: engines sample the same distribution; their difference
    # must not exceed 1.5x the cross-seed Monte-Carlo noise of XLA.
    pw = np.asarray(render_linear(scene, w, h, seed=11, engine="pallas"))
    xa = np.asarray(render_linear(scene, w, h, seed=11, engine="xla"))
    xb = np.asarray(render_linear(scene, w, h, seed=12, engine="xla"))
    mad_engine = float(np.abs(pw - xa).mean())
    mad_seed = float(np.abs(xa - xb).mean())
    notes.append(f"depth-{DEPTH} mean|kernel-xla| {mad_engine:.3g}, "
                 f"mean|seed-seed| {mad_seed:.3g}")
    assert np.isfinite(pw).all() and mad_engine <= 1.5 * mad_seed

    # Fused render->MSE->grad kernel against the MSE of the kernel's own
    # image, and against the XLA MSE.  The two engines' losses at one seed
    # may differ only by what their images' difference explains:
    # |mean(a^2) - mean(b^2)| <= rms(a - b) * rms(a + b).
    import jax

    target = jnp.asarray(xa) * 0.9
    params = extract_params(scene, ("albedo", "emission", "bg_color_a"))
    loss_k = make_loss(scene, target, w, h, seed=0, engine="pallas")
    loss_x = make_loss(scene, target, w, h, seed=0, engine="xla")
    v_fused = float(jax.jit(jax.value_and_grad(loss_k))(params)[0])
    v_x = float(jax.jit(loss_x)(params))
    t = np.asarray(target)
    a = np.asarray(render_linear(scene, w, h, seed=0, engine="pallas")) - t
    b = np.asarray(render_linear(scene, w, h, seed=0, engine="xla")) - t
    v_img = float(np.mean(a ** 2))
    bound = float(np.sqrt(np.mean((a - b) ** 2) * np.mean((a + b) ** 2)))
    notes.append(f"MSE fused {v_fused:.6g}, of kernel image {v_img:.6g}, "
                 f"xla {v_x:.6g} (bound {bound:.3g})")
    assert abs(v_fused - v_img) <= 1e-3 * v_img, notes[-1]
    assert abs(v_fused - v_x) <= 1.01 * bound + 1e-3 * v_x, notes[-1]

    ad, fd, ok = fd_check(loss_k, params)
    notes.append(f"grad.v AD {ad:.5g} vs FD {fd:.5g}")
    assert ok, notes[-1]
    return "; ".join(notes)


def phase_cpu(w=64, h=48):
    import jax
    import numpy as np

    from raytracingrust_tpu import demo
    from raytracingrust_tpu.diff.grad import extract_params, make_loss
    from raytracingrust_tpu.render.render import render_linear

    cpu = jax.devices("cpu")[0]
    mesh_scene = demo.mesh_scene().build(with_bvh=True)
    notes = []
    for name, scene in (("benchmark", bench_scene()), ("mesh", mesh_scene)):
        g_a = np.asarray(render_linear(scene, w, h, seed=1, engine="xla"))
        g_b = np.asarray(render_linear(scene, w, h, seed=2, engine="xla"))
        with jax.default_device(cpu):
            c_a = np.asarray(render_linear(scene, w, h, seed=1,
                                           engine="xla"))
        mad_dev = float(np.abs(g_a - c_a).mean())
        mad_seed = float(np.abs(g_a - g_b).mean())
        notes.append(f"{name}: mean|card-cpu| {mad_dev:.3g}, "
                     f"mean|seed-seed| {mad_seed:.3g}")
        assert np.isfinite(g_a).all() and mad_dev <= 1.5 * mad_seed, \
            notes[-1]

    target = render_linear(mesh_scene, w, h, seed=4, engine="xla") * 0.9
    params = extract_params(mesh_scene, ("albedo", "bg_color_a"))
    ad, fd, ok = fd_check(
        make_loss(mesh_scene, target, w, h, seed=0, engine="xla"), params)
    notes.append(f"mesh grad.v AD {ad:.5g} vs FD {fd:.5g}")
    assert ok, notes[-1]
    return "; ".join(notes)


def phase_fit(w=W, h=H, steps=5):
    import jax.numpy as jnp
    import numpy as np

    from raytracingrust_tpu.diff.grad import apply_params
    from raytracingrust_tpu.diff.inverse import fit
    from raytracingrust_tpu.render.render import render_linear, select_engine

    scene = bench_scene()
    target = render_linear(scene, w, h, seed=5)
    start = apply_params(scene, {"albedo": scene.materials.albedo * 0.5})
    stamps = []

    def mark(i, value, params):
        stamps.append(time.perf_counter())

    t0 = time.perf_counter()
    _, _, hist = fit(start, target, ["albedo"], w, h, steps=steps,
                     learning_rate=0.05, resample_every=0, callback=mark)
    first = stamps[0] - t0
    per_step = float(np.mean(np.diff(stamps))) * 1e3
    engine = select_engine(start, "auto", use="fit")
    assert np.isfinite(hist).all() and hist[-1] < hist[0], hist
    return (f"engine {engine}, loss {hist[0]:.6g} -> {hist[-1]:.6g}, "
            f"first step (compile) {first:.2f} s, {per_step:.2f} ms/step")


def phase_four_cards(w=W, h=H, n=4):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raytracingrust_tpu.diff.grad import extract_params, make_loss
    from raytracingrust_tpu.diff.inverse import fit
    from raytracingrust_tpu.parallel.sharding import (make_mesh,
                                                      render_linear_sharded)
    from raytracingrust_tpu.render.render import render_linear, select_engine

    assert len(jax.devices()) >= n, f"need {n} cards"
    mesh_n = make_mesh(jax.devices()[:n])
    mesh_1 = make_mesh(jax.devices()[:1])
    scene = bench_scene()
    notes = [f"engine {select_engine(scene, 'auto', use='fit')}"]

    img_n = render_linear_sharded(scene, w, h, mesh=mesh_n, seed=3)
    img_1 = np.asarray(render_linear(scene, w, h, seed=3))
    np.testing.assert_allclose(img_n, img_1, rtol=1e-4, atol=1e-5)
    notes.append(f"render {n} cards vs 1 max|d| "
                 f"{np.abs(img_n - img_1).max():.3g}")

    # the same per-shard kernels on n cards and on one: the loss differs
    # only in f32 summation order, the gradients to rounding
    target = jnp.asarray(img_1) * 0.9
    params = extract_params(scene, ("albedo", "emission", "bg_color_a"))
    vg_n = jax.jit(jax.value_and_grad(
        make_loss(scene, target, w, h, seed=0, mesh=mesh_n)))
    vg_1 = jax.jit(jax.value_and_grad(
        make_loss(scene, target, w, h, seed=0, mesh=mesh_1)))
    (v_n, g_n), t_first = timed(vg_n, params)
    (v_n, g_n), t_n = timed(vg_n, params)
    (v_1, g_1), _ = timed(vg_1, params)
    (v_1, g_1), t_1 = timed(vg_1, params)
    np.testing.assert_allclose(float(v_n), float(v_1), rtol=1e-5)
    for k in params:
        np.testing.assert_allclose(np.asarray(g_n[k]), np.asarray(g_1[k]),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    notes.append(f"loss {n} cards {float(v_n):.8g}, 1 card "
                 f"{float(v_1):.8g}; value_and_grad {t_n * 1e3:.2f} ms on "
                 f"{n} cards, {t_1 * 1e3:.2f} ms on 1 (first call "
                 f"{t_first:.1f} s)")

    # fit(mesh=): its first loss is the loss above; Adam steps lower it
    _, _, hist = fit(scene, target, ["albedo", "emission", "bg_color_a"], w,
                     h, steps=3, resample_every=0, mesh=mesh_n)
    np.testing.assert_allclose(hist[0], float(v_n), rtol=1e-5)
    assert hist[-1] < hist[0], hist
    notes.append(f"fit(mesh=) losses {np.round(hist, 8).tolist()}")
    return "; ".join(notes)


# -------------------------------------------------------------------- main

def run_phase(name, fn, results):
    t0 = time.perf_counter()
    try:
        detail = fn()
        results[name] = True
        log(f"phase {name}: ok ({time.perf_counter() - t0:.1f} s) {detail}")
    except Exception:
        results[name] = False
        log(f"phase {name}: FAILED ({time.perf_counter() - t0:.1f} s)")
        traceback.print_exc()


def gpu_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card sharded fit phase")
    args = ap.parse_args(argv)

    try:
        import raytracingrust_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the package is not importable ({e}); run from "
              "the repository root", file=sys.stderr)
        return 2
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (platform {dev.platform!r})",
              file=sys.stderr)
        return 2

    from raytracingrust_tpu.compile_cache import enable_compile_cache

    log(f"jax {jax.__version__}; platform {dev.platform}; "
        f"device_kind {dev.device_kind}; count {len(devices)}")
    log(f"nvidia-smi: {gpu_line()}")
    log(f"compile cache: {enable_compile_cache()}")

    results = {}
    if args.four_cards:
        run_phase("four_cards", phase_four_cards, results)
    else:
        for name, fn in (("render", phase_render), ("parity", phase_parity),
                         ("cpu", phase_cpu), ("fit", phase_fit)):
            run_phase(name, fn, results)
    if not all(results.values()):
        failed = [k for k, v in results.items() if not v]
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
