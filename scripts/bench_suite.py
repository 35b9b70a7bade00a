#!/usr/bin/env python3
"""Full benchmark suite on a GPU — one JSON line per benchmark.

Mirrors the reference's four criterion benches (SURVEY.md 2.5) plus this
framework's own headline metrics; every scene is in the tree or generated
from a seed:

  simple_render    end-to-end render of scenes/sphere_grid.json (100
                   spheres, standing in for the reference's simple.json)
                   at 100x100 (benches/simple_render_bench.rs:7-12)
  bvh_build_8k     BVH construction, 20^3-sphere grid
                   (benches/bvh_tree_stress.rs:16-30)
  bvh_build_30k    BVH construction, 10x55x55 grid
                   (benches/quad_tree_construction.rs:14-27)
  mesh_render      a generated 1,280-triangle mesh, 40x40, spp 10,
                   depth 50 (benches/mesh.rs:9-22 uses monkey.obj, 967
                   faces)
  bvh_stress_render   scenes/bvh_stress.json (1,189 spheres), per engine
  grid8k_render       8,000-sphere grid render (the reference's BVH stress
                      geometry, actually rendered), per engine
  env_is_render       HDRI importance sampling over 384 spheres, per engine
  fwd_bwd          differentiable render step on benchmark.json (bench.py)

    python scripts/bench_suite.py [--skip mesh_render ...]
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
DEVICE = {}


def emit(name, seconds, extra=None):
    rec = {"bench": name, "seconds": seconds}
    if extra:
        rec.update(extra)
    rec.update(DEVICE)
    print(json.dumps(rec), flush=True)


def time_steady(fn, iters=3, warmup=2):
    """Steady-state average: compile + ``warmup`` calls first, then the
    mean of ``iters`` timed calls.  ``fn(i)`` must block on its result."""
    fn(0)  # warm-up / compile
    for i in range(warmup):
        fn(1 + i)
    t0 = time.perf_counter()
    for i in range(iters):
        fn(100 + i)
    return (time.perf_counter() - t0) / iters


def sphere_grid(nx, ny, nz):
    import numpy as np

    from raytracingrust_tpu import Lambertian, SceneBuilder

    b = SceneBuilder()
    m = b.add_material(Lambertian((0.5, 0.5, 0.5)))
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                b.add_sphere((i * 1.0, j * 1.0, k * 1.0), 0.3, m)
    return b


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", nargs="*", default=[])
    ap.add_argument("--iters", type=int, default=3)
    args = ap.parse_args()

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("bench_suite: no GPU found", file=sys.stderr)
        return 2
    from chip_smoke import gpu_line
    from raytracingrust_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    DEVICE.update(device={"platform": dev.platform, "kind": dev.device_kind,
                          "count": len(jax.devices())}, gpu=gpu_line())

    import numpy as np

    from raytracingrust_tpu import RenderSettings, SceneBuilder, demo
    from raytracingrust_tpu.ops.bvh import build_bvh
    from raytracingrust_tpu.render.render import render_linear

    # --- simple_render: the 100-sphere grid, 100x100 (reference settings:
    # spp 5, depth 6)
    if "simple_render" not in args.skip:
        b = SceneBuilder.from_file(
            os.path.join(ROOT, "scenes", "sphere_grid.json"))
        scene = b.build()
        dt = time_steady(
            lambda i: render_linear(scene, 100, 100,
                                    seed=i).block_until_ready(),
            args.iters,
        )
        emit("simple_render_100x100", dt, {
            "rays_per_s": 100 * 100 * 5 / dt})

    # --- BVH builds (host side; native C++ when available)
    if "bvh_build_8k" not in args.skip:
        spheres = sphere_grid(20, 20, 20).build(with_bvh=False).spheres
        tris = SceneBuilder().build(with_bvh=False).triangles
        dt = time_steady(lambda i: build_bvh(spheres, tris), args.iters)
        emit("bvh_build_8000", dt)

    if "bvh_build_30k" not in args.skip:
        spheres = sphere_grid(10, 55, 55).build(with_bvh=False).spheres
        tris = SceneBuilder().build(with_bvh=False).triangles
        dt = time_steady(lambda i: build_bvh(spheres, tris), args.iters)
        emit("bvh_build_30250", dt)

    # --- mesh render: 40x40 spp10 depth50 (benches/mesh.rs)
    if "mesh_render" not in args.skip:
        b = demo.mesh_scene()
        b.settings = RenderSettings(samples_per_pixel=10, max_ray_depth=50)
        scene = b.build(with_bvh=True)
        dt = time_steady(
            lambda i: render_linear(scene, 40, 40,
                                    seed=i).block_until_ready(),
            args.iters,
        )
        emit("mesh_render_1280tri_40x40", dt, {
            "rays_per_s": 40 * 40 * 10 / dt})

    # --- BVH-class renders, per engine ("auto" resolves to XLA for
    # scenes beyond the sphere kernel)
    def engine_rows(name, scene, w, h, engines=("auto", "xla")):
        spp = scene.settings.samples_per_pixel
        for eng in engines:
            def go(i, eng=eng):
                render_linear(scene, w, h, seed=i,
                              engine=eng).block_until_ready()
            try:
                dt = time_steady(go, args.iters)
            except Exception as e:  # pragma: no cover - engine gate
                emit(f"{name}[{eng}]", float("nan"),
                     {"error": type(e).__name__})
                continue
            emit(f"{name}[{eng}]", dt, {
                "rays_per_s": w * h * spp / dt})

    if "bvh_stress_render" not in args.skip:
        from raytracingrust_tpu.models.scene import load_scene

        scene = load_scene(os.path.join(ROOT, "scenes", "bvh_stress.json"))
        engine_rows("bvh_stress_render_256", scene, 256, 256)

    if "grid8k_render" not in args.skip:
        from raytracingrust_tpu import Camera

        b = sphere_grid(20, 20, 20)
        b.camera = Camera.create((35, 30, 38), (9.5, 9.5, 9.5), (0, 1, 0),
                                 45.0, 1.0)
        b.settings = RenderSettings(samples_per_pixel=5, max_ray_depth=6)
        engine_rows("grid8k_render_256", b.build(with_bvh=True), 256, 256)

    if "env_is_render" not in args.skip:
        from raytracingrust_tpu import Background, Camera, Metal

        # HDRI importance sampling past the dense-intersector threshold
        img = np.full((16, 32, 3), 0.05, np.float32)
        img[2:4, 5:8] = 25.0
        b = SceneBuilder()
        b.camera = Camera.create((8, 7, 10), (0, 0, 0), (0, 1, 0),
                                 50.0, 1.0)
        b.settings = RenderSettings(samples_per_pixel=8, max_ray_depth=4,
                                    env_importance_sampling=True)
        from raytracingrust_tpu import Lambertian
        lam = b.add_material(Lambertian((0.7, 0.6, 0.5)))
        met = b.add_material(Metal((0.9, 0.9, 0.9), 0.1))
        rs = np.random.RandomState(0)
        for i in range(8):
            for j in range(6):
                for k in range(8):
                    b.add_sphere(((i - 3.5) * 1.1, (j - 2.5) * 1.1,
                                  (k - 3.5) * 1.1), 0.4,
                                 (lam, met)[rs.randint(2)])
        b.background = Background.skymap_from_array(img)
        engine_rows("env_is_384sph_128", b.build(with_bvh=True), 128, 128)

    # --- headline fwd+bwd (delegates to bench.py logic)
    if "fwd_bwd" not in args.skip:
        import bench as bench_mod
        bench_mod.main(["--iters", str(args.iters)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
