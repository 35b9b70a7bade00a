#!/usr/bin/env python3
"""Standard benchmark: forward+backward rays/s on scenes/benchmark.json
(or ``--scene``).

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "rays/s", "vs_baseline": N,
   "device": {...}, "gpu": "<name>, <power limit>"}

The metric is PRIMARY rays traced per second through a full differentiable
render step (forward radiance + gradient w.r.t. material/emission/camera/
background parameters) — BASELINE.json's "rays/s fwd+bwd on
scenes/benchmark.json".  The baseline divisor is the reference *floor*
recorded in BASELINE_FLOOR.json (the same workload on the JAX-CPU oracle
path; the Rust reference publishes no numbers — BASELINE.md).  Correctness
on the card (kernel against XLA, card against CPU, gradients against
finite differences) is chip_smoke.py's job.  Exits non-zero without a GPU.

    python bench.py [--engine auto|pallas|xla] [--forward-only]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))


def build_scene(path: str, spp: int, depth: int):
    from raytracingrust_tpu.models.scene import SceneBuilder

    b = SceneBuilder.from_file(path)
    b.settings = dataclasses.replace(
        b.settings, samples_per_pixel=spp, max_ray_depth=depth,
        enable_bvh_tree=False,  # 5 spheres: the dense intersector
    )
    return b.build()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene",
                    default=os.path.join(ROOT, "scenes", "benchmark.json"))
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--engine", default="auto",
                    choices=["auto", "pallas", "xla"])
    ap.add_argument("--forward-only", action="store_true")
    args = ap.parse_args(argv)

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU found (platform {dev.platform!r})",
              file=sys.stderr)
        return 2

    from chip_smoke import gpu_line
    from raytracingrust_tpu.compile_cache import enable_compile_cache
    from raytracingrust_tpu.diff.grad import (apply_params, extract_params,
                                              make_loss)
    from raytracingrust_tpu.render.render import render_linear, select_engine

    enable_compile_cache()
    import jax.numpy as jnp

    scene = build_scene(args.scene, args.spp, args.depth)
    w, h = args.width, args.height
    # one XLA tile for the whole frame
    tile_rays = w * h * args.spp

    names = ("albedo", "fuzz", "ir", "emission", "cam_lookfrom", "bg_color_a")
    params = extract_params(scene, names)
    target = jnp.zeros((h, w, 3), jnp.float32)

    # the product fit-path loss (diff.grad.make_loss): on a GPU this
    # resolves to the fused render->MSE->grad kernel — one kernel launch
    # per value_and_grad step
    loss_fn = make_loss(scene, target, w, h, seed=0, tile_rays=tile_rays,
                        engine=args.engine)

    if args.forward_only:
        engine = select_engine(scene, args.engine)
        step = jax.jit(
            lambda p: render_linear(apply_params(scene, p), w, h, seed=0,
                                    tile_rays=tile_rays, engine=args.engine)
        )
    else:
        engine = select_engine(scene, args.engine, use="fit")
        step = jax.jit(jax.grad(loss_fn))

    t0 = time.perf_counter()
    jax.block_until_ready(step(params))
    compile_s = time.perf_counter() - t0
    for _ in range(args.warmup):
        out = step(params)
    jax.block_until_ready(out)

    t0 = time.perf_counter()
    for _ in range(args.iters):
        out = step(params)
    jax.block_until_ready(out)
    elapsed = (time.perf_counter() - t0) / args.iters

    primary_rays = w * h * args.spp
    rays_per_s = primary_rays / elapsed

    floor_file = os.path.join(ROOT, "BASELINE_FLOOR.json")
    floor = None
    if os.path.exists(floor_file):
        with open(floor_file) as f:
            floor = json.load(f).get("rays_per_s_fwd_bwd")

    metric = (
        "primary_rays_per_s_forward" if args.forward_only
        else "primary_rays_per_s_fwd_bwd"
    )
    print(json.dumps({
        "metric": f"{metric} {os.path.basename(args.scene)} {w}x{h} "
                  f"spp{args.spp} depth{args.depth}",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / floor if floor else None,
        "ms_per_step": elapsed * 1e3,
        "first_call_s": compile_s,
        "engine": engine,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "gpu": gpu_line(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
