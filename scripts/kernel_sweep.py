#!/usr/bin/env python3
"""Time the sphere kernel's launch shapes against the XLA engine on a GPU.

    python scripts/kernel_sweep.py --scene benchmark
    python scripts/kernel_sweep.py --scene sphere_grid --fwd 256x4 --fit 64x2

For one scene at one shape (default 512x512, spp 8, depth 6) it times the
forward render (``pixel_radiance_pallas`` at each ``--fwd`` BLOCKxWARPS,
and the XLA engine) and the fit step (``value_and_grad`` of the fused MSE
kernel at each ``--fit`` BLOCKxWARPS, and of the XLA loss).  Each result
is one JSON line on stdout, appended to out/kernel_sweep.jsonl,
with the device and the card's name and power limit.  Exits non-zero
without a GPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)


def shapes(spec: str):
    return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")
            if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="benchmark",
                    choices=["benchmark", "sphere_grid"])
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--depth", type=int, default=6)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--fwd", default="128x4,256x4,512x8",
                    help="forward BLOCKxWARPS list ('' skips)")
    ap.add_argument("--fit", default="64x2,128x4,256x4",
                    help="fused MSE BLOCKxWARPS list ('' skips)")
    ap.add_argument("--no-xla", action="store_true")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print("kernel_sweep: no GPU", file=sys.stderr)
        return 2
    from raytracingrust_tpu.compile_cache import enable_compile_cache
    from raytracingrust_tpu.diff.grad import (apply_params, extract_params,
                                              make_loss)
    from raytracingrust_tpu.models.scene import SceneBuilder
    from raytracingrust_tpu.ops import pallas_megakernel as PK
    from raytracingrust_tpu.render.render import render_linear
    from raytracingrust_tpu.utils import rng

    enable_compile_cache()
    from chip_smoke import gpu_line

    gpu = gpu_line()
    b = SceneBuilder.from_file(os.path.join(ROOT, "scenes",
                                            f"{args.scene}.json"))
    b.settings = dataclasses.replace(
        b.settings, samples_per_pixel=args.spp, max_ray_depth=args.depth,
        enable_bvh_tree=False)
    scene = b.build()
    w, h = args.width, args.height
    rays = w * h * args.spp
    ids = jnp.arange(w * h, dtype=jnp.int32)
    key = rng.base_key(0).astype(jnp.int32)
    kinds = PK.sphere_kinds(scene)
    params = extract_params(scene, ("albedo", "fuzz", "ir", "emission",
                                    "bg_color_a"))
    target = jnp.zeros((h, w, 3), jnp.float32)
    out_path = os.path.join(ROOT, "out", "kernel_sweep.jsonl")
    os.makedirs(os.path.dirname(out_path), exist_ok=True)

    def measure(what, engine, fn, **extra):
        step = jax.jit(fn)
        t0 = time.perf_counter()
        jax.block_until_ready(step(params))
        first = time.perf_counter() - t0
        for _ in range(2):
            jax.block_until_ready(step(params))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = step(params)
        jax.block_until_ready(out)
        ms = (time.perf_counter() - t0) / args.iters * 1e3
        rec = {"scene": args.scene, "shape": [w, h, args.spp, args.depth],
               "what": what, "engine": engine, **extra,
               "first_call_s": round(first, 3), "ms": round(ms, 4),
               "primary_rays_per_s": round(rays / ms * 1e3, 1),
               "device": {"platform": dev.platform,
                          "kind": dev.device_kind,
                          "count": len(jax.devices())},
               "gpu": gpu}
        line = json.dumps(rec)
        print(line, flush=True)
        with open(out_path, "a") as f:
            f.write(line + "\n")

    for block, warps in shapes(args.fwd):
        measure("forward", "pallas",
                lambda p, block=block, warps=warps: PK.pixel_radiance_pallas(
                    apply_params(scene, p), ids, w, h, key, kinds=kinds,
                    block=block, num_warps=warps),
                block=block, warps=warps)
    if not args.no_xla and args.fwd:
        measure("forward", "xla",
                lambda p: render_linear(apply_params(scene, p), w, h,
                                        seed=0, tile_rays=rays,
                                        engine="xla"))
    for block, warps in shapes(args.fit):
        measure("fit_step", "pallas",
                jax.value_and_grad(
                    lambda p, block=block, warps=warps: PK.mse_loss_pallas(
                        apply_params(scene, p), target, w, h, key,
                        kinds=kinds, grad_block=block, grad_warps=warps)),
                block=block, warps=warps)
    if not args.no_xla and args.fit:
        measure("fit_step", "xla", jax.value_and_grad(
            make_loss(scene, target, w, h, seed=0, tile_rays=rays,
                      engine="xla")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
