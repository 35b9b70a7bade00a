#!/usr/bin/env python3
"""Scaling-efficiency harness: rays/s at 1..N devices over the ray-sharded
render path (BASELINE.md: >= 85% efficiency target).

By default the harness runs on N virtual CPU devices
(xla_force_host_platform_device_count) — that validates the sharding
MECHANICS and measures partitioning overhead, not real scaling (virtual
devices share the same cores; ideal speedup is flat, and the efficiency
number reported is throughput(N)/throughput(1), which on shared cores
should stay near 1.0 = no partitioning overhead).  With ``--platform ''``
on a multi-GPU host the same script reports true scaling.

    python scripts/scaling_bench.py --devices 1 2 4 8
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--width", type=int, default=256)
    ap.add_argument("--height", type=int, default=256)
    ap.add_argument("--spp", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--platform", default="cpu",
                    help="cpu (virtual devices) or leave empty for default")
    args = ap.parse_args()

    max_dev = max(args.devices)
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + f" --xla_force_host_platform_device_count={max_dev}"
        ).strip()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import dataclasses

    from raytracingrust_tpu.models.scene import SceneBuilder
    from raytracingrust_tpu.parallel.sharding import (
        make_mesh, render_linear_sharded,
    )

    b = SceneBuilder.from_file(os.path.join(
        os.path.dirname(__file__), "..", "scenes", "benchmark.json"))
    b.settings = dataclasses.replace(
        b.settings, samples_per_pixel=args.spp, max_ray_depth=6,
        enable_bvh_tree=False,
    )
    scene = b.build()
    n_rays = args.width * args.height * args.spp

    results = {}
    for n in args.devices:
        mesh = make_mesh(jax.devices()[:n])
        # warm-up / compile
        render_linear_sharded(scene, args.width, args.height, mesh=mesh,
                              seed=0)
        t0 = time.perf_counter()
        for i in range(args.iters):
            render_linear_sharded(scene, args.width, args.height, mesh=mesh,
                                  seed=i + 1)
        dt = (time.perf_counter() - t0) / args.iters
        results[n] = n_rays / dt
        print(f"devices={n}: {results[n] / 1e6:.2f}M rays/s", flush=True)

    base = results[min(results)]
    report = {
        "platform": args.platform or "default",
        "rays_per_s": results,
        "efficiency_vs_1dev": {
            n: round(r / (base * (n / min(results))), 3)
            if args.platform != "cpu" else round(r / base, 3)
            for n, r in results.items()
        },
        "note": (
            "cpu virtual devices share cores: efficiency here = partitioning "
            "overhead check (ideal ~1.0), not real device scaling"
        ),
    }
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
