"""Command-line interface.

The reference has NO CLI (its only front-end is the egui window,
src/main.rs); per SURVEY.md section 5 this build exposes every
RenderSettings knob (spp, depth, clamp, bvh, mode — lib/core/scene.rs:22-30)
plus resolution/output/device-mesh options as flags.

    rtrt render scenes/demo.json -o out.png --width 1000 --height 1000
    rtrt render scene.json --spp 100 --depth 50 --mode Clay --no-bvh
    rtrt bench scenes/benchmark.json
    rtrt info scene.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

from .compile_cache import CHECKOUT


def _add_render_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("scene", help="scene JSON (reference-compatible schema)")
    p.add_argument("-o", "--output", default="render.png")
    p.add_argument("--width", type=int, default=1000)
    p.add_argument("--height", type=int, default=1000)
    p.add_argument("--spp", type=int, help="override samples_per_pixel")
    p.add_argument("--depth", type=int, help="override max_ray_depth")
    p.add_argument("--clamp", type=float, help="override clamp_indirect")
    p.add_argument("--mode", choices=["Full", "Clay", "Normal", "Random"])
    p.add_argument("--bvh", action="store_true", help="force BVH on")
    p.add_argument("--no-bvh", action="store_true", help="force BVH off")
    p.add_argument("--engine", choices=["auto", "xla", "pallas"],
                   default="auto",
                   help="render engine (auto = the sphere kernel on a GPU "
                        "when the scene qualifies, the XLA wavefront "
                        "otherwise)")
    p.add_argument("--env-is", action="store_true",
                   help="importance-sample the HDRI environment "
                        "(one-sample MIS; only meaningful with a SkyMap "
                        "background)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tile-rays", type=int, default=None,
                   help="rays per on-device tile")
    p.add_argument("--sharded", action="store_true",
                   help="shard rays over all visible devices")
    p.add_argument("--profile", metavar="DIR",
                   help="write a jax.profiler trace to DIR")
    p.add_argument("--progressive", type=int, metavar="PASSES", default=0,
                   help="accumulate PASSES progressive passes, writing the "
                        "preview PNG after each")
    p.add_argument("--checkpoint", metavar="FILE",
                   help="accumulator checkpoint for progressive restart")


def _load(args):
    from .models.scene import SceneBuilder

    builder = SceneBuilder.from_file(args.scene)
    s = builder.settings
    overrides = {}
    if args.spp is not None:
        overrides["samples_per_pixel"] = args.spp
    if args.depth is not None:
        overrides["max_ray_depth"] = args.depth
    if args.clamp is not None:
        overrides["clamp_indirect"] = args.clamp
    if args.mode is not None:
        overrides["mode"] = args.mode
    if args.bvh:
        overrides["enable_bvh_tree"] = True
    if args.no_bvh:
        overrides["enable_bvh_tree"] = False
    if getattr(args, "env_is", False):
        overrides["env_importance_sampling"] = True
    builder.settings = dataclasses.replace(s, **overrides)
    return builder


def cmd_render(args) -> int:
    from .io.png import write_png
    from .metrics import RenderStats

    builder = _load(args)
    scene = builder.build()
    kwargs = {}
    if args.tile_rays:
        kwargs["tile_rays"] = args.tile_rays

    stats = RenderStats(args.width, args.height,
                        scene.settings.samples_per_pixel,
                        scene.settings.max_ray_depth)
    engine = "xla"
    t0 = time.perf_counter()
    if args.profile:
        import jax
        jax.profiler.start_trace(args.profile)
    if args.progressive:
        from .render.progressive import render_progressive

        def preview(acc, i):
            write_png(args.output, acc.rgba8())
            print(f"pass {i + 1}/{args.progressive} "
                  f"({acc.passes * scene.settings.samples_per_pixel} spp)")

        acc = render_progressive(
            scene, args.width, args.height, passes=args.progressive,
            seed=args.seed, checkpoint_path=args.checkpoint, on_pass=preview,
        )
        img = acc.rgba8()
    elif args.sharded:
        from .parallel.sharding import render_sharded
        img = render_sharded(scene, args.width, args.height, seed=args.seed)
    else:
        from .render.render import render, select_engine
        engine = select_engine(scene, args.engine)
        img = render(scene, args.width, args.height, seed=args.seed,
                     engine=args.engine, **kwargs)
    if args.profile:
        import jax
        jax.profiler.stop_trace()
    elapsed = time.perf_counter() - t0

    write_png(args.output, img)
    # the reference's "Last render took" label (src/gui.rs:330), CLI edition
    print(f"Last render took {elapsed:.3f}s "
          f"({stats.mrays_per_s(elapsed):.2f} Mrays/s, engine {engine}) "
          f"-> {args.output}")
    return 0


def cmd_info(args) -> int:
    builder = _load(args)
    scene = builder.build()
    info = {
        "objects": len(builder.objects),
        "spheres": len(scene.spheres),
        "volumes": scene.spheres.num_volumes,
        "triangles": len(scene.triangles),
        "materials": len(builder.materials),
        "bvh_nodes": len(scene.bvh) if scene.bvh is not None else 0,
        "bvh_depth": scene.bvh.depth if scene.bvh is not None else 0,
        "settings": builder.settings.to_json(),
    }
    print(json.dumps(info, indent=2))
    return 0


def cmd_fit(args) -> int:
    """Inverse rendering: optimize scene parameters to match a target image
    (BASELINE.json config #5)."""
    import numpy as np

    from .diff.inverse import fit
    from .io.png import read_png, write_png

    builder = _load(args)
    scene = builder.build()
    target_u8 = read_png(args.target)[..., :3].astype(np.float32) / 255.0
    target = target_u8 ** 2  # invert the sqrt gamma -> linear radiance
    h, w = target.shape[:2]

    def log(i, value, params):
        if i % 10 == 0:
            print(f"step {i}: loss {value:.6f}")

    out_scene, params, history = fit(
        scene, target, args.params.split(","), w, h,
        steps=args.steps, learning_rate=args.lr, engine=args.engine,
        checkpoint_path=args.checkpoint, callback=log,
        sharded=args.sharded,
    )
    print(f"final loss {history[-1]:.6f}")
    for name, value in params.items():
        print(f"{name}: {np.asarray(value).round(4).tolist()}")
    if args.output:
        from .render.render import render
        write_png(args.output, render(out_scene, w, h))
    return 0


def cmd_view(args) -> int:
    """Interactive viewer: the reference's windowed app (src/main.rs +
    src/gui.rs), served over HTTP with progressive accumulation."""
    from .viewer import serve

    builder = _load(args)
    serve(builder, args.width, args.height, host=args.host, port=args.port,
          seed=args.seed, spp_per_pass=args.spp_per_pass,
          max_passes=args.max_passes)
    return 0


def cmd_bench(args) -> int:
    import bench as bench_mod  # repo-root bench.py is the single source

    sys.argv = ["bench", "--scene", args.scene]
    return bench_mod.main()


def main(argv=None) -> int:
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="rtrt", description="differentiable path tracer in JAX"
    )
    sub = parser.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("render", help="render a scene to PNG")
    _add_render_args(pr)
    pr.set_defaults(fn=cmd_render)

    pi = sub.add_parser("info", help="print scene statistics")
    pi.add_argument("scene")
    for flag in ("--spp", "--depth"):
        pi.add_argument(flag, type=int)
    pi.add_argument("--clamp", type=float)
    pi.add_argument("--mode", choices=["Full", "Clay", "Normal", "Random"])
    pi.add_argument("--bvh", action="store_true")
    pi.add_argument("--no-bvh", action="store_true")
    pi.set_defaults(fn=cmd_info)

    pf = sub.add_parser("fit", help="inverse rendering against a target PNG")
    pf.add_argument("scene")
    pf.add_argument("target", help="target PNG (as written by `rtrt render`)")
    pf.add_argument("--params", default="albedo",
                    help="comma list: albedo,fuzz,ir,emission,bg_color_a,"
                         "cam_lookfrom,cam_fov,...")
    pf.add_argument("--steps", type=int, default=100)
    pf.add_argument("--lr", type=float, default=5e-2)
    pf.add_argument("--checkpoint")
    pf.add_argument("-o", "--output", help="render the fitted scene here")
    for flag in ("--spp", "--depth"):
        pf.add_argument(flag, type=int)
    pf.add_argument("--clamp", type=float)
    pf.add_argument("--mode", choices=["Full", "Clay", "Normal", "Random"])
    pf.add_argument("--bvh", action="store_true")
    pf.add_argument("--no-bvh", action="store_true")
    pf.add_argument("--engine", choices=["auto", "xla", "pallas"],
                    default="auto",
                    help="engine for the differentiable loss (auto = the "
                         "sphere kernel's fused fwd+bwd on a GPU when the "
                         "scene qualifies)")
    pf.add_argument("--env-is", action="store_true",
                    help="importance-sample the HDRI environment in the "
                         "loss (one-sample MIS)")
    pf.add_argument("--sharded", action="store_true",
                    help="data-parallel fit over all visible devices: rays "
                         "sharded, params replicated, gradient psum over "
                         "the devices (diff.inverse.fit(sharded=True))")
    pf.set_defaults(fn=cmd_fit)

    pv = sub.add_parser("view", help="interactive web viewer "
                                     "(progressive render + live editing)")
    pv.add_argument("scene")
    pv.add_argument("--width", type=int, default=512)
    pv.add_argument("--height", type=int, default=512)
    pv.add_argument("--host", default="127.0.0.1")
    pv.add_argument("--port", type=int, default=8000)
    pv.add_argument("--seed", type=int, default=0)
    pv.add_argument("--spp-per-pass", type=int, default=None,
                    help="samples per progressive pass (default: the "
                         "scene's samples_per_pixel)")
    pv.add_argument("--max-passes", type=int, default=1024)
    for flag in ("--spp", "--depth"):
        pv.add_argument(flag, type=int)
    pv.add_argument("--clamp", type=float)
    pv.add_argument("--mode", choices=["Full", "Clay", "Normal", "Random"])
    pv.add_argument("--bvh", action="store_true")
    pv.add_argument("--no-bvh", action="store_true")
    pv.set_defaults(fn=cmd_view)

    pb = sub.add_parser("bench", help="run the standard benchmark")
    pb.add_argument("scene", nargs="?", default=os.path.join(
        CHECKOUT, "scenes", "benchmark.json"))
    pb.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
