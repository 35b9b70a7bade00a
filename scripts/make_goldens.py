#!/usr/bin/env python3
"""(Re)generate the golden regression images under tests/goldens/.

Run on CPU (the platform the test suite uses) after an INTENTIONAL
rendering-semantics change, and commit the result:

    python scripts/make_goldens.py

tests/test_goldens.py asserts current renders stay allclose to these
anchors so perf work in later rounds cannot silently drift the image
(VERDICT r1 item 10).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

ROOT = os.path.join(os.path.dirname(__file__), "..")
OUT = os.path.join(ROOT, "tests", "goldens")


def golden_cases():
    """name -> (scene, width, height, seed).  Small frames, fixed seeds.
    Every scene is in the tree or generated from a seed."""
    from raytracingrust_tpu import demo
    from raytracingrust_tpu.models.scene import load_scene

    def scene(name):
        return load_scene(os.path.join(ROOT, "scenes", f"{name}.json"))

    return {
        "benchmark": (scene("benchmark"), 32, 26, 0),
        "sphere_grid": (scene("sphere_grid"), 24, 24, 1),
        "bvh_stress": (scene("bvh_stress"), 24, 20, 2),
        "mesh": (demo.mesh_scene().build(with_bvh=True), 24, 24, 3),
    }


def main():
    from raytracingrust_tpu.render.render import render_linear

    os.makedirs(OUT, exist_ok=True)
    for name, (scene, w, h, seed) in golden_cases().items():
        img = np.asarray(render_linear(scene, w, h, seed=seed, engine="xla"))
        path = os.path.join(OUT, f"{name}.npz")
        np.savez_compressed(path, img=img, width=w, height=h, seed=seed)
        print(f"{name}: {img.shape} mean={img.mean():.5f} -> {path}")


if __name__ == "__main__":
    main()
