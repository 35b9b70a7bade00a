"""Golden-image regression anchors (VERDICT r1 item 10).

Fixed-seed CPU renders of the benchmark scene, the ~100-sphere grid, the
BVH stress scene and a generated 1,280-triangle mesh are committed under
tests/goldens/; every round's perf work must keep rendering THE SAME
IMAGES.  Regenerate (and review the diff!) with scripts/make_goldens.py
only after an intentional semantics change.  Reference anchors:
scenes/*.json + lib/core/render.rs:61-127.
"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "scripts"))

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _cases():
    from make_goldens import golden_cases
    return golden_cases()


@pytest.mark.parametrize("name", ["benchmark", "sphere_grid", "bvh_stress",
                                  "mesh"])
def test_golden(name):
    from raytracingrust_tpu.render.render import render_linear

    path = os.path.join(GOLDENS, f"{name}.npz")
    if not os.path.exists(path):
        pytest.fail(f"missing golden {path}; run scripts/make_goldens.py")
    rec = np.load(path)
    scene, w, h, seed = _cases()[name]
    assert (w, h, seed) == (int(rec["width"]), int(rec["height"]),
                            int(rec["seed"]))
    img = np.asarray(render_linear(scene, w, h, seed=seed, engine="xla"))
    # tolerance: XLA CPU codegen may reassociate across versions; anything
    # above a few ulps is a real semantics change
    np.testing.assert_allclose(img, rec["img"], atol=5e-5, rtol=1e-4)
