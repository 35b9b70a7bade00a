"""raytracingrust_tpu — a differentiable path tracer in JAX.

Brand-new JAX/XLA/Pallas framework with the full capability surface of the
reference Rust CPU tracer (LevKruglyak/RayTracingRust), re-designed for
accelerators: SoA scene pytrees, dense intersection as matmuls, a Triton
megakernel for sphere scenes on the GPU, a flat skip-link BVH
with stackless lockstep traversal, branchless material shading, counter-based
reproducible RNG, ray-sharded multi-chip rendering, and detached-sampling
gradients for inverse rendering.
"""

__version__ = "0.1.0"

from .models.backgrounds import Background
from .models.camera import Camera
from .models.materials import (
    Dielectric,
    Emission,
    Isotropic,
    Lambertian,
    Metal,
    MixMaterial,
)
from .models.mesh import Mesh
from .models.scene import (
    MODE_CLAY,
    MODE_FULL,
    MODE_NORMAL,
    MODE_RANDOM,
    RenderSettings,
    Scene,
    SceneBuilder,
    load_scene,
)
from .render.render import render, render_linear


def __getattr__(name):
    # heavier entry points, imported lazily to keep `import raytracingrust_tpu`
    # light (they pull in optax / sharding machinery)
    if name == "fit":
        from .diff.inverse import fit
        return fit
    if name == "render_progressive":
        from .render.progressive import render_progressive
        return render_progressive
    if name == "render_sharded":
        from .parallel.sharding import render_sharded
        return render_sharded
    raise AttributeError(name)


__all__ = [
    "Background", "Camera", "Dielectric", "Emission", "Isotropic",
    "Lambertian", "Metal", "MixMaterial", "Mesh", "RenderSettings", "Scene",
    "SceneBuilder", "load_scene", "render", "render_linear",
    "render_progressive", "render_sharded", "fit",
    "MODE_FULL", "MODE_CLAY", "MODE_NORMAL", "MODE_RANDOM",
]
