"""Inverse rendering: recover scene parameters from a target image.

The differentiable-rendering demo from BASELINE.json config #5 ("recover
material albedo/roughness + camera pose from target image"): Adam (optax)
over selected scene parameters against an MSE loss in linear radiance.
Per-step the gradient is computed with a fresh RNG seed (stochastic gradient
over path samples), which doubles as the Monte-Carlo estimator average.
"""

from __future__ import annotations

from typing import Callable, Iterable

import jax
import jax.numpy as jnp
import optax

from ..models.scene import Scene
from .grad import apply_params, extract_params, make_loss


def fit(
    scene: Scene,
    target,
    names: Iterable[str],
    width: int,
    height: int,
    *,
    steps: int = 100,
    learning_rate: float = 5e-2,
    seed: int = 0,
    resample_every: int = 1,
    engine: str = "auto",
    callback: Callable | None = None,
    constraints: dict | None = None,
    checkpoint_path: str | None = None,
    checkpoint_every: int = 25,
    mesh=None,
    sharded: bool = False,
):
    """Optimize ``names`` parameters of ``scene`` to match ``target``.

    Returns (optimized scene, final params, loss history).

    ``resample_every``: draw a fresh RNG seed for the loss every k steps
    (seed index = seed + step // k).  Fresh seeds make the optimization a
    true stochastic gradient over path realizations instead of descending a
    single fixed-seed image; the key is a traced input to the jitted step,
    so reseeding never recompiles.  Pass 0 to pin the seed for all steps.
    ``engine``: render engine for the loss ("auto" uses the sphere kernel's
    fused fwd+bwd on a GPU when the scene qualifies; see
    render.resolve_engine).
    ``constraints``: optional {name: (lo, hi)} clamps applied after each step
    (e.g. albedo in [0,1], fuzz >= 0).
    ``checkpoint_path``: when set, the optimizer state is periodically saved
    there and a matching existing checkpoint resumes the run mid-flight.
    ``mesh`` / ``sharded``: run the loss data-parallel over a device mesh
    (rays sharded, scene + params replicated, gradient psum over the devices —
    diff.grad._make_loss_sharded).  ``sharded=True`` builds a 1-D mesh
    over all visible devices; pass ``mesh=`` for explicit topologies.
    The optimizer update itself is elementwise over replicated params, so
    the whole jitted step stays collective-correct.  Counter-based RNG
    makes the sharded trajectory match the single-device one to f32
    reduction order (tests/test_sharded_fit.py).
    """
    from ..utils import rng

    if sharded and mesh is None:
        from ..parallel.sharding import make_mesh
        mesh = make_mesh()

    names = list(names)
    params = extract_params(scene, names)
    tx = optax.adam(learning_rate)
    opt_state = tx.init(params)
    start_step = 0
    if checkpoint_path:
        from . import checkpoint as ckpt
        state = ckpt.load(checkpoint_path,
                          {"params": params, "opt": opt_state, "step": 0})
        if state is not None:
            params = jax.tree.map(jnp.asarray, state["params"])
            opt_state = jax.tree.map(jnp.asarray, state["opt"])
            start_step = int(state["step"])

    loss_fn = make_loss(scene, target, width, height, seed=seed,
                        engine=engine, mesh=mesh)

    @jax.jit
    def step(params, opt_state, key):
        value, grads = jax.value_and_grad(loss_fn)(params, key)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, value

    history = []
    for i in range(start_step, steps):
        seed_idx = seed + (i // resample_every if resample_every else 0)
        params, opt_state, value = step(params, opt_state,
                                        rng.base_key(seed_idx))
        if constraints:
            for name, (lo, hi) in constraints.items():
                if name in params:
                    params[name] = jnp.clip(params[name], lo, hi)
        history.append(float(value))
        if callback is not None:
            callback(i, float(value), params)
        if checkpoint_path and (i + 1) % checkpoint_every == 0:
            from . import checkpoint as ckpt
            ckpt.save(checkpoint_path,
                      {"params": params, "opt": opt_state, "step": i + 1})

    return apply_params(scene, params), params, history
