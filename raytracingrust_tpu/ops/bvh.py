"""Flat skip-link BVH builder (host side).

Completes what the reference started and abandoned: ``LinearBvhTree`` — a
contiguous node array with index links and a stackless traversal loop
(lib/core/bvh.rs:201-293, entirely commented out).  The build *policy* is the
reference's (BvhNode::from_list, lib/core/bvh.rs:59-144): recursive median
split on the axis of greatest centroid spread, stable sort by centroid,
split at len/2, leaf = 1 primitive.  The *layout* is wavefront-friendly: DFS order
with hit/miss links so traversal is a branchless while-loop — no recursion,
no stack, identical control flow for every ray in a wavefront.

Build is O(n log^2 n) NumPy on host, once per scene (the reference rebuilds
per render call — quirk Q3 — we cache in the Scene pytree).  A C++ builder
behind ctypes provides the same output ~10-100x faster for large scenes (see
native/bvh_builder.cc); we fall back to NumPy when it is not compiled.
"""

from __future__ import annotations

import numpy as np

from ..utils import aabb


def primitive_bounds(spheres, triangles):
    """Global primitive AABBs: spheres [0, N) then triangles [N, N+T).

    Sphere bounds = center +- radius (lib/objects.rs:53-60); volume spheres
    use the boundary's bounds (lib/volume.rs:90-94) which is the same array.
    Triangle bounds = vertex AABB epsilon-expanded by 0.01
    (lib/core/mesh.rs:200-213).
    """
    c = np.asarray(spheres.center, np.float32).reshape(-1, 3)
    r = np.asarray(spheres.radius, np.float32).reshape(-1, 1)
    smin, smax = c - r, c + r

    v0 = np.asarray(triangles.v0, np.float32).reshape(-1, 3)
    e1 = np.asarray(triangles.e1, np.float32).reshape(-1, 3)
    e2 = np.asarray(triangles.e2, np.float32).reshape(-1, 3)
    v1, v2 = v0 + e1, v0 + e2
    tmin = np.minimum(v0, np.minimum(v1, v2))
    tmax = np.maximum(v0, np.maximum(v1, v2))
    tmin, tmax = aabb.epsilon_expand(tmin, tmax, 0.01)

    mins = np.concatenate([smin, tmin], axis=0)
    maxs = np.concatenate([smax, tmax], axis=0)
    return mins, maxs


def _build_topology(mins: np.ndarray, maxs: np.ndarray):
    """Median-split build -> DFS-flattened arrays.

    Returns (node_min, node_max, prim, hit_link, miss_link, depth).
    """
    n = mins.shape[0]
    cent = aabb.centroid(mins, maxs)

    node_min: list[np.ndarray] = []
    node_max: list[np.ndarray] = []
    prim: list[int] = []
    miss: list[int] = []

    max_depth = [0]

    # Median split halves by *count*, so the tree is always balanced and the
    # recursion depth is ~log2(n) — plain recursion is safe even for 100k
    # primitives.  Nodes are emitted in DFS order; a subtree root's miss link
    # is the index one past its subtree.
    def emit(ids: np.ndarray, depth: int) -> None:
        max_depth[0] = max(max_depth[0], depth)
        me = len(prim)
        if ids.shape[0] == 1:
            p = int(ids[0])
            node_min.append(mins[p])
            node_max.append(maxs[p])
            prim.append(p)
            miss.append(-1)  # patched by caller contract: leaf miss = me + 1
            miss[me] = me + 1
            return
        node_min.append(ids_min(ids))
        node_max.append(ids_max(ids))
        prim.append(-1)
        miss.append(-1)
        left, right = split(ids)
        emit(left, depth + 1)
        emit(right, depth + 1)
        miss[me] = len(prim)  # one past my whole subtree

    def ids_min(ids):
        return mins[ids].min(axis=0)

    def ids_max(ids):
        return maxs[ids].max(axis=0)

    def split(ids):
        c = cent[ids]
        spread = c.max(axis=0) - c.min(axis=0)
        sx, sy, sz = float(spread[0]), float(spread[1]), float(spread[2])
        # axis selection with the reference's exact tie-breaking
        # (lib/core/bvh.rs:81-88)
        if sx > sy and sx > sz:
            axis = 0
        elif sy > sx and sy > sz:
            axis = 1
        else:
            axis = 2
        order = np.argsort(c[:, axis], kind="stable")
        ids = ids[order]
        half = ids.shape[0] // 2
        return ids[:half], ids[half:]

    emit(np.arange(n, dtype=np.int64), 1)

    k = len(prim)
    prim_arr = np.asarray(prim, np.int32)
    miss_arr = np.asarray(miss, np.int32)
    # hit link: leaves continue at their miss link; inner nodes descend to
    # the next node in DFS order (their left child).
    hit_arr = np.where(prim_arr >= 0, miss_arr,
                       np.arange(1, k + 1, dtype=np.int32))
    return (
        np.stack(node_min).astype(np.float32),
        np.stack(node_max).astype(np.float32),
        prim_arr,
        hit_arr,
        miss_arr,
        max_depth[0],
    )


def build_bvh(spheres, triangles):
    """Build the scene-wide FlatBVH (None when the scene is empty)."""
    import jax.numpy as jnp

    from ..models.scene import FlatBVH

    mins, maxs = primitive_bounds(spheres, triangles)
    if mins.shape[0] == 0:
        return None

    try:
        from ..native import native_build_topology
        built = native_build_topology(mins, maxs)
    except Exception:
        built = None
    if built is None:
        built = _build_topology(mins, maxs)
    node_min, node_max, prim, hit_link, miss_link, depth = built

    return FlatBVH(
        node_min=jnp.asarray(node_min),
        node_max=jnp.asarray(node_max),
        prim=jnp.asarray(prim),
        hit_link=jnp.asarray(hit_link),
        miss_link=jnp.asarray(miss_link),
        depth=int(depth),
    )
