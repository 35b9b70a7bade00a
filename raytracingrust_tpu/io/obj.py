"""Wavefront OBJ loader -> SoA triangle buffers.

Array twin of the reference's obj-rs ingestion
(``Mesh::from_file`` lib/core/mesh.rs:63-76): instead of a ``Vec<Vertex>`` of
structs we emit contiguous ``(V, 3)`` position/normal arrays and a ``(F, 3)``
index array, ready to be flattened into the global scene SoA.

Semantics matched to obj-rs' triangulating loader as the reference uses it:
  * only ``v``/``vn``/``f`` are consumed (``vt``, materials, MTLs ignored —
    the reference ignores them too, SURVEY.md section 2.5 "MTLs unused");
  * faces with >3 vertices are fan-triangulated;
  * negative (relative) indices supported;
  * a vertex is (position, normal) pair; faces missing normals get zero
    normals (the reference's assets all ship normals).
"""

from __future__ import annotations

import numpy as np


def load_obj(path: str):
    """Returns (positions (V,3) f32, normals (V,3) f32, faces (F,3) i32).

    V indexes the deduplicated (position-index, normal-index) pairs, matching
    obj-rs' vertex welding as consumed at lib/core/mesh.rs:64-76.
    """
    raw_pos: list[tuple[float, float, float]] = []
    raw_nrm: list[tuple[float, float, float]] = []
    vert_cache: dict[tuple[int, int], int] = {}
    positions: list[tuple[float, float, float]] = []
    normals: list[tuple[float, float, float]] = []
    faces: list[tuple[int, int, int]] = []

    def resolve(idx: int, n: int) -> int:
        return idx - 1 if idx > 0 else n + idx

    def vertex(token: str) -> int:
        parts = token.split("/")
        pi = resolve(int(parts[0]), len(raw_pos))
        ni = -1
        if len(parts) >= 3 and parts[2]:
            ni = resolve(int(parts[2]), len(raw_nrm))
        key = (pi, ni)
        cached = vert_cache.get(key)
        if cached is not None:
            return cached
        vert_cache[key] = len(positions)
        positions.append(raw_pos[pi])
        normals.append(raw_nrm[ni] if ni >= 0 else (0.0, 0.0, 0.0))
        return vert_cache[key]

    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            if parts[0] == "v" and len(parts) >= 4:
                raw_pos.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "vn" and len(parts) >= 4:
                raw_nrm.append((float(parts[1]), float(parts[2]), float(parts[3])))
            elif parts[0] == "f" and len(parts) >= 4:
                idx = [vertex(tok) for tok in parts[1:]]
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append((idx[0], idx[k], idx[k + 1]))

    return (
        np.asarray(positions, np.float32).reshape(-1, 3),
        np.asarray(normals, np.float32).reshape(-1, 3),
        np.asarray(faces, np.int32).reshape(-1, 3),
    )
