"""Table lookups as one-hot matmuls.

A lookup from a SMALL table is phrased as one-hot x table, a dense matmul
(a workaround for slow small gathers on the machine this was first written
for; on the GPU a gather is one load per ray — ROADMAP A5 measures it) (and its transpose — the VJP — is the exact scatter-add a gather would
need).  Above the threshold a real gather wins on FLOPs; below it, one-hot
wins on latency by orders of magnitude.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# tables up to this many rows go through one-hot matmul
ONE_HOT_MAX = 128


def tgather(table, ids):
    """``table[ids]`` as a one-hot matmul for small tables.

    table: (M,) or (M, K) array (float or int); ids: (...,) int32.
    Integer tables round-trip exactly through f32 for values < 2^24.
    """
    m = table.shape[0]
    if m > ONE_HOT_MAX:
        return table[ids]
    onehot = jax.nn.one_hot(ids, m, dtype=jnp.float32)
    flat = table.reshape(m, -1)
    is_int = jnp.issubdtype(table.dtype, jnp.integer)
    vals = jnp.dot(
        onehot, flat.astype(jnp.float32),
        precision=jax.lax.Precision.HIGHEST,
    )
    out = vals.reshape(ids.shape + table.shape[1:])
    if is_int:
        out = jnp.round(out).astype(table.dtype)
    return out
