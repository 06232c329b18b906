"""Pallas kernel (Triton route): radius-gated neighbour moments for CorAl.

The CorAl quality (reference AlignmentQuality.cpp:93-229) needs, for every
query point, the count / mean / second moment of the neighbours within 1 m in
another cloud.  The plain XLA form (ops.coral._neighbor_moments) is an
O(Q*P) broadcast-and-reduce; at loop-verification scale (Q = P = 4096 peaks)
it builds [Q, P] intermediates in device memory for each of the four calls
per candidate pair.

Here each program owns ``block_q`` queries and keeps the six running moments
in registers while a ``fori_loop`` walks the points in ``block_p`` tiles, so
device-memory traffic is the point lists plus six [Q] outputs.  The moments
accumulate elementwise per (query, lane) and are reduced over the lanes once
at the end, so the loop body has no cross-thread reduction.  There is no
cross-program accumulation: blocks run in any order.  Moments stay
query-centred (p - q), which keeps f32 exact at world range (neighbourhood
diameters ~2 m against coordinates of +-165 m); there is no matmul, so the
TF32 question does not arise inside the kernel.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

# Chosen by a sweep on an H100 (Q = P = 4096, 64 pairs): 64 x 16 with four
# warps keeps the six [64, 16] accumulators in registers; 64 x 64 or
# 128 x 32 spill and run 1.4-2.5x slower.
BLOCK_Q = 64  # queries per program (power of two)
BLOCK_P = 16  # points per inner-loop tile (power of two)
NUM_WARPS = 4


def _moments_kernel(r2_ref, qx_ref, qy_ref, qm_ref, px_ref, py_ref, pm_ref,
                    cnt_ref, sx_ref, sy_ref, sxx_ref, sxy_ref, syy_ref, *,
                    block_p: int, n_tiles: int):
    """One block of queries against every point tile.

    Inputs are plain vectors: q* [block_q], p* [Pp] (Pp a multiple of
    block_p), masks as 1.0 / 0.0 floats, r2 [1].  The six moments
    accumulate elementwise in [block_q, block_p] registers across the tiles
    and are reduced over the point axis once, at the end."""
    qx = qx_ref[...][:, None]
    qy = qy_ref[...][:, None]
    r2 = r2_ref[...][None, :]

    def tile(j, acc):
        sl = pl.ds(pl.multiple_of(j * block_p, block_p), block_p)
        rx = px_ref[sl][None, :] - qx  # [block_q, block_p]
        ry = py_ref[sl][None, :] - qy
        m = jnp.where(rx * rx + ry * ry <= r2, pm_ref[sl][None, :], 0.0)
        mx = rx * m
        my = ry * m
        return (acc[0] + m, acc[1] + mx, acc[2] + my,
                acc[3] + mx * rx, acc[4] + mx * ry, acc[5] + my * ry)

    zero = jnp.zeros((qx_ref.shape[0], block_p), jnp.float32)
    acc = lax.fori_loop(0, n_tiles, tile, (zero,) * 6)
    qm = qm_ref[...]  # masked queries report zero moments
    for ref, a in zip((cnt_ref, sx_ref, sy_ref, sxx_ref, sxy_ref, syy_ref),
                      acc):
        ref[...] = jnp.sum(a, axis=1) * qm


@functools.partial(jax.jit, static_argnames=("interpret",))
def neighbor_moments(queries, qmask, points, pmask, radius, *,
                     interpret: bool = False):
    """Per-query radius-neighbourhood moments via the Triton kernel.

    Returns (count [Q], sum_rel [Q, 2], sum_sq [Q, 2, 2]) of (p - q) over
    neighbours within ``radius`` -- the semantics of
    ops.coral._neighbor_moments.  ``interpret`` runs the kernel through the
    Pallas interpreter (CPU tests only).
    """
    block_q, block_p = BLOCK_Q, BLOCK_P
    nq = queries.shape[0]
    npts = points.shape[0]
    qp = -(-nq // block_q) * block_q
    pp = -(-npts // block_p) * block_p

    def pad(x, n):
        x = x.astype(jnp.float32)
        return jnp.pad(x, (0, n - x.shape[0]))

    r2 = jnp.reshape(jnp.asarray(radius, jnp.float32) ** 2, (1,))
    q_spec = pl.BlockSpec((block_q,), lambda i: (i,))
    p_spec = pl.BlockSpec((pp,), lambda i: (0,))
    cnt, sx, sy, sxx, sxy, syy = pl.pallas_call(
        functools.partial(_moments_kernel, block_p=block_p,
                          n_tiles=pp // block_p),
        out_shape=[jax.ShapeDtypeStruct((qp,), jnp.float32)] * 6,
        grid=(qp // block_q,),
        in_specs=[pl.BlockSpec((1,), lambda i: (0,)),
                  q_spec, q_spec, q_spec, p_spec, p_spec, p_spec],
        out_specs=[q_spec] * 6,
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS,
                                                 num_stages=1),
        interpret=interpret,
        name="coral_neighbor_moments",
    )(r2, pad(queries[:, 0], qp), pad(queries[:, 1], qp), pad(qmask, qp),
      pad(points[:, 0], pp), pad(points[:, 1], pp), pad(pmask, pp))

    sum_rel = jnp.stack([sx[:nq], sy[:nq]], axis=-1)
    sum_sq = jnp.stack([
        jnp.stack([sxx[:nq], sxy[:nq]], -1),
        jnp.stack([sxy[:nq], syy[:nq]], -1),
    ], axis=-2)
    return cnt[:nq], sum_rel, sum_sq
