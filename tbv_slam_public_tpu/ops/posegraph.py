"""Pose-graph optimization as batched SE(2) Gauss-Newton / LM.

Replacement for the reference's Ceres pose-graph solver
(tbv_slam/src/tbv_slam/ceresoptimizer.cpp:13-110): the per-edge
PoseGraph3dErrorTerm residual (ceresoptimizer.h:51-95) becomes one batched
computation over a padded SoA edge store, and SPARSE_NORMAL_CHOLESKY
(ceresoptimizer.cpp:56) becomes one of three solvers:

- ``solver="schur"`` (the structured fast path): SLAM graphs are an odometry
  CHAIN plus sparse loop edges.  The chain Hessian factorizes by one level
  of substructuring — B independent dense segments eliminated with a single
  batched Cholesky, a small dense separator system — and the loop edges
  fold in exactly via a Woodbury solve whose capacitance is the Schur
  complement on the loop-edge space (_partitioned_tridiag_solve +
  _schur_solve).  O(1) sequential depth; per-iteration cost is a handful of
  batched small-matrix ops.
- ``solver="cholesky"``: dense normal equations; the sparse Jacobian is
  materialized in edge chunks and contracted J^T J as one matmul, then one
  dense 3Nx3N Cholesky.
- ``solver="cg"``: matrix-free block-Jacobi preconditioned CG; Hv products
  are edge-local followed by a reduction — the form that shards across chips
  (edges partitioned, psum over the mesh; see tbv_slam_public_tpu.parallel).

Everything runs under ``jax.default_matmul_precision("highest")``: the GPU's
default TF32 matmuls keep ~3 decimal digits, which puts ~1e-3 relative noise
on H and g and silently turns superlinear LM convergence into a noise-floor
crawl.

Robustification follows the reference: odometry edges take no loss, loop
edges a Cauchy(0.1) loss applied by IRLS reweighting
(ceresoptimizer.cpp:34-35); with ``replace_cov_by_identity`` the information
is diag(1/0.01, 1/0.01, 1/0.001) and loop edges are additionally divided by
``loop_scaling`` (ceresoptimizer.cpp:83-100).  The first pose is gauge-fixed
(ceresoptimizer.cpp:58 SetParameterBlockConstant analogue).

Planar (SE(2)) restriction: the reference's PoseGraph3dErrorTerm is a full
SE(3) residual (ceresoptimizer.h:61-95), but the radar datasets are planar
and the reference itself flattens ground truth to the plane at ingestion
(offline_odometry.cpp:80-96) — so for every graph this pipeline produces,
the SE(3) residual's z/roll/pitch rows are identically zero and its
remaining rows coincide with this module's SE(2) residual (the quaternion
row is 2 sin(dyaw/2) vs wrap(dyaw): same zero set, same Gauss-Newton
direction; tests/test_posegraph.py::
test_planar_restriction_matches_se3_residual proves the equivalence).
Poses are lifted to SE(3) only at export (core/se3.py).
"""
from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import se2
from ..core.config import PGOConfig
from ..core.types import ODOMETRY, GraphEdges


class PGOResult(NamedTuple):
    poses: jnp.ndarray  # [N, 3] optimized
    cost0: jnp.ndarray  # [] initial cost
    cost: jnp.ndarray  # [] final cost
    iterations: jnp.ndarray  # [] int32 accepted LM iterations


def default_sqrt_info(etype: jnp.ndarray, cfg: PGOConfig) -> jnp.ndarray:
    """Per-edge diagonal sqrt-information under replace_cov_by_identity.

    Reference: covariance diag(0.01, 0.01, 0.001); loop information divided by
    loop_scaling (ceresoptimizer.cpp:83-100).
    """
    base = jnp.sqrt(jnp.asarray(
        [1.0 / cfg.odom_vxx, 1.0 / cfg.odom_vyy, 1.0 / cfg.odom_vtt],
        jnp.float32))
    scale = jnp.where(etype == ODOMETRY, 1.0,
                      1.0 / jnp.sqrt(cfg.loop_scaling)).astype(jnp.float32)
    return scale[:, None] * base[None, :]


def measured_sqrt_info(cov: jnp.ndarray, etype: jnp.ndarray,
                       cfg: PGOConfig) -> jnp.ndarray:
    """Full-matrix sqrt-information from measured registration covariances —
    the replace_cov_by_identity=false path (ceresoptimizer.cpp:92-100):
    I_scaled = cov^{-1} * loop_scale_factor, whitening S = chol(I_scaled)
    (the reference's sqrt_information = I_scaled.llt().matrixL(),
    ceresoptimizer.cpp:102, restricted to the (x, y, yaw) plane).

    ``cov`` [E, 3, 3]; returns [E, 3, 3].  Degenerate covariances fall back
    to the identity-scaled diagonal for that edge.
    """
    cov = jnp.asarray(cov, jnp.float32)
    e = cov.shape[0]
    eye = jnp.eye(3, dtype=jnp.float32)
    # symmetrize + floor eigenvalues via a small ridge before inverting
    covs = 0.5 * (cov + jnp.swapaxes(cov, -1, -2)) + 1e-9 * eye[None]
    info = jnp.linalg.inv(covs)
    scale = jnp.where(etype == ODOMETRY, 1.0,
                      1.0 / cfg.loop_scaling).astype(jnp.float32)
    info = info * scale[:, None, None]
    s = jnp.linalg.cholesky(info)
    ok = jnp.all(jnp.isfinite(s.reshape(e, -1)), axis=-1)
    fallback = jax.vmap(jnp.diag)(default_sqrt_info(etype, cfg))
    return jnp.where(ok[:, None, None], jnp.nan_to_num(s), fallback)


def _edge_residuals(poses: jnp.ndarray, edges: GraphEdges):
    """Whitened residuals r [E,3] and the raw geometry terms used by jacobians.

    r = S [R(th_b)^T (p_e - p_b) - t_be ; wrap(th_e - th_b - th_be)] with the
    full 3x3 whitening S = sqrt-information (PoseGraph3dErrorTerm,
    ceresoptimizer.h:61-95, restricted to the plane; S is diagonal under
    replace_cov_by_identity and a Cholesky factor for measured covariances).
    """
    pb = poses[edges.idx[:, 0]]  # [E, 3]
    pe = poses[edges.idx[:, 1]]
    c, s = jnp.cos(pb[:, 2]), jnp.sin(pb[:, 2])
    dx = pe[:, 0] - pb[:, 0]
    dy = pe[:, 1] - pb[:, 1]
    # R^T d
    rx = c * dx + s * dy
    ry = -s * dx + c * dy
    rtheta = se2.wrap_angle(pe[:, 2] - pb[:, 2] - edges.meas[:, 2])
    raw = jnp.stack([rx - edges.meas[:, 0], ry - edges.meas[:, 1], rtheta], -1)
    r = jnp.einsum("eij,ej->ei", edges.sqrt_info, raw)
    return r, (c, s, dx, dy)


def _edge_jacobians(poses: jnp.ndarray, edges: GraphEdges):
    """Whitened jacobian blocks Jb, Je [E, 3, 3] wrt (x, y, theta) of b and e."""
    r, (c, s, dx, dy) = _edge_residuals(poses, edges)
    zeros = jnp.zeros_like(c)
    ones = jnp.ones_like(c)
    # d(R^T d)/d p_b = -R^T ; d(R^T d)/d th_b = dR^T/dth d
    Jb = jnp.stack([
        jnp.stack([-c, -s, -s * dx + c * dy], -1),
        jnp.stack([s, -c, -c * dx - s * dy], -1),
        jnp.stack([zeros, zeros, -ones], -1),
    ], axis=-2)  # [E, 3, 3]
    Je = jnp.stack([
        jnp.stack([c, s, zeros], -1),
        jnp.stack([-s, c, zeros], -1),
        jnp.stack([zeros, zeros, ones], -1),
    ], axis=-2)
    S = edges.sqrt_info  # [E, 3, 3] whitening
    return r, jnp.einsum("eij,ejk->eik", S, Jb), jnp.einsum(
        "eij,ejk->eik", S, Je)


def _cauchy_weights(r: jnp.ndarray, edges: GraphEdges, cfg: PGOConfig):
    """Per-edge (rho(s), IRLS weight): Cauchy(0.1) on loops, none on odometry
    (ceresoptimizer.cpp:34-35)."""
    s = jnp.sum(r * r, axis=-1)
    b = cfg.cauchy_scale * cfg.cauchy_scale
    rho_c = b * jnp.log1p(s / b)
    w_c = 1.0 / (1.0 + s / b)
    is_odom = edges.etype == ODOMETRY
    rho = jnp.where(is_odom, s, rho_c)
    w = jnp.where(is_odom, 1.0, w_c)
    w = jnp.where(edges.mask, w, 0.0)
    rho = jnp.where(edges.mask, rho, 0.0)
    return rho, w


def graph_cost(poses: jnp.ndarray, edges: GraphEdges, cfg: PGOConfig):
    r, _ = _edge_residuals(poses, edges)
    rho, _ = _cauchy_weights(r, edges, cfg)
    return 0.5 * jnp.sum(rho)


def _incidence(edges: GraphEdges, n: int, dtype):
    """One-hot begin/end incidence matrices [E, N] (masked edges zeroed).

    Every edge->node reduction below is expressed as a matmul against these
    one-hots instead of a scatter-add (at HIGHEST precision the one-hot
    selection is exact); which form is faster on the GPU is unmeasured.
    """
    cols = jnp.arange(n)
    m = edges.mask[:, None]
    ub = ((edges.idx[:, 0:1] == cols[None, :]) & m).astype(dtype)
    ue = ((edges.idx[:, 1:2] == cols[None, :]) & m).astype(dtype)
    return ub, ue


def _gradient_and_blocks(poses, edges, cfg: PGOConfig):
    """IRLS gradient [N,3] and the sqrt(w)-weighted per-edge jacobian blocks
    (Jb, Je) from which H = J^T J is assembled."""
    r, Jb, Je = _edge_jacobians(poses, edges)
    rho, w = _cauchy_weights(r, edges, cfg)
    cost = 0.5 * jnp.sum(rho)
    wr = w[:, None] * r
    n = poses.shape[0]
    gb = jnp.einsum("eij,ei->ej", Jb, wr)
    ge = jnp.einsum("eij,ei->ej", Je, wr)
    ub, ue = _incidence(edges, n, poses.dtype)
    g = ub.T @ gb + ue.T @ ge
    sw = jnp.sqrt(w)[:, None, None]
    return cost, g, (sw * Jb, sw * Je)


def _dense_hessian(n, edges, blocks, gauge_mask):
    """Assemble the dense [3N,3N] Hessian from the 3x3 edge blocks.

    Matmul form: materialize the sparse whitened+weighted Jacobian as a dense
    [3E, 3N] matrix (each edge row-block has its Jb/Je 3x3 at columns b/e,
    placed by one-hot broadcast) and form H = J^T J with ONE [3N,3E]x[3E,3N]
    matmul — a single large systolic contraction instead of four 3-operand
    einsum contractions.  The 3x3 edge blocks arrive pre-weighted with
    sqrt(w) folded in by the caller.

    ``gauge_mask`` [N] bool marks FREE nodes; fixed/padded nodes get identity
    rows/cols so the factorization stays SPD without changing free DoFs.
    """
    Jb, Je = blocks  # [E, 3, 3] sqrt(w)-weighted whitened jacobians
    e = Jb.shape[0]
    ub, ue = _incidence(edges, n, Jb.dtype)

    def chunk_jtj(h, inp):
        jb, je, cb, ce = inp  # [ec,3,3], [ec,3,3], [ec,N], [ec,N]
        # [ec, 3, 3, N] -> [3ec, 3N]: row (e, r), col (n, j)
        J = (jb[:, :, :, None] * cb[:, None, None, :]
             + je[:, :, :, None] * ce[:, None, None, :])
        J = J.transpose(0, 1, 3, 2).reshape(-1, 3 * n)
        return h + J.T @ J, None

    # chunk the edge axis so the materialized [3ec, 3N] jacobian slab stays
    # ~100 MB (the full J at reference graph scale exceeds HBM)
    ec = e
    while ec * 9 * n * 4 > 1.5e8 and ec % 2 == 0:
        ec //= 2
    nc = e // ec
    inp = (Jb.reshape(nc, ec, 3, 3), Je.reshape(nc, ec, 3, 3),
           ub.reshape(nc, ec, n), ue.reshape(nc, ec, n))
    if nc == 1:
        H, _ = chunk_jtj(jnp.zeros((3 * n, 3 * n), Jb.dtype),
                         jax.tree.map(lambda x: x[0], inp))
    else:
        H, _ = jax.lax.scan(chunk_jtj,
                            jnp.zeros((3 * n, 3 * n), Jb.dtype), inp)
    free = jnp.repeat(gauge_mask, 3)
    keep = free[:, None] & free[None, :]
    H = jnp.where(keep, H, 0.0)
    H = H + jnp.diag(jnp.where(free, 0.0, 1.0))
    return H


def _hvp(v, edges, w, Jb, Je, gauge_mask):
    """Matrix-free H v for the CG path; v [N,3] -> [N,3].

    Edge-wise: y_e = w * (Jb v_b + Je v_e); scatter Jb^T y, Je^T y.  Under
    shard_map the two scatter-adds become psum-reduced partial sums.
    """
    v = jnp.where(gauge_mask[:, None], v, 0.0)
    vb = v[edges.idx[:, 0]]
    ve = v[edges.idx[:, 1]]
    y = w[:, None] * (jnp.einsum("eij,ej->ei", Jb, vb)
                      + jnp.einsum("eij,ej->ei", Je, ve))
    out = jnp.zeros_like(v)
    out = out.at[edges.idx[:, 0]].add(jnp.einsum("eij,ei->ej", Jb, y))
    out = out.at[edges.idx[:, 1]].add(jnp.einsum("eij,ei->ej", Je, y))
    return jnp.where(gauge_mask[:, None], out, 0.0)


def _block_diag(n, edges, blocks, gauge_mask):
    wJb, wJe = blocks
    Hbb = jnp.einsum("eri,erj->eij", wJb, wJb)
    Hee = jnp.einsum("eri,erj->eij", wJe, wJe)
    D = jnp.zeros((n, 3, 3), Hbb.dtype)
    D = D.at[edges.idx[:, 0]].add(Hbb)
    D = D.at[edges.idx[:, 1]].add(Hee)
    eye = jnp.eye(3, dtype=Hbb.dtype)
    return jnp.where(gauge_mask[:, None, None], D, eye[None])


def _pcg_solve(b, edges, w, Jb, Je, diag_blocks, gauge_mask, lam, iters, tol):
    """Block-Jacobi preconditioned CG on (H + lam*diag(H)) x = b."""
    lam_diag = lam * jnp.diagonal(diag_blocks, axis1=-2, axis2=-1)  # [N, 3]
    damp = (diag_blocks + jax.vmap(jnp.diag)(lam_diag)
            + 1e-9 * jnp.eye(3)[None])
    Minv = jnp.linalg.inv(damp)

    def A(v):
        return _hvp(v, edges, w, Jb, Je, gauge_mask) + lam_diag * v + 1e-9 * v

    def precond(v):
        return jnp.einsum("nij,nj->ni", Minv, v)

    x0 = jnp.zeros_like(b)
    r0 = b
    z0 = precond(r0)
    p0 = z0
    rz0 = jnp.sum(r0 * z0)
    bnorm = jnp.sqrt(jnp.sum(b * b)) + 1e-30

    def body(_, state):
        x, r, p, rz, active = state
        Ap = A(p)
        denom = jnp.sum(p * Ap)
        alpha = jnp.where(denom > 0, rz / jnp.maximum(denom, 1e-30), 0.0)
        xn = x + alpha * p
        rn = r - alpha * Ap
        zn = precond(rn)
        rzn = jnp.sum(rn * zn)
        beta = rzn / jnp.maximum(rz, 1e-30)
        pn = zn + beta * p
        done = jnp.sqrt(jnp.sum(rn * rn)) < tol * bnorm
        keep = active & ~done & (denom > 0)
        pick = lambda a_new, a_old: jnp.where(active, a_new, a_old)
        return (pick(xn, x), pick(rn, r), pick(pn, p),
                jnp.where(active, rzn, rz), keep)

    x, *_ = jax.lax.fori_loop(
        0, iters, body, (x0, r0, p0, rz0, jnp.asarray(True)))
    return x


def _ptd_interior(Dr, Orr, f_prev):
    """Segment-interior elimination for a batch of segments: Dr/Orr
    [B, seg, 3, 3] (any B — the full set, or one device's shard), ``f_prev``
    [B, 3, 3] the coupling from each segment's PRECEDING separator into its
    first node (zeros for the global first segment).

    Returns the per-segment factors and separator-reduction contributions —
    everything that is embarrassingly parallel across segments, so a
    distributed caller can shard B across a mesh (parallel.pgo)."""
    import jax.scipy.linalg as jsl

    nb, seg = Dr.shape[0], Dr.shape[1]
    m = seg - 1  # interior nodes per segment

    # segment interior matrices A [B, 3m, 3m]
    A = jnp.zeros((nb, m, 3, m, 3), Dr.dtype)
    for i in range(m):
        A = A.at[:, i, :, i, :].set(Dr[:, i])
    for i in range(m - 1):
        A = A.at[:, i, :, i + 1, :].set(Orr[:, i])
        A = A.at[:, i + 1, :, i, :].set(
            jnp.swapaxes(Orr[:, i], -1, -2))
    A = A.reshape(nb, 3 * m, 3 * m)
    eye_m = jnp.eye(3 * m, dtype=Dr.dtype)
    L = jnp.linalg.cholesky(A + 1e-12 * eye_m)
    A_inv = jax.vmap(lambda lb: jsl.cho_solve((lb, True), eye_m))(L)

    # couplings: c_s = O[seg interior last -> separator s] (edge m-1 of chunk)
    c = Orr[:, m - 1]  # [B, 3, 3] node (s, m-1) -> sep s
    d_sep = Dr[:, seg - 1]  # [B, 3, 3]

    # E_s: segment-to-own-separator coupling lives at interior row m-1;
    # F_s: segment s's coupling to separator s-1 lives at interior row 0.
    E = jnp.zeros((nb, 3 * m, 3), Dr.dtype).at[:, 3 * (m - 1):, :].set(c)
    F = jnp.zeros((nb, 3 * m, 3), Dr.dtype).at[:, :3, :].set(
        jnp.swapaxes(f_prev, -1, -2))
    Ainv_E = jnp.einsum("bij,bjk->bik", A_inv, E,
                        precision=jax.lax.Precision.HIGHEST)
    Ainv_F = jnp.einsum("bij,bjk->bik", A_inv, F,
                        precision=jax.lax.Precision.HIGHEST)
    EtAE = jnp.einsum("bri,brj->bij", E, Ainv_E)
    FtAF = jnp.einsum("bri,brj->bij", F, Ainv_F)
    FtAE = jnp.einsum("bri,brj->bij", F, Ainv_E)
    return dict(A_inv=A_inv, E=E, F=F, Ainv_E=Ainv_E, Ainv_F=Ainv_F,
                EtAE=EtAE, FtAF=FtAF, FtAE=FtAE, d_sep=d_sep)


def _ptd_reduce(d_sep, EtAE, FtAF, FtAE):
    """Assemble + invert the GLOBAL reduced separator system from per-segment
    contributions [B, 3, 3] (dense 3B x 3B: B is small)."""
    import jax.scipy.linalg as jsl

    nb = d_sep.shape[0]
    # D~_s = D_sep_s - E_s^T A_s^{-1} E_s - F_{s+1}^T A_{s+1}^{-1} F_{s+1}
    FtAF_next = jnp.concatenate([FtAF[1:], jnp.zeros_like(FtAF[:1])], 0)
    d_red = d_sep - EtAE - FtAF_next
    # off-diagonal (sep s, sep s+1): - F_{s+1}^T A_{s+1}^{-1} E_{s+1}
    o_red = -jnp.concatenate([FtAE[1:], jnp.zeros_like(FtAE[:1])], 0)

    R = jnp.zeros((nb, 3, nb, 3), d_sep.dtype)
    di = jnp.arange(nb)
    R = R.at[di, :, di, :].set(d_red)
    R = R.at[di[:-1], :, di[:-1] + 1, :].set(o_red[:-1])
    R = R.at[di[:-1] + 1, :, di[:-1], :].set(
        jnp.swapaxes(o_red[:-1], -1, -2))
    R = R.reshape(3 * nb, 3 * nb)
    eye_r = jnp.eye(3 * nb, dtype=d_sep.dtype)
    return jsl.cho_solve(jsl.cho_factor(R + 1e-12 * eye_r), eye_r)


def _partitioned_tridiag_prepare(D, O, seg: int):
    """Factorization phase of the substructured block-tridiagonal solve.

    Nodes are partitioned into chunks of ``seg``; the last node of each chunk
    is a separator.  Chunk interiors (B independent dense segments) are
    eliminated with ONE batched Cholesky whose inverse is materialized —
    batched TRIANGULAR solves are sequential within the block while
    A^{-1} @ rhs is a plain batched matmul; the extra f32
    error of the explicit inverse is mopped up by the Jacobi equilibration +
    refinement layers above this routine.  Everything rhs-independent
    (interior inverses, separator reduction, its inverse) is computed HERE so
    repeated solves against the same T — the Woodbury solve does several —
    factorize exactly once.

    D [N,3,3], O [N,3,3] (O[i] couples i,i+1; O[N-1] must be zero);
    N must be divisible by seg.  Returns an opaque context for
    :func:`_partitioned_tridiag_apply`.
    """
    n = D.shape[0]
    assert n % seg == 0, (n, seg)
    nb = n // seg
    m = seg - 1
    Dr = D.reshape(nb, seg, 3, 3)
    Orr = O.reshape(nb, seg, 3, 3)
    # f_s = O[separator s -> first node of chunk s+1] (edge seg-1 of chunk)
    f = Orr[:, seg - 1]  # [B, 3, 3]; f[B-1] == 0
    f_prev = jnp.concatenate([jnp.zeros_like(f[:1]), f[:-1]], 0)
    loc = _ptd_interior(Dr, Orr, f_prev)
    R_inv = _ptd_reduce(loc["d_sep"], loc["EtAE"], loc["FtAF"], loc["FtAE"])
    return dict(n=n, nb=nb, seg=seg, m=m, A_inv=loc["A_inv"], E=loc["E"],
                F=loc["F"], Ainv_E=loc["Ainv_E"], Ainv_F=loc["Ainv_F"],
                R_inv=R_inv)


def _ptd_apply_interior(A_inv, E, F, b_r):
    """Per-segment forward phase of the solve: ``b_r`` [B, seg, 3, K] (the
    segment batch may be a device-local shard).  Returns (Ainv_b [B,3m,K],
    EtAb [B,3,K], FtAb [B,3,K], b_sep [B,3,K])."""
    seg = b_r.shape[1]
    nb, k = b_r.shape[0], b_r.shape[-1]
    b_int = b_r[:, :seg - 1].reshape(nb, 3 * (seg - 1), k)
    Ainv_b = jnp.einsum("bij,bjk->bik", A_inv, b_int,
                        precision=jax.lax.Precision.HIGHEST)
    b_sep = b_r[:, seg - 1]  # [B, 3, K]
    EtAb = jnp.einsum("bri,brk->bik", E, Ainv_b)
    FtAb = jnp.einsum("bri,brk->bik", F, Ainv_b)
    return Ainv_b, EtAb, FtAb, b_sep


def _ptd_apply_back(Ainv_E, Ainv_F, Ainv_b, x_sep, x_sep_prev):
    """Per-segment back-substitution:
    x_seg_s = A^{-1} b_seg - A^{-1}E x_sep_s - A^{-1}F x_sep_{s-1}."""
    return (Ainv_b
            - jnp.einsum("bri,bik->brk", Ainv_E, x_sep)
            - jnp.einsum("bri,bik->brk", Ainv_F, x_sep_prev))


def _partitioned_tridiag_apply(ctx, b):
    """Solve phase: b [N,3,K] -> T^{-1} b using a prepared factorization.
    Pure matmuls — no factorizations, no triangular solves."""
    n, nb, seg, m = ctx["n"], ctx["nb"], ctx["seg"], ctx["m"]
    k = b.shape[-1]
    b_r = b.reshape(nb, seg, 3, k)
    Ainv_b, EtAb, FtAb, b_sep = _ptd_apply_interior(
        ctx["A_inv"], ctx["E"], ctx["F"], b_r)
    FtAb_next = jnp.concatenate([FtAb[1:], jnp.zeros_like(FtAb[:1])], 0)
    b_red = b_sep - EtAb - FtAb_next
    x_sep = jnp.matmul(ctx["R_inv"], b_red.reshape(3 * nb, k),
                       precision=jax.lax.Precision.HIGHEST)
    x_sep = x_sep.reshape(nb, 3, k)
    x_sep_prev = jnp.concatenate([jnp.zeros_like(x_sep[:1]), x_sep[:-1]], 0)
    x_int = _ptd_apply_back(ctx["Ainv_E"], ctx["Ainv_F"], Ainv_b,
                            x_sep, x_sep_prev)
    x = jnp.concatenate([x_int.reshape(nb, m, 3, k),
                         x_sep[:, None, :, :]], axis=1)
    return x.reshape(n, 3, k)


def _partitioned_tridiag_solve(D, O, b, seg: int):
    """One-shot prepare+apply (kept for tests and single-solve callers)."""
    return _partitioned_tridiag_apply(_partitioned_tridiag_prepare(D, O, seg),
                                      b)


def _chain_blocks(n, edges, wJb, wJe, gauge_mask):
    """Block-tridiagonal (D, O) of the odometry-chain part of H from
    gauge-projected whitened jacobians: D [N,3,3] diagonal blocks,
    O [N,3,3] with O[i] coupling (i, i+1).  Partial sums — shard-local when
    edges are sharded; callers psum before use."""
    is_chain = ((edges.idx[:, 1] == edges.idx[:, 0] + 1)
                & (edges.etype == ODOMETRY) & edges.mask)
    cb = jnp.where(is_chain[:, None, None], wJb, 0.0)
    ce = jnp.where(is_chain[:, None, None], wJe, 0.0)
    Hbb = jnp.einsum("eri,erj->eij", cb, cb)
    Hee = jnp.einsum("eri,erj->eij", ce, ce)
    Hbe = jnp.einsum("eri,erj->eij", cb, ce)
    D = jnp.zeros((n, 3, 3), wJb.dtype)
    D = D.at[edges.idx[:, 0]].add(Hbb)
    D = D.at[edges.idx[:, 1]].add(Hee)
    O = jnp.zeros((n, 3, 3), wJb.dtype)
    O = O.at[jnp.minimum(edges.idx[:, 0], n - 1)].add(
        jnp.where(is_chain[:, None, None], Hbe, 0.0))
    return D, O


def _chain_precond_prepare(D, O, gauge_mask, lam_diag, seg: int = 16):
    """Factorize T = chain + damping (+ gauge identity) for use as a CG
    preconditioner: Jacobi equilibration + the partitioned tridiagonal
    factorization of :func:`_partitioned_tridiag_prepare`.  Returns
    (ctx, dscale, pad_n, n); apply with :func:`_chain_precond_apply`.
    T is tiny ([N,3,3] ~ 160 KB at reference scale), so a replicated
    factorization costs nothing while turning CG on the SLAM chain (whose
    unpreconditioned condition number grows ~N^3) into a rank-3L identity
    perturbation."""
    n = D.shape[0]
    eye = jnp.eye(3, dtype=D.dtype)
    D = D + jax.vmap(jnp.diag)(lam_diag) + 1e-8 * eye[None]
    D = jnp.where(gauge_mask[:, None, None], D, eye[None])
    O = jnp.where((gauge_mask[:-1] & gauge_mask[1:])[:, None, None],
                  O[:-1], 0.0)
    O = jnp.concatenate([O, jnp.zeros((1, 3, 3), D.dtype)], 0)
    dscale = 1.0 / jnp.sqrt(jnp.maximum(
        jnp.diagonal(D, axis1=-2, axis2=-1), 1e-20))
    Ds = D * dscale[:, :, None] * dscale[:, None, :]
    ds_next = jnp.concatenate([dscale[1:], jnp.ones_like(dscale[:1])], 0)
    Os = O * dscale[:, :, None] * ds_next[:, None, :]
    pad_n = (-n) % seg
    if pad_n:
        eye_pad = jnp.broadcast_to(eye, (pad_n, 3, 3))
        Ds = jnp.concatenate([Ds, eye_pad], 0)
        Os = jnp.concatenate([Os, jnp.zeros((pad_n, 3, 3), D.dtype)], 0)
    ctx = _partitioned_tridiag_prepare(Ds, Os, seg=seg)
    return ctx, dscale, pad_n, n


def _chain_precond_apply(prep, v):
    """v [N,3] -> T^{-1} v using a prepared chain preconditioner."""
    ctx, dscale, pad_n, n = prep
    rs = (v * dscale)[:, :, None]
    if pad_n:
        rs = jnp.concatenate(
            [rs, jnp.zeros((pad_n, 3, 1), rs.dtype)], 0)
    x = _partitioned_tridiag_apply(ctx, rs)
    if pad_n:
        x = x[:n]
    return x[..., 0] * dscale


def _schur_solve(n, edges, blocks, gauge_mask, lam_diag, g, loop_idx,
                 refine_level: int = 2, seg_cap: int = 16):
    """Direct solve of (H + damping) x = -g exploiting SLAM structure:
    H = T + U^T U where T is the block-tridiagonal odometry-chain part
    (+ damping + gauge) and U stacks the whitened loop-edge jacobian rows.

    Woodbury/Schur: x = T^{-1}b - T^{-1}U^T (I + U T^{-1} U^T)^{-1} U T^{-1}b,
    with ONE batched tridiagonal solve over 3L+1 right-hand sides and a small
    dense Cholesky of the 3L x 3L capacitance (the Schur complement on the
    loop-edge space; SURVEY §2.6 "Schur-complement reduction").  Loop count L
    is static (``loop_idx`` is a padded [L] edge-index array; padded slots
    must point at masked edges so their jacobians are zero).
    """
    wJb, wJe = blocks
    is_chain = ((edges.idx[:, 1] == edges.idx[:, 0] + 1)
                & (edges.etype == ODOMETRY) & edges.mask)
    free_b = gauge_mask[edges.idx[:, 0]]
    free_e = gauge_mask[edges.idx[:, 1]]
    # gauge projection: zero jacobian columns of fixed nodes
    wJb = jnp.where(free_b[:, None, None], wJb, 0.0)
    wJe = jnp.where(free_e[:, None, None], wJe, 0.0)

    D, O = _chain_blocks(n, edges, wJb, wJe, gauge_mask)

    # loop-edge diagonal contributions live in U^T U; damping over the FULL
    # diagonal (chain + loops) goes into T
    is_loop = edges.mask & ~is_chain
    lv = is_loop[loop_idx][:, None, None]
    lb = jnp.where(lv, wJb[loop_idx], 0.0)  # [L, 3, 3]
    le = jnp.where(lv, wJe[loop_idx], 0.0)
    bidx = edges.idx[loop_idx, 0]
    eidx = edges.idx[loop_idx, 1]
    D = D + jax.vmap(jnp.diag)(lam_diag)  # [N,3] damping on diagonal
    eye = jnp.eye(3, dtype=D.dtype)
    D = D + 1e-8 * eye[None]  # keep T SPD at nodes with no chain edges
    D = jnp.where(gauge_mask[:, None, None], D, eye[None])

    # Jacobi equilibration of T (the chain spans ~4 orders of magnitude
    # between translation and rotation information) + one refinement pass
    # per T-solve: keeps the f32 Thomas recursion accurate enough that the
    # LM step matches the dense solve.
    dscale = 1.0 / jnp.sqrt(jnp.maximum(
        jnp.diagonal(D, axis1=-2, axis2=-1), 1e-20))  # [N, 3]
    Ds = D * dscale[:, :, None] * dscale[:, None, :]
    ds_next = jnp.concatenate([dscale[1:], jnp.ones_like(dscale[:1])], 0)
    Os = O * dscale[:, :, None] * ds_next[:, None, :]

    def matvec_t(x):  # [N,3,K] -> T_s x
        y = jnp.einsum("nij,njk->nik", Ds, x)
        xn = jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], 0)
        xp = jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], 0)
        op = jnp.concatenate([jnp.zeros_like(Os[:1]), Os[:-1]], 0)
        y = y + jnp.einsum("nij,njk->nik", Os, xn)
        y = y + jnp.einsum("nji,njk->nik", op, xp)
        return y

    # Partitioned (substructured) solve: pad T with identity blocks to a
    # multiple of the segment size so ANY node count takes the O(1)-depth
    # path.  ``seg_cap`` (PGOConfig.schur_seg) bounds the segment size; the
    # default 16 keeps the batched interior Cholesky on XLA's fast
    # small-matrix path — measured sweep in core/config.py.
    seg = min(seg_cap, max(4, 1 << (max(n, 2) - 1).bit_length() - 2))
    pad_n = (-n) % seg
    if pad_n:
        eye_pad = jnp.broadcast_to(jnp.eye(3, dtype=D.dtype), (pad_n, 3, 3))
        Ds_p = jnp.concatenate([Ds, eye_pad], 0)
        Os_p = jnp.concatenate([Os, jnp.zeros((pad_n, 3, 3), D.dtype)], 0)
    else:
        Ds_p, Os_p = Ds, Os
    # factorize T ONCE; every solve below (batched Woodbury rhs, refinement
    # passes, the two single-column woodbury() calls) is then pure matmuls
    t_ctx = _partitioned_tridiag_prepare(Ds_p, Os_p, seg=seg)

    def _solve_t_once(rhs, refine):  # [N,3,K] equilibrated solve
        rs = rhs * dscale[:, :, None]
        if pad_n:
            rs = jnp.concatenate(
                [rs, jnp.zeros((pad_n,) + rs.shape[1:], rs.dtype)], 0)
        x1 = _partitioned_tridiag_apply(t_ctx, rs)
        if refine:
            x1 = x1 + _partitioned_tridiag_apply(t_ctx, rs - _matvec_pad(x1))
        if pad_n:
            x1 = x1[:n]
        return x1 * dscale[:, :, None]

    def _matvec_pad(x):  # T_s x on the padded system
        if not pad_n:
            return matvec_t(x)
        y = matvec_t(x[:n])
        return jnp.concatenate([y, x[n:]], 0)

    def solve_t(rhs, refine=False):
        # Chunk the rhs columns only when the [N, 3, K] temporaries would
        # actually pressure HBM (~256 MB per buffer).  At reference graph
        # scale (N~4.5k, K~1.3k: 72 MB) this stays a SINGLE batched solve —
        # a fixed chunk=768 forced a lax.map here, a map-under-vmap program
        # that compiled badly at 4096 nodes.  ``refine`` adds one
        # iterative-refinement
        # pass (2x cost) — only needed for the single-column solves whose
        # error is not mopped up by the outer Woodbury refinement.
        k_tot = rhs.shape[-1]
        chunk = max(768, int(2.7e8 // (n * 12)))
        if k_tot <= chunk:
            return _solve_t_once(rhs, refine)
        pad = (-k_tot) % chunk
        rp = jnp.pad(rhs, ((0, 0), (0, 0), (0, pad)))
        parts = jnp.moveaxis(rp.reshape(n, 3, -1, chunk), 2, 0)
        out = jax.lax.map(lambda r: _solve_t_once(r, refine), parts)
        out = jnp.moveaxis(out, 0, 2).reshape(n, 3, -1)
        return out[..., :k_tot]

    b = -g  # [N, 3]
    l = loop_idx.shape[0]
    # batched rhs: [b | U^T] -> [N, 3, 1 + 3L]
    ut = jnp.zeros((n, 3, 3 * l), D.dtype)
    # U row block for loop k occupies rhs columns 3k:3k+3; U^T has wJb^T at
    # node b and wJe^T at node e.
    cols = (3 * jnp.arange(l)[:, None] + jnp.arange(3)[None, :])  # [L, 3]
    ut = ut.at[bidx[:, None, None], jnp.arange(3)[None, :, None],
               cols[:, None, :]].add(jnp.swapaxes(lb, 1, 2))
    ut = ut.at[eidx[:, None, None], jnp.arange(3)[None, :, None],
               cols[:, None, :]].add(jnp.swapaxes(le, 1, 2))
    rhs = jnp.concatenate([b[:, :, None], ut], axis=-1)  # [N, 3, 1+3L]
    sol = solve_t(rhs)  # [N, 3, 1+3L]
    tb = sol[..., 0]  # [N, 3] = T^{-1} b
    tut = sol[..., 1:]  # [N, 3, 3L] = T^{-1} U^T

    def apply_u(x):  # x [N, 3, K] -> U x [3L, K]
        xb = x[bidx]  # [L, 3, K]
        xe = x[eidx]
        y = (jnp.einsum("lri,lik->lrk", lb, xb)
             + jnp.einsum("lri,lik->lrk", le, xe))
        return y.reshape(3 * l, -1)

    def apply_ut(y):  # y [3L] -> U^T y [N, 3]
        yl = y.reshape(l, 3)
        out = jnp.zeros((n, 3), D.dtype)
        out = out.at[bidx].add(jnp.einsum("lri,lr->li", lb, yl))
        out = out.at[eidx].add(jnp.einsum("lri,lr->li", le, yl))
        return out

    import jax.scipy.linalg as jsl

    eye_l = jnp.eye(3 * l, dtype=D.dtype)
    cap = eye_l + apply_u(tut)
    # explicit capacitance inverse: single-column triangular solves (the
    # woodbury() calls below) are latency-bound; one inverse turns them into
    # matvecs
    cap_inv = jsl.cho_solve(jsl.cho_factor(cap + 1e-9 * eye_l), eye_l)

    def woodbury(bv):  # [N,3] -> (T + U^T U)^{-1} bv, reusing tut/cap
        tbv = solve_t(bv[:, :, None], refine=refine_level >= 1)[..., 0]
        z = cap_inv @ apply_u(tbv[:, :, None])[:, 0]
        return tbv - jnp.einsum("nik,k->ni", tut, z)

    def matvec_h(x):  # full damped H x (all edges + damping + gauge)
        xv = jnp.where(gauge_mask[:, None], x, 0.0)
        y = (jnp.einsum("eri,ei->er", wJb, xv[edges.idx[:, 0]])
             + jnp.einsum("eri,ei->er", wJe, xv[edges.idx[:, 1]]))
        out = jnp.zeros_like(xv)
        out = out.at[edges.idx[:, 0]].add(jnp.einsum("eri,er->ei", wJb, y))
        out = out.at[edges.idx[:, 1]].add(jnp.einsum("eri,er->ei", wJe, y))
        out = out + lam_diag * xv
        return jnp.where(gauge_mask[:, None], out, xv)

    x = woodbury(b)
    if refine_level >= 2:
        x = x + woodbury(b - matvec_h(x))  # full-solve refinement
    return jnp.where(gauge_mask[:, None], x, 0.0)


def _lago_initialize(poses, gauge_mask, edges: GraphEdges):
    """Two-stage linear initialization (LAGO-style, Carlone et al.):

    1. orientation: linear LS on angle corrections d (residual
       wrap(th_e - th_b - m) + d_e - d_b), a graph-Laplacian solve;
    2. position: with orientations fixed, p_e - p_b = R(th_b) m_xy is LINEAR
       in positions — a second Laplacian solve with 2 right-hand sides.

    Both Laplacians are assembled as one-hot matmuls and factorized
    densely; the subsequent LM then starts near the basin and converges in a
    handful of iterations instead of tens.  Loop edges participate with
    their (heavily down-scaled, ceresoptimizer.cpp:83-100) weights, so a
    stray outlier cannot dominate the init.
    """
    n = poses.shape[0]
    ub, ue = _incidence(edges, n, poses.dtype)
    d_inc = ue - ub  # [E, N]
    free = gauge_mask.astype(poses.dtype)

    def laplacian_solve(w, rhs_edge):
        """Solve (d_inc^T W d_inc) x = d_inc^T (w * rhs_edge) with gauge."""
        lap = d_inc.T @ (w[:, None] * d_inc)  # [N, N]
        keep = free[:, None] * free[None, :]
        lap = lap * keep + jnp.diag(1.0 - free)
        rhs = d_inc.T @ (w[:, None] * rhs_edge) * free[:, None]
        cl = jax.scipy.linalg.cho_factor(lap + 1e-6 * jnp.eye(n))
        return jax.scipy.linalg.cho_solve(cl, rhs)

    # 1) orientations — per-component information = squared column norms of
    # the whitening S (diag(S^T S); exact for diagonal S, the sensible scalar
    # reduction for measured full-matrix S)
    info_diag = jnp.sum(edges.sqrt_info ** 2, axis=1)  # [E, 3]
    w_th = jnp.where(edges.mask, info_diag[:, 2], 0.0)
    pb = poses[edges.idx[:, 0]]
    pe = poses[edges.idx[:, 1]]
    r_th = se2.wrap_angle(pe[:, 2] - pb[:, 2] - edges.meas[:, 2])
    delta = laplacian_solve(w_th, -r_th[:, None])[:, 0]
    theta = se2.wrap_angle(poses[:, 2] + delta)

    # 2) positions given orientations
    c, s = jnp.cos(theta[edges.idx[:, 0]]), jnp.sin(theta[edges.idx[:, 0]])
    dx = c * edges.meas[:, 0] - s * edges.meas[:, 1]
    dy = s * edges.meas[:, 0] + c * edges.meas[:, 1]
    w_xy = jnp.where(edges.mask,
                     0.5 * (info_diag[:, 0] + info_diag[:, 1]), 0.0)
    # residual (p_e - p_b) - d must also account for the FIXED node-0
    # position entering the rhs: fold p0 contributions in via the current p.
    cur = poses[:, :2]
    rhs = jnp.stack([dx, dy], -1) - (cur[edges.idx[:, 1]] - cur[edges.idx[:, 0]])
    dp = laplacian_solve(w_xy, rhs)
    p = cur + dp

    out = jnp.concatenate([p, theta[:, None]], axis=1)
    return jnp.where(gauge_mask[:, None], out, poses)


def optimize(
    poses: jnp.ndarray,  # [N, 3]
    node_mask: jnp.ndarray,  # [N] bool
    edges: GraphEdges,
    cfg: PGOConfig,
    solver: str = "cholesky",
    loop_cap: Optional[int] = None,
) -> PGOResult:
    """Robust LM over the whole pose graph; first valid pose gauge-fixed.

    Matches CeresLeastSquares::Solve semantics (ceresoptimizer.cpp:44-62):
    trust-region LM with accept/reject, up to cfg.max_iterations outer steps,
    converging on relative cost decrease.

    Solvers: "cholesky" (dense J^T J + Cholesky), "cg" (matrix-free
    block-Jacobi PCG), "schur" (block-tridiagonal chain factorization +
    Woodbury loop correction; needs ``loop_cap`` >= number of non-chain
    edges — the fast path for chain-dominated SLAM graphs).
    """
    if solver == "schur":
        if loop_cap is None:
            raise ValueError("solver='schur' requires loop_cap")
        if not isinstance(edges.mask, jax.core.Tracer):
            # Eager callers get a hard guard: silently truncating loop edges
            # beyond loop_cap would exclude them from the Woodbury correction
            # while they still contribute to cost/gradient (ADVICE r1).
            # numpy on the concrete arrays — jnp ops would re-trace under an
            # outer jit even though the operands are constants.
            import numpy as _np

            m = _np.asarray(edges.mask)
            ii = _np.asarray(edges.idx)
            et = _np.asarray(edges.etype)
            is_chain = (ii[:, 1] == ii[:, 0] + 1) & (et == ODOMETRY) & m
            n_loop = int((m & ~is_chain).sum())
            if n_loop > loop_cap:
                raise ValueError(
                    f"solver='schur': loop_cap={loop_cap} < {n_loop} "
                    "non-chain edges — raise loop_cap (silent truncation "
                    "would yield a wrong solve)")
    return _optimize_jit(poses, node_mask, edges, cfg, solver, loop_cap)


@partial(jax.jit, static_argnames=("cfg", "solver", "loop_cap"))
def _optimize_jit(poses, node_mask, edges, cfg, solver, loop_cap) -> PGOResult:
    n = poses.shape[0]
    gauge_mask = node_mask & (jnp.arange(n) != 0)
    if solver == "schur":
        is_chain_s = ((edges.idx[:, 1] == edges.idx[:, 0] + 1)
                      & (edges.etype == ODOMETRY) & edges.mask)
        is_loop_s = edges.mask & ~is_chain_s
        loop_idx = jnp.argsort(~is_loop_s, stable=True)[:loop_cap]
    # Normal-equation assembly and the solves are precision-critical: the
    # GPU's default TF32 matmuls inject ~1e-3 relative noise into H and g,
    # which caps LM convergence (the gradient floor shows up as dozens of
    # wasted trust-region iterations).  Force full-f32 contraction for
    # everything traced below.
    with jax.default_matmul_precision("highest"):
        return _optimize_impl(poses, node_mask, gauge_mask, edges, cfg,
                              solver,
                              loop_idx if solver == "schur" else None)


def _optimize_impl(poses, node_mask, gauge_mask, edges, cfg, solver,
                   loop_idx) -> PGOResult:
    n = poses.shape[0]

    cost0 = graph_cost(poses, edges, cfg)
    cur0 = cost0
    if cfg.lago_init:
        cand = _lago_initialize(poses, gauge_mask, edges)
        cand_cost = graph_cost(cand, edges, cfg)
        better = cand_cost < cost0
        poses = jnp.where(better, cand, poses)
        cur0 = jnp.where(better, cand_cost, cost0)

    def cond(state):
        _, _, _, _, itr, done, _ = state
        return (itr < cfg.max_iterations) & ~done

    def line_search_pick(p, s, lam):
        """Candidate = p + alpha*s for alpha in step_ladder; alphas are pure
        cost evaluations (no factorization), so exploring the step SCALE is
        ~free compared to the r2 damping ladder's one-solve-per-candidate.
        Full step accepted -> shrink lambda (Gauss-Newton regime); damped
        step -> grow it (trust-region shrink)."""
        alphas = jnp.asarray(cfg.step_ladder, p.dtype)

        def cand_at(a):
            c = p + a * s
            c = c.at[:, 2].set(se2.wrap_angle(c[:, 2]))
            c = jnp.where(gauge_mask[:, None], c, p)
            return c, graph_cost(c, edges, cfg)

        cands, costs = jax.vmap(cand_at)(alphas)
        best = jnp.argmin(costs)
        lam_next = jnp.where(best == 0,
                             jnp.maximum(lam * 0.5, 1e-12),
                             jnp.minimum(lam * 4.0, 1e8))
        return cands[best], costs[best], lam_next

    def body(state):
        p, lam, cur, accepted, itr, _, small_prev = state
        cost, g, blocks = _gradient_and_blocks(p, edges, cfg)
        if solver == "schur":
            wJb, wJe = blocks
            hdiag = jnp.zeros((n, 3), p.dtype)
            hdiag = hdiag.at[edges.idx[:, 0]].add(
                jnp.einsum("eri,eri->ei", wJb, wJb))
            hdiag = hdiag.at[edges.idx[:, 1]].add(
                jnp.einsum("eri,eri->ei", wJe, wJe))
            gm = jnp.where(gauge_mask[:, None], g, 0.0)
            if cfg.line_search:
                s = _schur_solve(n, edges, blocks, gauge_mask,
                                 lam * hdiag, gm, loop_idx,
                                 refine_level=cfg.schur_refine,
                                 seg_cap=cfg.schur_seg)
                cand, new_cost, lam_next = line_search_pick(p, s, lam)
            else:
                # Legacy damping ladder: one structured solve per candidate.
                lams = jnp.stack([m * lam for m in cfg.damping_ladder]) \
                    if cfg.tri_damping else jnp.stack([lam])

                def solve_one(l):
                    s = _schur_solve(n, edges, blocks, gauge_mask,
                                     l * hdiag, gm, loop_idx,
                                     refine_level=cfg.schur_refine,
                                     seg_cap=cfg.schur_seg)
                    c = p + s
                    c = c.at[:, 2].set(se2.wrap_angle(c[:, 2]))
                    c = jnp.where(gauge_mask[:, None], c, p)
                    return c, graph_cost(c, edges, cfg)

                # damping candidates: batched (vmap) when the batched-rhs
                # solve temporaries fit comfortably, sequential (lax.map) on
                # large graphs where 3x peak memory would blow HBM
                small = n * (3 * loop_idx.shape[0] + 1) * 3 * 4 * 3 < 3e8
                if small:
                    cands, costs = jax.vmap(solve_one)(lams)
                else:
                    cands, costs = jax.lax.map(solve_one, lams)
                best = jnp.argmin(costs)
                cand = cands[best]
                new_cost = costs[best]
                lam_next = jnp.maximum(lams[best] * 0.5, 1e-12)
        elif solver == "cholesky":
            H = _dense_hessian(n, edges, blocks, gauge_mask)
            g_flat = jnp.where(jnp.repeat(gauge_mask, 3), g.reshape(-1), 0.0)
            hdiag = jnp.diagonal(H)

            def solve_one(l):
                hl = H + jnp.diag(l * hdiag) + 1e-9 * jnp.eye(3 * n)
                cl = jax.scipy.linalg.cho_factor(hl)
                s = -jax.scipy.linalg.cho_solve(cl, g_flat)
                c = p + s.reshape(n, 3)
                c = c.at[:, 2].set(se2.wrap_angle(c[:, 2]))
                c = jnp.where(gauge_mask[:, None], c, p)
                return c, graph_cost(c, edges, cfg)

            if cfg.line_search:
                hl = H + jnp.diag(lam * hdiag) + 1e-9 * jnp.eye(3 * n)
                cl = jax.scipy.linalg.cho_factor(hl)
                s = -jax.scipy.linalg.cho_solve(cl, g_flat)
                cand, new_cost, lam_next = line_search_pick(
                    p, s.reshape(n, 3), lam)
            else:
                lams = jnp.stack([m * lam for m in cfg.damping_ladder]) \
                    if cfg.tri_damping else jnp.stack([lam])
                cands, costs = jax.vmap(solve_one)(lams)
                best = jnp.argmin(costs)
                cand = cands[best]
                new_cost = costs[best]
                lam_next = jnp.maximum(lams[best] * 0.5, 1e-12)
        else:
            r, Jb, Je = _edge_jacobians(p, edges)
            _, w = _cauchy_weights(r, edges, cfg)
            diag_blocks = _block_diag(n, edges, blocks, gauge_mask)
            gm = jnp.where(gauge_mask[:, None], g, 0.0)
            step = -_pcg_solve(gm, edges, w, Jb, Je, diag_blocks, gauge_mask,
                               lam, cfg.cg_iterations, cfg.cg_tol)
            step = jnp.where(gauge_mask[:, None], step, 0.0)
            cand = p + step
            cand = cand.at[:, 2].set(se2.wrap_angle(cand[:, 2]))
            new_cost = graph_cost(cand, edges, cfg)
            lam_next = jnp.maximum(lam * 0.5, 1e-12)
        accept = new_cost < cur
        # Ceres-style convergence on relative cost change, hardened two ways
        # (ADVICE r1 + r2 plateau finding):
        # - a REJECTED near-no-change candidate only terminates once lambda
        #   has grown past a floor (Ceres applies function_tolerance to
        #   successful steps only);
        # - termination needs TWO consecutive small-decrease iterations —
        #   the robustified (Cauchy-IRLS) cost has plateaus where a single
        #   small accepted step is NOT stationarity (observed: stopping
        #   there left 5x the reachable ATE correction on the table).
        rel_dec = (cur - new_cost) / jnp.maximum(cur, 1e-20)
        small = jnp.abs(rel_dec) < cfg.function_tolerance
        small_now = (accept & small) | (~accept & small & (lam > 1e2))
        done = (small_now & small_prev) | (lam > 1e7)
        p = jnp.where(accept, cand, p)
        lam = jnp.where(accept, lam_next, jnp.minimum(lam * 10.0, 1e8))
        cur = jnp.where(accept, new_cost, cur)
        accepted = accepted + accept.astype(jnp.int32)
        return p, lam, cur, accepted, itr + 1, done, small_now

    state = (poses, jnp.asarray(cfg.init_lambda, poses.dtype), cur0,
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(False), jnp.asarray(False))
    p, _, cost, iters, _, _, _ = jax.lax.while_loop(cond, body, state)
    return PGOResult(poses=p, cost0=cost0, cost=cost, iterations=iters)


def make_edges(idx, meas, sqrt_info, etype, mask) -> GraphEdges:
    """``sqrt_info`` may be per-edge diagonal [E, 3] (identity-scaled path)
    or full whitening matrices [E, 3, 3] (measured-information path); the
    edge store always carries the full form."""
    s = jnp.asarray(sqrt_info, jnp.float32)
    if s.ndim == 2:
        s = jax.vmap(jnp.diag)(s)
    return GraphEdges(
        idx=jnp.asarray(idx, jnp.int32),
        meas=jnp.asarray(meas, jnp.float32),
        sqrt_info=s,
        etype=jnp.asarray(etype, jnp.int32),
        mask=jnp.asarray(mask, bool),
    )
