"""CorAl neighbour-moment kernel: the Triton-route Pallas kernel in
interpreter mode against the plain XLA form and a float64 brute force, and
the per-platform dispatch."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tbv_slam_public_tpu.ops import coral
from tbv_slam_public_tpu.pallas import coral_moments


def _brute_force(queries, qmask, points, pmask, radius):
    """float64 numpy reference of (count, sum_rel, sum_sq) of p - q."""
    q = queries.astype(np.float64)
    p = points.astype(np.float64)
    rel = p[None, :, :] - q[:, None, :]
    m = ((rel ** 2).sum(-1) <= radius * radius) & pmask[None] & qmask[:, None]
    rel = rel * m[..., None]
    return m.sum(1), rel.sum(1), np.einsum("qpi,qpj->qij", rel, rel)


def _cloud(rng, n, extent, keep=0.8):
    return (rng.uniform(-extent, extent, (n, 2)).astype(np.float32),
            rng.uniform(size=n) < keep)


def _check(got, want, atol_sq=1e-4):
    n, s1, s2 = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(n, want[0])
    np.testing.assert_allclose(s1, want[1], rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(s2, want[2], rtol=1e-5, atol=atol_sq)


# (q, p, extent, radius): the original three shapes, a world-range cloud at
# the Oxford radar's +-165 m (the f32 query-centred argument), and sizes
# that leave a remainder in both the query block and the point tile.
CASES = [
    (50, 70, 30.0, 2.5),
    (128, 512, 30.0, 2.5),
    (200, 600, 30.0, 2.5),
    (96, 160, 165.0, 40.0),
    (coral_moments.BLOCK_Q + 5, 3 * coral_moments.BLOCK_P + 17, 20.0, 3.0),
]


@pytest.mark.parametrize("q,p,extent,radius", CASES)
def test_coral_moments_kernel_matches_reference(rng, q, p, extent, radius):
    queries, qmask = _cloud(rng, q, extent)
    points, pmask = _cloud(rng, p, extent)
    if extent > 100.0:  # world range: shift the cloud to +-165 m
        queries = queries + np.float32(extent - radius)
        points = points + np.float32(extent - radius)
    want = _brute_force(queries, qmask, points, pmask, radius)
    args = (jnp.asarray(queries), jnp.asarray(qmask), jnp.asarray(points),
            jnp.asarray(pmask), radius)
    _check(coral_moments.neighbor_moments(*args, interpret=True), want)
    _check(coral._neighbor_moments(*args), want)


@pytest.mark.parametrize("q,p,extent,radius", CASES[:3])
def test_coral_moments_vmapped_kernel(rng, q, p, extent, radius):
    """The loop wave vmaps CorAl over pairs: the batched kernel must agree
    pair by pair."""
    clouds = [(_cloud(rng, q, extent), _cloud(rng, p, extent))
              for _ in range(3)]
    qs = jnp.asarray(np.stack([c[0][0] for c in clouds]))
    qm = jnp.asarray(np.stack([c[0][1] for c in clouds]))
    ps = jnp.asarray(np.stack([c[1][0] for c in clouds]))
    pm = jnp.asarray(np.stack([c[1][1] for c in clouds]))
    got = jax.vmap(lambda a, b, c, d: coral_moments.neighbor_moments(
        a, b, c, d, radius, interpret=True))(qs, qm, ps, pm)
    for i, ((qq, qk), (pp, pk)) in enumerate(clouds):
        _check([g[i] for g in got], _brute_force(qq, qk, pp, pk, radius))


def test_coral_moments_empty_masks(rng):
    q, p = 64, 128
    queries = rng.uniform(-5, 5, (q, 2)).astype(np.float32)
    points = rng.uniform(-5, 5, (p, 2)).astype(np.float32)
    n, s1, s2 = coral_moments.neighbor_moments(
        jnp.asarray(queries), jnp.zeros(q, bool), jnp.asarray(points),
        jnp.zeros(p, bool), 1.0, interpret=True)
    assert float(jnp.sum(n)) == 0.0
    assert float(jnp.sum(jnp.abs(s1))) == 0.0
    assert float(jnp.sum(jnp.abs(s2))) == 0.0


def _coral_hlo(platform):
    xy = jnp.zeros((64, 2), jnp.float32)
    m = jnp.ones((64,), bool)
    traced = jax.jit(coral._moments_dispatch).trace(xy, m, xy, m, 1.0)
    return traced.lower(lowering_platforms=(platform,)).as_text()


def test_dispatch_cpu_lowers_plain_form():
    assert "triton" not in _coral_hlo("cpu")


def test_dispatch_cuda_lowers_triton_kernel():
    """Lowered for a CUDA GPU the moments are the Triton kernel -- never
    the interpreter (which would lower to plain HLO loops) and never the
    plain form."""
    hlo = _coral_hlo("cuda")
    assert "__gpu$xla.gpu.triton" in hlo
    assert "coral_neighbor_moments" in hlo
