"""SE(2) pose algebra on arrays.

The whole radar SLAM problem is planar: scans live in the sensor plane and the
reference optimizes (x, y, theta) per scan (reference:
cfear_radarodometry/src/cfear_radarodometry/utils.cpp:115-127 flattens
Eigen::Affine3d into [x, y, yaw]).  We keep poses as ``[..., 3]`` float arrays
``(x, y, theta)`` everywhere and lift to SE(3) only at export time
(:mod:`tbv_slam_public_tpu.core.se3`).

All functions are shape-polymorphic over leading batch dimensions and are safe
under ``jit``/``vmap``.
"""
from __future__ import annotations

import jax.numpy as jnp


def wrap_angle(theta: jnp.ndarray) -> jnp.ndarray:
    """Wrap angles to (-pi, pi]."""
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def rotmat(theta: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrices ``[..., 2, 2]`` for angles ``[...]``."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    row0 = jnp.stack([c, -s], axis=-1)
    row1 = jnp.stack([s, c], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def identity(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros((3,), dtype=dtype)


def compose(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Pose composition ``a * b`` (apply b, then a). Shapes broadcast."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    t = wrap_angle(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, t], axis=-1)


def inverse(a: jnp.ndarray) -> jnp.ndarray:
    """Pose inverse."""
    c, s = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(c * a[..., 0] + s * a[..., 1])
    y = -(-s * a[..., 0] + c * a[..., 1])
    return jnp.stack([x, y, -a[..., 2]], axis=-1)


def relative(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a^-1 * b``: pose of b expressed in frame a."""
    return compose(inverse(a), b)


def apply(pose: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Transform points ``[..., N, 2]`` by pose ``[..., 3]``."""
    c = jnp.cos(pose[..., 2])[..., None]
    s = jnp.sin(pose[..., 2])[..., None]
    px, py = points[..., 0], points[..., 1]
    x = c * px - s * py + pose[..., 0][..., None]
    y = s * px + c * py + pose[..., 1][..., None]
    return jnp.stack([x, y], axis=-1)


def rotate(pose: jnp.ndarray, vecs: jnp.ndarray) -> jnp.ndarray:
    """Rotate direction vectors ``[..., N, 2]`` by a pose's rotation."""
    c = jnp.cos(pose[..., 2])[..., None]
    s = jnp.sin(pose[..., 2])[..., None]
    vx, vy = vecs[..., 0], vecs[..., 1]
    return jnp.stack([c * vx - s * vy, s * vx + c * vy], axis=-1)


def interpolate(a: jnp.ndarray, b: jnp.ndarray, factor) -> jnp.ndarray:
    """Linear interpolation from a (factor=0) to b (factor=1).

    Matches the reference's slerp+lerp for planar motion
    (odometrykeyframefuser.cpp:98-107): linear in translation, shortest-arc in
    angle.
    """
    dt = wrap_angle(b[..., 2] - a[..., 2])
    x = a[..., 0] + (b[..., 0] - a[..., 0]) * factor
    y = a[..., 1] + (b[..., 1] - a[..., 1]) * factor
    t = wrap_angle(a[..., 2] + dt * factor)
    return jnp.stack([x, y, t], axis=-1)


def scale(pose: jnp.ndarray, factor) -> jnp.ndarray:
    """Scale a relative motion by ``factor`` (translation and angle linearly).

    Equivalent to the reference's getScaledRotationMatrix /
    getScaledTranslationVector pair (utils.cpp:130-150) used for per-point
    motion compensation.
    """
    return jnp.stack(
        [pose[..., 0] * factor, pose[..., 1] * factor, pose[..., 2] * factor],
        axis=-1,
    )


# ---- NumPy host-side variants -------------------------------------------
# For host loops (keyframe bookkeeping, local-map aggregation): the
# inputs are host numpy, and a tiny jnp op per loop step would be a device
# dispatch and transfer each, so host geometry stays host-side.

def relative_np(a, b):
    """NumPy wrap(a^-1 * b) for [3] poses."""
    import numpy as _np

    c, s = _np.cos(a[2]), _np.sin(a[2])
    d = b[:2] - a[:2]
    th = (b[2] - a[2] + _np.pi) % (2 * _np.pi) - _np.pi
    return _np.asarray([c * d[0] + s * d[1], -s * d[0] + c * d[1], th],
                       _np.float32)


def apply_np(pose, points):
    """NumPy pose application to [P, 2] points."""
    import numpy as _np

    c, s = _np.cos(pose[2]), _np.sin(pose[2])
    r = _np.asarray([[c, -s], [s, c]], points.dtype)
    return points @ r.T + _np.asarray(pose[:2], points.dtype)


def compose_np(a, b):
    """NumPy a * b for [3] poses (wrap like ``compose``)."""
    import numpy as _np

    c, s = _np.cos(a[2]), _np.sin(a[2])
    th = (a[2] + b[2] + _np.pi) % (2 * _np.pi) - _np.pi
    return _np.asarray([a[0] + c * b[0] - s * b[1],
                        a[1] + s * b[0] + c * b[1], th], _np.float32)
