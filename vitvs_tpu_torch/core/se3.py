"""SE(3) / quaternion utilities (``vitvs_tpu/core/se3.py``), f32 tensors
batched over leading dims.

Quaternions are scalar-last ``[x, y, z, w]``, as scipy's ``Rotation``.
Poses are (position (3,), quaternion (4,)), world-from-body; the camera body
has +x forward (the optical axis).  The optical-frame -> body-frame twist
remap is the reference's ``publish_twist``: body lin = (v[2], -v[0], -v[1]),
body ang = (v[5], -v[3], -v[4]).
"""

from __future__ import annotations

import functools

import torch

R_BODY_FROM_OPTICAL = ((0.0, 0.0, 1.0),
                       (-1.0, 0.0, 0.0),
                       (0.0, -1.0, 0.0))


def body_from_optical(like: torch.Tensor) -> torch.Tensor:
    """R_BODY_FROM_OPTICAL as a (3, 3) tensor of ``like``'s dtype and device
    (made once: a copy to the card each step would wait for the card)."""
    return _body_from_optical(like.dtype, like.device)


@functools.lru_cache(maxsize=16)
def _body_from_optical(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(R_BODY_FROM_OPTICAL, dtype=dtype, device=device)


def optical_twist_to_body(v_c: torch.Tensor) -> torch.Tensor:
    """6-DoF optical-frame velocity (..., 6) -> body-frame twist (no clipping)."""
    r = body_from_optical(v_c)
    return torch.cat([v_c[..., :3] @ r.T, v_c[..., 3:6] @ r.T], dim=-1)


def quat_identity(device="cuda") -> torch.Tensor:
    """The identity rotation [0, 0, 0, 1], f32 on ``device``."""
    return torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=torch.float32, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


# the reference's name for scalar-first [w, x, y, z] quaternions: the same division
quat_normalize_wxyz = quat_normalize


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2 (q2's rotation first, then q1's)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv, w = q[..., :3], q[..., 3:4]
    t = 2.0 * _cross(qv, v)
    return v + w * t + _cross(qv, t)


def quat_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Unit axis (..., 3), angle (...,) radians -> quaternion (..., 4)."""
    half = angle / 2.0
    return torch.cat([axis * torch.sin(half)[..., None], torch.cos(half)[..., None]], dim=-1)


def quat_angle(q: torch.Tensor) -> torch.Tensor:
    """Rotation magnitude in radians (scipy's ``Rotation.magnitude()``)."""
    q = quat_normalize(q)
    return 2.0 * torch.atan2(torch.linalg.vector_norm(q[..., :3], dim=-1), q[..., 3].abs())


def quat_error_angle(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Angle of the relative rotation q1^-1 * q2, radians (the reference's
    ``(current.inv() * desired).magnitude()``)."""
    return quat_angle(quat_multiply(quat_conjugate(quat_normalize(q1)), quat_normalize(q2)))


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (..., 4) xyzw -> rotation matrix (..., 3, 3)."""
    x, y, z, w = quat_normalize(q).unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def quat_from_matrix(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> quaternion (..., 4) xyzw by branch-free
    Shepperd's method: of the four candidate constructions, the one whose
    diagonal term is largest (first on ties)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    # candidates in wxyz order, one per dominant component
    cand = torch.stack([
        torch.stack([1.0 + tr, m21 - m12, m02 - m20, m10 - m01], dim=-1),
        torch.stack([m21 - m12, 1.0 + m00 - m11 - m22, m01 + m10, m02 + m20], dim=-1),
        torch.stack([m02 - m20, m01 + m10, 1.0 - m00 + m11 - m22, m12 + m21], dim=-1),
        torch.stack([m10 - m01, m02 + m20, m12 + m21, 1.0 - m00 - m11 + m22], dim=-1),
    ], dim=-2)
    idx = torch.stack([tr, m00, m11, m22], dim=-1).argmax(-1)
    best = quat_normalize(torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :])
    return torch.cat([best[..., 1:], best[..., :1]], dim=-1)


def integrate_body_twist(position: torch.Tensor, quat: torch.Tensor, twist: torch.Tensor,
                         dt: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Integrate a BODY-frame twist [vx vy vz wx wy wz] over dt: the position
    advances along the linear velocity rotated to the world, the orientation
    right-multiplies the exact rotation of the angular velocity (the Gazebo
    broadcaster's 'base_link' reference frame)."""
    v, w = twist[..., :3], twist[..., 3:6]
    position = position + quat_rotate(quat, v) * dt
    angle = torch.linalg.vector_norm(w, dim=-1)
    axis = w / torch.clamp(angle[..., None], min=1e-12)
    dq = quat_from_axis_angle(axis, angle * dt)
    return position, quat_normalize(quat_multiply(quat, dq))


def look_at_quaternion(camera_position: torch.Tensor, focal_point: torch.Tensor) -> torch.Tensor:
    """Camera orientation with body +x toward ``focal_point`` (the
    reference's ``calculate_look_at_orientation``: world up [-1, 0, 0],
    R = [forward, -right, up] column-stacked)."""
    forward = focal_point - camera_position
    forward = forward / torch.linalg.vector_norm(forward, dim=-1, keepdim=True)
    world_up = torch.tensor([-1.0, 0.0, 0.0], dtype=forward.dtype, device=forward.device)
    right = -_cross(forward, world_up)
    right = right / torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    up = _cross(right, forward)
    return quat_from_matrix(torch.stack([forward, -right, up], dim=-1))


def rotate_about_body_x(quat: torch.Tensor, angle_rad: torch.Tensor) -> torch.Tensor:
    """Post-rotate about the body x (optical) axis: q * R_x(angle); quats
    (..., 4) and angles broadcast (quats (B, 1, 4) and angles (A,) give
    (B, A, 4))."""
    angle_rad = torch.as_tensor(angle_rad, dtype=quat.dtype, device=quat.device)
    axis = torch.tensor([1.0, 0.0, 0.0], dtype=quat.dtype, device=quat.device)
    return quat_multiply(quat, quat_from_axis_angle(axis.expand(angle_rad.shape + (3,)),
                                                    angle_rad))
