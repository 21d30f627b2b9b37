"""Scalar NumPy oracle of the reference vors tracker — TEST CODE ONLY.

A deliberately slow, per-pixel/per-candidate transliteration of the reference
Rust pipeline (``/root/reference``), kept in f32 discipline so it reproduces
the reference's arithmetic as closely as NumPy allows.  It exists purely as an
executable *oracle*: ``tests/test_oracle.py`` asserts that the production JAX
implementation (fixed-shape masked arrays, fused matmul reductions,
``lax.while_loop`` LM) is numerically equivalent to this faithful scalar
rendition of the reference semantics.

This is the same pattern as the ``prune_with_thresh`` scalar port in
``tests/test_candidates.py`` — a deliberate, labeled test oracle — extended to
the full tracking stack:

- ``eval_energy`` / ``compute_eval_data``  (ref lm_optimizer.rs:68-107)
- LM ``step`` / ``eval`` / ``stop_criterion`` + the ``iterative_solve`` driver
  (ref lm_optimizer.rs:111-193, optimizer.rs:57-70)
- ``precompute_multires_data`` incl. candidate selection, inverse-depth
  pyramid and Jacobian precompute (ref inverse_compositional.rs:105-161)
- the full per-frame ``Tracker::track`` loop with optical-flow keyframe
  switching (ref inverse_compositional.rs:170-240)
- the supporting math: se3/so3 exp/log (se3.rs, so3.rs), pinhole intrinsics
  with the +0.5/-0.5 half-res shift (camera.rs:115-140), integer mean
  pyramids and block gradients (multires.rs, gradient.rs), inverse-depth
  fusion (inverse_depth.rs).

f32 discipline: every arithmetic op is done on ``np.float32`` scalars/arrays
(NumPy keeps f32 for f32-op-python-float), and *accumulations* (energy,
gradient, hessian, optical flow) run as sequential Python loops in the
reference's candidate order, reproducing Rust's left-to-right f32 summation.
Per-candidate elementwise math is vectorized over the candidate axis — IEEE
elementwise ops are identical lane-by-lane, so this changes nothing.

One deliberate deviation: the reference's candidate pruning uses
``sort_unstable`` whose order on *equal* gradient values is unspecified
(coarse_to_fine.rs:79).  The oracle fixes the same deterministic tie-break as
the production code (first corner in a-b-c-d order wins among equals) so that
composed end-to-end comparisons are meaningful; both are valid readings of the
reference.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np

F = np.float32

EPSILON_TAYLOR_SERIES = F(1e-2)
EPSILON_TAYLOR_SERIES_2 = F(EPSILON_TAYLOR_SERIES * EPSILON_TAYLOR_SERIES)


# ---------------------------------------------------------------------------
# Quaternions and Iso3 (nalgebra semantics; quaternion stored [w, x, y, z])
# ---------------------------------------------------------------------------


class Iso3(NamedTuple):
    """nalgebra ``Isometry3<f32>``: unit quaternion [w,x,y,z] + translation."""

    q: np.ndarray  # (4,) f32
    t: np.ndarray  # (3,) f32


def iso_identity() -> Iso3:
    return Iso3(np.array([1, 0, 0, 0], F), np.zeros(3, F))


def quat_mul(q1: np.ndarray, q2: np.ndarray) -> np.ndarray:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        F,
    )


def quat_rotate(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """nalgebra ``UnitQuaternion::transform_vector``: t = 2 u x v;
    v' = v + w t + u x t.  Vectorized over a leading candidate axis."""
    u = q[1:].astype(F)
    w = q[0]
    tv = F(2.0) * np.cross(u, v).astype(F)
    return (v + w * tv + np.cross(u, tv).astype(F)).astype(F)


def iso_mul(a: Iso3, b: Iso3) -> Iso3:
    """nalgebra ``Iso3 * Iso3``: compose (b first)."""
    return Iso3(quat_mul(a.q, b.q), (a.t + quat_rotate(a.q, b.t)).astype(F))


def iso_inverse(a: Iso3) -> Iso3:
    qi = (a.q * np.array([1, -1, -1, -1], F)).astype(F)
    return Iso3(qi, (-quat_rotate(qi, a.t)).astype(F))


def iso_apply(a: Iso3, p: np.ndarray) -> np.ndarray:
    """``iso * point``: R p + t (vectorized over leading axis)."""
    return (quat_rotate(a.q, p) + a.t).astype(F)


# ---------------------------------------------------------------------------
# so3 (ref src/math/so3.rs)
# ---------------------------------------------------------------------------


def so3_hat(w: np.ndarray) -> np.ndarray:
    """so3.rs:27-33."""
    x, y, z = w
    return np.array([[0, -z, y], [z, 0, -x], [-y, x, 0]], F)


def so3_hat_2(w: np.ndarray) -> np.ndarray:
    """so3.rs:38-50."""
    x, y, z = w
    w11, w12, w13 = x * x, x * y, x * z
    w22, w23, w33 = y * y, y * z, z * z
    return np.array(
        [
            [-w22 - w33, w12, w13],
            [w12, -w11 - w33, w23],
            [w13, w23, -w11 - w22],
        ],
        F,
    )


def _unit_quat_from_parts(real: F, imag: np.ndarray) -> np.ndarray:
    """nalgebra ``UnitQuaternion::from_quaternion`` renormalizes."""
    q = np.array([real, imag[0], imag[1], imag[2]], F)
    n = F(np.sqrt(F(np.dot(q, q))))
    return (q / n).astype(F)


def so3_exp(w: np.ndarray) -> np.ndarray:
    """so3.rs:61-77 → quaternion [w,x,y,z]."""
    w = np.asarray(w, F)
    theta_2 = F(w[0] * w[0] + w[1] * w[1] + w[2] * w[2])
    if theta_2 < EPSILON_TAYLOR_SERIES_2:
        real = F(1.0) - F(0.125) * theta_2
        imag = F(0.5) - F(1.0 / 48.0) * theta_2
    else:
        theta = F(np.sqrt(theta_2))
        half = F(0.5) * theta
        real = F(np.cos(half))
        imag = F(np.sin(half)) / theta
    return _unit_quat_from_parts(real, (imag * w).astype(F))


def so3_log(q: np.ndarray) -> np.ndarray:
    """so3.rs:81-99 → axis-angle vector."""
    imag = q[1:].astype(F)
    imag_norm_2 = F(np.dot(imag, imag))
    real = F(q[0])
    if imag_norm_2 < EPSILON_TAYLOR_SERIES_2:
        return ((F(2.0) / real) * imag).astype(F)
    if abs(real) < EPSILON_TAYLOR_SERIES:
        imag_norm = F(np.sqrt(imag_norm_2))
        alpha = F(abs(real)) / imag_norm
        theta = F(np.sign(real)) * (F(np.pi) - F(2.0) * alpha)
        return ((theta / imag_norm) * imag).astype(F)
    imag_norm = F(np.sqrt(imag_norm_2))
    theta = F(2.0) * F(np.arctan(imag_norm / real))
    return ((theta / imag_norm) * imag).astype(F)


# ---------------------------------------------------------------------------
# se3 (ref src/math/se3.rs)
# ---------------------------------------------------------------------------


def se3_exp(xi: np.ndarray) -> Iso3:
    """se3.rs:65-95."""
    xi = np.asarray(xi, F)
    xi_v = xi[:3]
    xi_w = xi[3:]
    theta_2 = F(np.dot(xi_w, xi_w))
    omega = so3_hat(xi_w)
    omega_2 = so3_hat_2(xi_w)
    if theta_2 < EPSILON_TAYLOR_SERIES_2:
        real = F(1.0) - F(0.125) * theta_2
        imag = F(0.5) - F(1.0 / 48.0) * theta_2
        c_omega = F(0.5) - F(1.0 / 24.0) * theta_2
        c_omega_2 = F(1.0 / 6.0) - F(1.0 / 120.0) * theta_2
    else:
        theta = F(np.sqrt(theta_2))
        half = F(0.5) * theta
        real = F(np.cos(half))
        imag = F(np.sin(half)) / theta
        c_omega = (F(1.0) - F(np.cos(theta))) / theta_2
        c_omega_2 = (theta - F(np.sin(theta))) / (theta * theta_2)
    v = (np.eye(3, dtype=F) + c_omega * omega + c_omega_2 * omega_2).astype(F)
    rotation = _unit_quat_from_parts(real, (imag * xi_w).astype(F))
    return Iso3(rotation, (v @ xi_v).astype(F))


def se3_log(iso: Iso3) -> np.ndarray:
    """se3.rs:99-129."""
    imag = iso.q[1:].astype(F)
    imag_norm_2 = F(np.dot(imag, imag))
    real = F(iso.q[0])
    if imag_norm_2 < EPSILON_TAYLOR_SERIES_2:
        scale = F(2.0) / real
        w = (scale * imag).astype(F)
        omega, omega_2 = so3_hat(w), so3_hat_2(w)
        x_2 = imag_norm_2 / (real * real)
        c_omega_2 = F(1.0 / 12.0) * (F(1.0) + F(1.0 / 15.0) * x_2)
    else:
        imag_norm = F(np.sqrt(imag_norm_2))
        if abs(real) < EPSILON_TAYLOR_SERIES:
            alpha = F(abs(real)) / imag_norm
            theta = F(np.sign(real)) * (F(np.pi) - F(2.0) * alpha)
        else:
            theta = F(2.0) * F(np.arctan(imag_norm / real))
        theta_2 = theta * theta
        w = ((theta / imag_norm) * imag).astype(F)
        omega, omega_2 = so3_hat(w), so3_hat_2(w)
        c_omega_2 = (F(1.0) - F(0.5) * theta * real / imag_norm) / theta_2
    v_inv = (np.eye(3, dtype=F) - F(0.5) * omega + c_omega_2 * omega_2).astype(F)
    xi_v = (v_inv @ iso.t.astype(F)).astype(F)
    return np.concatenate([xi_v, w]).astype(F)


# ---------------------------------------------------------------------------
# Camera intrinsics (ref src/core/camera.rs)
# ---------------------------------------------------------------------------


class Intrinsics(NamedTuple):
    cx: F
    cy: F
    fx: F
    fy: F
    skew: F


def half_res(k: Intrinsics) -> Intrinsics:
    """camera.rs:115-123 (+0.5/-0.5 principal-point shift)."""
    return Intrinsics(
        cx=F((k.cx + F(0.5)) / F(2.0) - F(0.5)),
        cy=F((k.cy + F(0.5)) / F(2.0) - F(0.5)),
        fx=F(F(0.5) * k.fx),
        fy=F(F(0.5) * k.fy),
        skew=k.skew,
    )


def multi_res(k: Intrinsics, n: int) -> List[Intrinsics]:
    """camera.rs:106-108."""
    out = [k]
    for _ in range(1, n):
        out.append(half_res(out[-1]))
    return out


def project(k: Intrinsics, p: np.ndarray) -> np.ndarray:
    """camera.rs:126-132 (vectorized over leading axis)."""
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    return np.stack(
        [k.fx * x + k.skew * y + k.cx * z, k.fy * y + k.cy * z, z], axis=-1
    ).astype(F)


def back_project(k: Intrinsics, p2: np.ndarray, depth) -> np.ndarray:
    """camera.rs:135-140 (vectorized over leading axis)."""
    z = np.asarray(depth, F)
    y = ((p2[..., 1] - k.cy) * z / k.fy).astype(F)
    x = (((p2[..., 0] - k.cx) * z - k.skew * y) / k.fx).astype(F)
    return np.stack([x, y, np.broadcast_to(z, x.shape)], axis=-1).astype(F)


# ---------------------------------------------------------------------------
# Multires + gradients (ref src/core/multires.rs, src/core/gradient.rs)
# ---------------------------------------------------------------------------


def _blocks(mat: np.ndarray):
    """2x2 block corners a=(2i,2j) b=(2i+1,2j) c=(2i,2j+1) d=(2i+1,2j+1),
    dropping odd trailing row/col (multires.rs:67-88)."""
    h2, w2 = mat.shape[0] // 2, mat.shape[1] // 2
    m = mat[: 2 * h2, : 2 * w2]
    return m[0::2, 0::2], m[1::2, 0::2], m[0::2, 1::2], m[1::2, 1::2]


def mean_pyramid(max_levels: int, mat: np.ndarray) -> List[np.ndarray]:
    """multires.rs:21-31: u8 mean with truncating u16 division."""
    pyr = [mat.astype(np.uint8)]
    while len(pyr) < max_levels:
        m = pyr[-1]
        if m.shape[0] // 2 == 0 or m.shape[1] // 2 == 0:
            break
        a, b, c, d = _blocks(m.astype(np.uint16))
        pyr.append(((a + b + c + d) // 4).astype(np.uint8))
    return pyr


def centered_gradient(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """gradient.rs:15-33: centered /2 truncating toward zero, zero borders."""
    h, w = img.shape
    gx = np.zeros((h, w), np.int16)
    gy = np.zeros((h, w), np.int16)
    im = img.astype(np.int16)
    dx = im[1:-1, 2:] - im[1:-1, :-2]
    dy = im[2:, 1:-1] - im[:-2, 1:-1]
    # Rust / is trunc-toward-zero; numpy // floors, so emulate.
    gx[1:-1, 1:-1] = (np.sign(dx) * (np.abs(dx) // 2)).astype(np.int16)
    gy[1:-1, 1:-1] = (np.sign(dy) * (np.abs(dy) // 2)).astype(np.int16)
    return gx, gy


def _trunc_div(x: np.ndarray, d: int) -> np.ndarray:
    return np.sign(x) * (np.abs(x) // d)


def bloc_gradients(img: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """gradient.rs:74-93 via halve (multires.rs:112-126)."""
    a, b, c, d = _blocks(img.astype(np.int16))
    gx = _trunc_div(c + d - a - b, 2).astype(np.int16)
    gy = _trunc_div(b - a + d - c, 2).astype(np.int16)
    return gx, gy


def gradients_xy(pyr: List[np.ndarray]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """multires.rs:112-126: one fewer level than images."""
    return [bloc_gradients(m) for m in pyr[:-1]]


def squared_norm(gx: np.ndarray, gy: np.ndarray) -> np.ndarray:
    """gradient.rs:38-44."""
    g = gx.astype(np.int32) ** 2 + gy.astype(np.int32) ** 2
    return g.astype(np.uint16)


# ---------------------------------------------------------------------------
# Coarse-to-fine candidate selection (ref src/core/candidates/coarse_to_fine.rs)
# ---------------------------------------------------------------------------


def prune_with_thresh(thresh: int, vals: List[int]) -> List[bool]:
    """coarse_to_fine.rs:73-89 with the production tie-break (first corner in
    a-b-c-d order wins among equal values; the reference's unstable sort
    leaves tie order unspecified)."""
    order = sorted(range(4), key=lambda i: (vals[i], -i), reverse=True)
    keep = [False] * 4
    keep[order[0]] = True
    if vals[order[1]] > vals[order[2]] + thresh:
        keep[order[1]] = True
    return keep


def candidates_select(diff_threshold: int, gradients: List[np.ndarray]) -> List[np.ndarray]:
    """coarse_to_fine.rs:15-62: all-true coarsest, per-2x2-block pruning."""
    nrows, ncols = gradients[-1].shape
    masks = [np.ones((nrows, ncols), bool)]
    for grad in reversed(gradients[:-1]):
        pre = masks[-1]
        h, w = grad.shape
        mask = np.zeros((h, w), bool)
        for i in range(h // 2):
            for j in range(w // 2):
                if pre[i, j]:
                    block = [
                        int(grad[2 * i, 2 * j]),
                        int(grad[2 * i + 1, 2 * j]),
                        int(grad[2 * i, 2 * j + 1]),
                        int(grad[2 * i + 1, 2 * j + 1]),
                    ]
                    ok = prune_with_thresh(int(diff_threshold), block)
                    mask[2 * i, 2 * j] = ok[0]
                    mask[2 * i + 1, 2 * j] = ok[1]
                    mask[2 * i, 2 * j + 1] = ok[2]
                    mask[2 * i + 1, 2 * j + 1] = ok[3]
        masks.append(mask)
    return masks


# ---------------------------------------------------------------------------
# Inverse depth (ref src/core/inverse_depth.rs)
# ---------------------------------------------------------------------------

# InverseDepth enum encoded as (tag, idepth, variance); tags:
UNKNOWN, DISCARDED, WITH_VARIANCE = 0, 1, 2


def from_depth(scale: F, depth: int, variance: F):
    """inverse_depth.rs:24-29."""
    if depth == 0:
        return (UNKNOWN, F(0), F(0))
    return (WITH_VARIANCE, F(scale / F(depth)), F(variance))


def strategy_dso_mean(valid: List[Tuple[F, F]]):
    """inverse_depth.rs:81-98: sequential f32 weighted mean, weights add."""
    k = len(valid)
    if k == 0 or k > 4:
        return (UNKNOWN, F(0), F(0))
    if k == 1:
        return (WITH_VARIANCE, valid[0][0], valid[0][1])
    s = valid[0][1]
    for _, v in valid[1:]:
        s = F(s + v)
    num = F(valid[0][0] * valid[0][1])
    for d, v in valid[1:]:
        num = F(num + F(d * v))
    return (WITH_VARIANCE, F(num / s), s)


def strategy_statistically_similar(valid: List[Tuple[F, F]]):
    """inverse_depth.rs:105-152."""
    k = len(valid)
    if k == 0 or k > 4:
        return (UNKNOWN, F(0), F(0))
    if k == 1:
        d1, v1 = valid[0]
        return (WITH_VARIANCE, d1, F(2.0) * v1)
    if k == 2:
        (d1, v1), (d2, v2) = valid
        new_d = F((d1 * v2 + d2 * v1) / (v1 + v2))
        new_v = F((v1 + v2) / F(2.0))
        if (d1 - new_d) ** 2 < new_v and (d2 - new_d) ** 2 < new_v:
            return (WITH_VARIANCE, new_d, new_v)
        return (DISCARDED, F(0), F(0))
    if k == 3:
        (d1, v1), (d2, v2), (d3, v3) = valid
        v12, v13, v23 = F(v1 * v2), F(v1 * v3), F(v2 * v3)
        new_d = F((d1 * v23 + d2 * v13 + d3 * v12) / (v12 + v13 + v23))
        new_v = F(F(2.0) * (v1 + v2 + v3) / F(9.0))
        if all((d - new_d) ** 2 < new_v for d in (d1, d2, d3)):
            return (WITH_VARIANCE, new_d, new_v)
        return (DISCARDED, F(0), F(0))
    (d1, v1), (d2, v2), (d3, v3), (d4, v4) = valid
    v123, v234 = F(v1 * v2 * v3), F(v2 * v3 * v4)
    v341, v412 = F(v3 * v4 * v1), F(v4 * v1 * v2)
    sum_v = F(v123 + v234 + v341 + v412)
    new_d = F((d1 * v234 + d2 * v341 + d3 * v412 + d4 * v123) / sum_v)
    new_v = F((v1 + v2 + v3 + v4) / F(8.0))
    if all((d - new_d) ** 2 < new_v for d in (d1, d2, d3, d4)):
        return (WITH_VARIANCE, new_d, new_v)
    return (DISCARDED, F(0), F(0))


def fuse(a, b, c, d, strategy):
    """inverse_depth.rs:49-66: filter known, pass to strategy in order."""
    valid = [(x[1], x[2]) for x in (a, b, c, d) if x[0] == WITH_VARIANCE]
    return strategy(valid)


def halve_idepth(mat: List[List[tuple]], strategy) -> Optional[List[List[tuple]]]:
    h, w = len(mat), len(mat[0])
    h2, w2 = h // 2, w // 2
    if h2 == 0 or w2 == 0:
        return None
    out = []
    for i in range(h2):
        row = []
        for j in range(w2):
            row.append(
                fuse(
                    mat[2 * i][2 * j],
                    mat[2 * i + 1][2 * j],
                    mat[2 * i][2 * j + 1],
                    mat[2 * i + 1][2 * j + 1],
                    strategy,
                )
            )
        out.append(row)
    return out


# ---------------------------------------------------------------------------
# Tracker precompute (ref src/core/track/inverse_compositional.rs:105-161)
# ---------------------------------------------------------------------------


class Config(NamedTuple):
    """inverse_compositional.rs:37-49."""

    nb_levels: int
    candidates_diff_threshold: int
    depth_scale: F
    intrinsics: Intrinsics
    idepth_variance: F


class MultiresData(NamedTuple):
    """inverse_compositional.rs:64-70."""

    intrinsics_multires: List[Intrinsics]
    img_multires: List[np.ndarray]
    usable_candidates_multires: List[Tuple[List[Tuple[int, int]], List[F]]]
    jacobians_multires: List[np.ndarray]  # per level (N, 6) f32
    hessians_multires: List[np.ndarray]  # per level (N, 6, 6) f32


def extract_z(idepth_mat: List[List[tuple]]) -> Tuple[List[Tuple[int, int]], List[F]]:
    """inverse_compositional.rs:260-279: COLUMN-MAJOR iteration, coords are
    (u, v) = (col, row)."""
    nb_rows = len(idepth_mat)
    nb_cols = len(idepth_mat[0])
    coordinates = []
    zs = []
    for u in range(nb_cols):
        for v in range(nb_rows):
            tag, z, _var = idepth_mat[v][u]
            if tag == WITH_VARIANCE:
                coordinates.append((u, v))
                zs.append(z)
    return coordinates, zs


def warp_jacobian_at(gu, gv, u, v, z, k: Intrinsics) -> np.ndarray:
    """inverse_compositional.rs:313-341 (vectorized over leading axis)."""
    cu, cv, fu, fv, s = k.cx, k.cy, k.fx, k.fy, k.skew
    a = (u - cu).astype(F)
    b = (v - cv).astype(F)
    c = (a * fv - s * b).astype(F)
    _fv = F(1.0) / fv
    _fuv = F(1.0) / F(fu * fv)
    return np.stack(
        [
            gu * z * fu,
            z * (gu * s + gv * fv),
            -z * (gu * a + gv * b),
            gu * (-a * b * _fv - s) + gv * (-b * b * _fv - fv),
            gu * (a * c * _fuv + fu) + gv * (b * c * _fuv),
            gu * (-fu * fu * b + s * c) * _fuv + gv * (c / fu),
        ],
        axis=-1,
    ).astype(F)


def precompute_multires_data(
    config: Config,
    depth_map: np.ndarray,
    intrinsics_multires: List[Intrinsics],
    img_multires: List[np.ndarray],
) -> MultiresData:
    """inverse_compositional.rs:105-161."""
    gradients_multires = gradients_xy(img_multires)
    gradients_multires.insert(0, centered_gradient(img_multires[0]))
    gsn = [squared_norm(gx, gy) for gx, gy in gradients_multires]

    candidates_mask = candidates_select(config.candidates_diff_threshold, gsn)[-1]

    # idepth at finest level: masked from_depth (inverse_compositional.rs:127-134)
    h, w = depth_map.shape
    id0 = [
        [
            from_depth(config.depth_scale, int(depth_map[i, j]), config.idepth_variance)
            if candidates_mask[i, j]
            else (UNKNOWN, F(0), F(0))
            for j in range(w)
        ]
        for i in range(h)
    ]
    idepth_multires = [id0]
    while len(idepth_multires) < config.nb_levels:
        nxt = halve_idepth(idepth_multires[-1], strategy_dso_mean)
        if nxt is None:
            break
        idepth_multires.append(nxt)

    usable = [extract_z(m) for m in idepth_multires]

    jacobians_multires = []
    hessians_multires = []
    for k, (coords, zs), (gx, gy) in zip(intrinsics_multires, usable, gradients_multires):
        if coords:
            us = np.array([c[0] for c in coords], F)
            vs = np.array([c[1] for c in coords], F)
            gus = np.array([F(gx[c[1], c[0]]) for c in coords], F)
            gvs = np.array([F(gy[c[1], c[0]]) for c in coords], F)
            zs_arr = np.array(zs, F)
            jacs = warp_jacobian_at(gus, gvs, us, vs, zs_arr, k)
        else:
            jacs = np.zeros((0, 6), F)
        hess = np.einsum("ni,nj->nij", jacs, jacs).astype(F)
        jacobians_multires.append(jacs)
        hessians_multires.append(hess)

    return MultiresData(
        intrinsics_multires=intrinsics_multires,
        img_multires=img_multires,
        usable_candidates_multires=usable,
        jacobians_multires=jacobians_multires,
        hessians_multires=hessians_multires,
    )


# ---------------------------------------------------------------------------
# LM optimizer (ref src/core/track/lm_optimizer.rs)
# ---------------------------------------------------------------------------


class Obs(NamedTuple):
    """lm_optimizer.rs:43-58."""

    intrinsics: Intrinsics
    template: np.ndarray  # (H, W) u8
    image: np.ndarray  # (H, W) u8
    coordinates: List[Tuple[int, int]]
    zs: List[F]
    jacobians: np.ndarray  # (N, 6)
    hessians: np.ndarray  # (N, 6, 6)


class EvalData(NamedTuple):
    """lm_optimizer.rs:31-40."""

    hessian: np.ndarray  # (6, 6)
    gradient: np.ndarray  # (6,)
    energy: F
    model: Iso3


def warp(model: Iso3, x, y, z, k: Intrinsics):
    """lm_optimizer.rs:213-219 (vectorized over leading axis)."""
    p2 = np.stack([np.asarray(x, F), np.asarray(y, F)], axis=-1)
    x1 = back_project(k, p2, (F(1.0) / np.asarray(z, F)).astype(F))
    x2 = iso_apply(model, x1)
    uvz = project(k, x2)
    return (uvz[..., 0] / uvz[..., 2]).astype(F), (uvz[..., 1] / uvz[..., 2]).astype(F)


def interpolate_vec(x: np.ndarray, y: np.ndarray, image: np.ndarray):
    """lm_optimizer.rs:227-251 (vectorized): returns (values, inside)."""
    height, width = image.shape
    u = np.floor(x).astype(F)
    v = np.floor(y).astype(F)
    inside = (u >= 0.0) & (u < F(width - 2)) & (v >= 0.0) & (v < F(height - 2))
    u0 = np.clip(u.astype(np.int64), 0, width - 2)
    v0 = np.clip(v.astype(np.int64), 0, height - 2)
    imf = image.astype(F)
    vu00 = imf[v0, u0]
    vu10 = imf[v0 + 1, u0]
    vu01 = imf[v0, u0 + 1]
    vu11 = imf[v0 + 1, u0 + 1]
    a = (x - u).astype(F)
    b = (y - v).astype(F)
    one = F(1.0)
    vals = (
        (one - b) * (one - a) * vu00
        + b * (one - a) * vu10
        + (one - b) * a * vu01
        + b * a * vu11
    ).astype(F)
    return vals, inside


def eval_energy(obs: Obs, model: Iso3):
    """lm_optimizer.rs:68-87: per-candidate warp + interp; sequential f32
    energy accumulation over inside points in candidate order."""
    if len(obs.coordinates) == 0:
        return F(np.nan), [], []
    xs = np.array([c[0] for c in obs.coordinates], F)
    ys = np.array([c[1] for c in obs.coordinates], F)
    zs = np.array(obs.zs, F)
    u, v = warp(model, xs, ys, zs, obs.intrinsics)
    vals, inside = interpolate_vec(u, v, obs.image)
    tmpl = np.array(
        [F(obs.template[c[1], c[0]]) for c in obs.coordinates], F
    )
    residuals = []
    inside_indices = []
    energy_sum = F(0.0)
    for idx in range(len(obs.coordinates)):
        if inside[idx]:
            r = F(vals[idx] - tmpl[idx])
            energy_sum = F(energy_sum + F(r * r))
            residuals.append(r)
            inside_indices.append(idx)
    energy = F(energy_sum / F(len(residuals))) if residuals else F(np.nan)
    return energy, inside_indices, residuals


def compute_eval_data(obs: Obs, model: Iso3, pre) -> EvalData:
    """lm_optimizer.rs:90-107: sequential f32 gradient/hessian accumulation."""
    energy, inside_indices, residuals = pre
    gradient = np.zeros(6, F)
    hessian = np.zeros((6, 6), F)
    for i, idx in enumerate(inside_indices):
        gradient = (gradient + obs.jacobians[idx] * residuals[i]).astype(F)
        hessian = (hessian + obs.hessians[idx]).astype(F)
    return EvalData(hessian=hessian, gradient=gradient, energy=energy, model=model)


def renormalize(iso: Iso3) -> Iso3:
    """lm_optimizer.rs:198-209: first-order quaternion renormalization."""
    q = iso.q
    sq_norm = F(np.dot(q, q))
    return Iso3((F(0.5) * F(3.0 - sq_norm) * q).astype(F), iso.t)


class CholeskyError(Exception):
    pass


def lm_step(eval_data: EvalData, lm_coef: F) -> Iso3:
    """lm_optimizer.rs:123-136: diagonal Marquardt scaling, 6x6 Cholesky,
    inverse-compositional update model * exp(delta)^-1, renormalize."""
    hessian = eval_data.hessian.copy()
    for i in range(6):
        hessian[i, i] = F(hessian[i, i] * F(1.0 + lm_coef))
    try:
        chol = np.linalg.cholesky(hessian.astype(F))
    except np.linalg.LinAlgError as e:
        raise CholeskyError(str(e)) from e
    # forward/back substitution in f32 (nalgebra Cholesky::solve)
    from scipy.linalg import solve_triangular

    ysol = solve_triangular(
        chol.astype(F), eval_data.gradient.astype(F), lower=True
    ).astype(F)
    delta = solve_triangular(chol.T.astype(F), ysol, lower=False).astype(F)
    delta_warp = se3_exp(delta)
    return renormalize(iso_mul(eval_data.model, iso_inverse(delta_warp)))


def iterative_solve_lm(obs: Obs, initial_model: Iso3):
    """optimizer.rs:57-70 driving lm_optimizer.rs:111-193.

    Returns (eval_data, nb_iter).  Raises CholeskyError on step failure like
    the reference's Err propagation.
    """
    lm_coef = F(0.1)
    eval_data = compute_eval_data(obs, initial_model, eval_energy(obs, initial_model))
    nb_iter = 0
    while True:
        nb_iter += 1
        new_model = lm_step(eval_data, lm_coef)
        pre = eval_energy(obs, new_model)
        energy = pre[0]
        old_energy = eval_data.energy
        # Rust: if energy > old_energy  (NaN > x is false → accepted)
        rejected = energy > old_energy
        too_many = nb_iter > 20
        if rejected:
            if too_many:
                return eval_data, nb_iter
            lm_coef = F(lm_coef * F(10.0))
            continue
        new_eval = compute_eval_data(obs, new_model, pre)
        if too_many:
            return new_eval, nb_iter
        d_energy = F(old_energy - new_eval.energy)
        lm_coef = F(F(0.1) * lm_coef)
        eval_data = new_eval
        if not (d_energy > F(1.0)):
            return eval_data, nb_iter


# ---------------------------------------------------------------------------
# Full tracker (ref src/core/track/inverse_compositional.rs:72-249)
# ---------------------------------------------------------------------------


class Tracker:
    """Scalar oracle of the reference Tracker (4-call API)."""

    def __init__(self, config: Config, depth_time: float, depth_map: np.ndarray,
                 img_time: float, img: np.ndarray):
        """Config::init (inverse_compositional.rs:74-100)."""
        self.config = config
        intr = multi_res(config.intrinsics, config.nb_levels)
        img_multires = mean_pyramid(config.nb_levels, img)
        self.keyframe_data = precompute_multires_data(
            config, depth_map, intr, img_multires
        )
        self.keyframe_depth_timestamp = depth_time
        self.keyframe_img_timestamp = img_time
        self.keyframe_pose = iso_identity()
        self.current_depth_timestamp = depth_time
        self.current_img_timestamp = img_time
        self.current_pose = iso_identity()
        self.last_flow = 0.0
        self.keyframe_switches = 0
        self.last_changed_keyframe = False

    def track(self, depth_time: float, depth_map: np.ndarray,
              img_time: float, img: np.ndarray) -> None:
        """inverse_compositional.rs:170-240."""
        cfg = self.config
        lm_model = iso_mul(iso_inverse(self.current_pose), self.keyframe_pose)
        img_multires = mean_pyramid(cfg.nb_levels, img)
        kf = self.keyframe_data
        went_well = True
        for lvl in reversed(range(cfg.nb_levels)):
            obs = Obs(
                intrinsics=kf.intrinsics_multires[lvl],
                template=kf.img_multires[lvl],
                image=img_multires[lvl],
                coordinates=kf.usable_candidates_multires[lvl][0],
                zs=kf.usable_candidates_multires[lvl][1],
                jacobians=kf.jacobians_multires[lvl],
                hessians=kf.hessians_multires[lvl],
            )
            try:
                eval_data, _ = iterative_solve_lm(obs, lm_model)
                lm_model = eval_data.model
            except CholeskyError:
                went_well = False
                break

        self.current_depth_timestamp = depth_time
        self.current_img_timestamp = img_time
        if went_well:
            self.current_pose = iso_mul(self.keyframe_pose, iso_inverse(lm_model))

        # Optical flow at coarsest level (inverse_compositional.rs:211-222).
        coords, zs = kf.usable_candidates_multires[-1]
        intr = kf.intrinsics_multires[-1]
        xs = np.array([c[0] for c in coords], F)
        ys = np.array([c[1] for c in coords], F)
        u, v = warp(lm_model, xs, ys, np.array(zs, F), intr)
        flow_sum = F(0.0)
        for i in range(len(coords)):
            flow_sum = F(flow_sum + F(abs(F(xs[i] - u[i])) + abs(F(ys[i] - v[i]))))
        optical_flow = F(flow_sum / F(len(coords)))
        self.last_flow = float(optical_flow)

        change_keyframe = optical_flow >= F(1.0)
        self.last_changed_keyframe = bool(change_keyframe)
        if change_keyframe:
            self.keyframe_data = precompute_multires_data(
                cfg, depth_map, kf.intrinsics_multires, img_multires
            )
            self.keyframe_depth_timestamp = depth_time
            self.keyframe_img_timestamp = img_time
            self.keyframe_pose = self.current_pose
            self.keyframe_switches += 1

    def current_frame(self) -> Tuple[float, Iso3]:
        """inverse_compositional.rs:243-248."""
        return self.current_depth_timestamp, self.current_pose
