"""Camera geometry for PatchMatch MVS, as broadcasting torch ops.

All functions broadcast over arbitrary leading batch dimensions; pixel
coordinates are (x, y) float pairs in image space, planes are
(nx, ny, nz, w) with the normal in the reference-camera frame and w the
signed plane distance to the camera origin (the float4 "plane hypothesis"
of the reference, main.h / APD.cu:218-240). The reference assumes zero-skew
intrinsics (it never reads K[0,1]); so do we.

The 3x3 algebra is unrolled into elementwise float32 products, never
``matmul``/``einsum``, so no TF32 tensor-core path can touch it on the card.

The random helpers take their draws as arguments (``*_from_*``): torch
cannot reproduce the JAX package's threefry streams, so parity with it is
exact only when both sides are handed the same draws; the pipeline draws
them from an explicit ``torch.Generator``.

Camera convention: x_cam = R @ x_world + t;  world center c = -R^T t.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def f32_scalar(v, device) -> torch.Tensor:
    """A 0-d float32 tensor: scalar parameters (depth bounds, factors) take
    part in float32 arithmetic, as in the JAX package, not in Python's
    float64."""
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def pixel_grid(height: int, width: int, device):
    """(xs, ys) float32 pixel coordinates of an (H, W) image."""
    ys, xs = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=device),
        torch.arange(width, dtype=torch.float32, device=device),
        indexing="ij")
    return xs, ys


def mat3_vec(M, v):
    """Unrolled 3x3 matrix-vector product."""
    return torch.stack([
        M[..., 0, 0] * v[..., 0] + M[..., 0, 1] * v[..., 1] + M[..., 0, 2] * v[..., 2],
        M[..., 1, 0] * v[..., 0] + M[..., 1, 1] * v[..., 1] + M[..., 1, 2] * v[..., 2],
        M[..., 2, 0] * v[..., 0] + M[..., 2, 1] * v[..., 1] + M[..., 2, 2] * v[..., 2],
    ], dim=-1)


def mat3t_vec(M, v):
    """Unrolled transpose(3x3) matrix-vector product."""
    return torch.stack([
        M[..., 0, 0] * v[..., 0] + M[..., 1, 0] * v[..., 1] + M[..., 2, 0] * v[..., 2],
        M[..., 0, 1] * v[..., 0] + M[..., 1, 1] * v[..., 1] + M[..., 2, 1] * v[..., 2],
        M[..., 0, 2] * v[..., 0] + M[..., 1, 2] * v[..., 1] + M[..., 2, 2] * v[..., 2],
    ], dim=-1)


def mat3_mat3t(A, B):
    """Unrolled A @ B^T for 3x3 matrices."""
    rows = []
    for i in range(3):
        cols = [A[..., i, 0] * B[..., j, 0] + A[..., i, 1] * B[..., j, 1]
                + A[..., i, 2] * B[..., j, 2] for j in range(3)]
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


@dataclasses.dataclass(frozen=True)
class CameraArrays:
    """A batch of pinhole cameras as stacked float32 tensors (leading dims =
    views)."""

    K: torch.Tensor    # (..., 3, 3)
    R: torch.Tensor    # (..., 3, 3)
    t: torch.Tensor    # (..., 3)
    c: torch.Tensor    # (..., 3) world center

    @property
    def fx(self):
        return self.K[..., 0, 0]

    @property
    def fy(self):
        return self.K[..., 1, 1]

    @property
    def cx(self):
        return self.K[..., 0, 2]

    @property
    def cy(self):
        return self.K[..., 1, 2]

    @staticmethod
    def from_cameras(cams, *, device) -> "CameraArrays":
        """Stack a list of io.cameras.Camera into float32 tensors on
        ``device``."""
        def stack(vals):
            return torch.as_tensor(np.stack(vals).astype(np.float32),
                                   device=device)
        return CameraArrays(stack([c.K for c in cams]),
                            stack([c.R for c in cams]),
                            stack([c.t for c in cams]),
                            stack([c.c for c in cams]))

    def map(self, fn) -> "CameraArrays":
        """Apply ``fn`` to every field (indexing, reshaping, moving)."""
        return CameraArrays(fn(self.K), fn(self.R), fn(self.t), fn(self.c))

    def view(self, i) -> "CameraArrays":
        return self.map(lambda a: a[i])


def backproject(cam: CameraArrays, x, y, depth):
    """Pixel + depth -> point in camera frame (reference: Get3DPoint,
    APD.cu:190-202). Returns (..., 3)."""
    X = depth * (x - cam.cx) / cam.fx
    Y = depth * (y - cam.cy) / cam.fy
    return torch.stack([X, Y, depth * torch.ones_like(X)], dim=-1)


def cam_to_world(cam: CameraArrays, X_cam):
    """Camera-frame point -> world (reference: Get3DPointonWorld_cu,
    APD.cu:831-851): R^T X + c."""
    return mat3t_vec(cam.R, X_cam) + cam.c


def backproject_world(cam: CameraArrays, x, y, depth):
    return cam_to_world(cam, backproject(cam, x, y, depth))


def project(cam: CameraArrays, X_world):
    """World point -> (x, y, depth) in a camera (reference: ProjectonCamera_cu,
    APD.cu:853-863)."""
    Xc = mat3_vec(cam.R, X_world) + cam.t
    uvw = mat3_vec(cam.K, Xc)
    depth = uvw[..., 2]
    return uvw[..., 0] / depth, uvw[..., 1] / depth, depth


def view_direction(cam: CameraArrays, x, y, depth=1.0):
    """Unit vector from the camera origin through the pixel (reference:
    GetViewDirection, APD.cu:204-216)."""
    X = backproject(cam, x, y, depth * torch.ones_like(x))
    return X / torch.linalg.vector_norm(X, dim=-1, keepdim=True)


def plane_dist_to_origin(cam: CameraArrays, x, y, depth, normal):
    """w = -(n . X) for the backprojected point (reference: GetDistance2Origin,
    APD.cu:218-223). normal (..., 3) -> scalar (...)."""
    return -(normal * backproject(cam, x, y, depth)).sum(-1)


def depth_from_plane(cam: CameraArrays, plane, x, y):
    """Depth induced at pixel (x, y) by plane (nx, ny, nz, w)
    (reference: ComputeDepthfromPlaneHypothesis, APD.cu:237-240)."""
    nx, ny, nz, w = plane[..., 0], plane[..., 1], plane[..., 2], plane[..., 3]
    denom = (x - cam.cx) * nx + (cam.fx / cam.fy) * (y - cam.cy) * ny \
        + cam.fx * nz
    return -w * cam.fx / denom


def make_plane(cam: CameraArrays, x, y, depth, normal):
    """Assemble a plane hypothesis (normal, w) for a pixel at given depth."""
    w = plane_dist_to_origin(cam, x, y, depth, normal)
    return torch.cat([normal, w[..., None]], dim=-1)


def normal_cam_to_world(R, normal4):
    """Rotate a plane hypothesis' normal from ref-camera frame to world
    (reference: TransformNormal, APD.cu:405-413): n_w = R^T n_c; w unchanged."""
    return torch.cat([mat3t_vec(R, normal4[..., :3]), normal4[..., 3:4]], -1)


def normal_world_to_cam(R, normal4):
    """Inverse of normal_cam_to_world (reference: TransformNormal2RefCam,
    APD.cu:415-423): n_c = R n_w."""
    return torch.cat([mat3_vec(R, normal4[..., :3]), normal4[..., 3:4]], -1)


def relative_pose(ref: CameraArrays, src: CameraArrays):
    """R_rel = R_src R_ref^T; t_rel = R_src (c_ref - c_src)
    (reference: ComputeHomography, APD.cu:334-362)."""
    return mat3_mat3t(src.R, ref.R), mat3_vec(src.R, ref.c - src.c)


def homography(ref: CameraArrays, src: CameraArrays, plane):
    """Plane-induced homography H = K_src (R_rel - t_rel n^T / w) K_ref^{-1}
    mapping ref pixels to src pixels (reference: ComputeHomography,
    APD.cu:334-394; zero skew assumed, as in the reference).

    plane: (..., 4), broadcast against the camera batch. Returns (..., 3, 3).
    """
    R_rel, t_rel = relative_pose(ref, src)
    n = plane[..., :3]
    w = plane[..., 3:4]
    M = R_rel - t_rel[..., :, None] * (n / w)[..., None, :]

    # right-multiply by K_ref^{-1} (zero skew)
    fx_r, fy_r = ref.fx[..., None], ref.fy[..., None]
    cx_r, cy_r = ref.cx[..., None], ref.cy[..., None]
    col0 = M[..., 0] / fx_r
    col1 = M[..., 1] / fy_r
    col2 = M[..., 2] - col0 * cx_r - col1 * cy_r
    MKinv = torch.stack([col0, col1, col2], dim=-1)

    # left-multiply by K_src (zero skew)
    fx_s, fy_s = src.fx[..., None], src.fy[..., None]
    cx_s, cy_s = src.cx[..., None], src.cy[..., None]
    row0 = fx_s * MKinv[..., 0, :] + cx_s * MKinv[..., 2, :]
    row1 = fy_s * MKinv[..., 1, :] + cy_s * MKinv[..., 2, :]
    row2 = MKinv[..., 2, :]
    return torch.stack([row0, row1, row2], dim=-2)


def warp(H, x, y):
    """Apply a homography to pixel coordinates (reference:
    ComputeCorrespondingPoint, APD.cu:396-403). H (..., 3, 3); x, y (...)."""
    px = H[..., 0, 0] * x + H[..., 0, 1] * y + H[..., 0, 2]
    py = H[..., 1, 0] * x + H[..., 1, 1] * y + H[..., 1, 2]
    pz = H[..., 2, 0] * x + H[..., 2, 1] * y + H[..., 2, 2]
    return px / pz, py / pz


# ---------------------------------------------------------------------------
# Random plane hypotheses from injected draws (reference: APD.cu:242-332).
# ---------------------------------------------------------------------------

def unit_normal_facing_from_gaussian(g, cam: CameraArrays, x, y, depth):
    """Unit normal from a raw Gaussian draw ``g`` (..., 3), flipped to face
    the camera (reference: GenerateRandomNormal, APD.cu:242-268; Marsaglia
    sampling replaced by normalized Gaussians — same distribution)."""
    n = g / torch.clamp(torch.linalg.vector_norm(g, dim=-1, keepdim=True),
                        min=1e-12)
    vd = view_direction(cam, x, y, depth)
    flip = (n * vd).sum(-1, keepdim=True) > 0
    return torch.where(flip, -n, n)


def random_plane_from_draws(u, g, cam: CameraArrays, x, y, depth_min,
                            depth_max):
    """Random depth in range + random facing normal -> plane (reference:
    GenerateRandomPlaneHypothesis, APD.cu:307-313). ``u`` (...) uniform
    [0, 1) and ``g`` (..., 3) standard normal draws; the depth is
    max(depth_min, u * (depth_max - depth_min) + depth_min), the exact map
    jax.random.uniform applies with minval/maxval (in float32)."""
    depth_min = f32_scalar(depth_min, u.device)
    depth_max = f32_scalar(depth_max, u.device)
    depth = torch.maximum(u * (depth_max - depth_min) + depth_min, depth_min)
    n = unit_normal_facing_from_gaussian(g, cam, x, y, depth)
    return make_plane(cam, x, y, depth, n)
