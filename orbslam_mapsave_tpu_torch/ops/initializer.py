"""Two-view geometry for map initialization and triangulation.

Port of `orbslam_mapsave_tpu/ops/initializer.py`: only `triangulate_dlt`,
which RGB-D local mapping uses. The monocular initializer (homography /
fundamental RANSAC, `CheckRT`, `ReconstructF/H`) comes with the mono slice.
"""

from __future__ import annotations

import torch

from ..optim.lm import inv3x3


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor,
                    uv2: torch.Tensor) -> torch.Tensor:
    """Linear triangulation (Triangulate, `Initializer.cc:752-768`), batched.

    P1, P2: (..., 3, 4) projection matrices; uv: (..., N, 2) pixels, every
    leading dimension broadcasting. Returns (..., N, 3). As in the JAX
    version, the inhomogeneous (w = 1) 3x3 normal equations replace the
    4x4 homogeneous SVD; near-infinite points come out huge and are
    rejected by the cheirality / reprojection gates that follow."""
    def rows(P, uv):
        P = P[..., None, :, :]  # broadcast over the point axis
        return (uv[..., 0, None] * P[..., 2, :] - P[..., 0, :],
                uv[..., 1, None] * P[..., 2, :] - P[..., 1, :])

    A = torch.stack(torch.broadcast_tensors(*rows(P1, uv1), *rows(P2, uv2)),
                    dim=-2)  # (...,N,4,4)
    B = A[..., :3]
    c = A[..., 3]
    M = torch.sum(B[..., :, :, None] * B[..., :, None, :], dim=-3)  # (...,3,3)
    rhs = -torch.sum(B * c[..., None], dim=-2)  # (...,3)
    return torch.sum(inv3x3(M) * rhs[..., None, :], dim=-1)
