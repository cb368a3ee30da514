"""3D box helpers (port of ``deepinteraction_tpu/utils/boxes.py``). Boxes
are [x, y, z_bottom, dx, dy, dz, yaw, ...] in the LiDAR frame."""

from __future__ import annotations

import torch

from .spans import span


def corners(boxes: torch.Tensor) -> torch.Tensor:
    """8 corners of each box, [..., 8, 3], in the JAX package's order."""
    x, y, z = boxes[..., 0], boxes[..., 1], boxes[..., 2]
    dx, dy, dz = boxes[..., 3], boxes[..., 4], boxes[..., 5]
    yaw = boxes[..., 6]
    with span("di.sync.boxes.corners_x"):
        ux = boxes.new_tensor([0.5, 0.5, 0.5, 0.5, -0.5, -0.5, -0.5, -0.5])
    with span("di.sync.boxes.corners_y"):
        uy = boxes.new_tensor([0.5, 0.5, -0.5, -0.5, 0.5, 0.5, -0.5, -0.5])
    with span("di.sync.boxes.corners_z"):
        uz = boxes.new_tensor([0.0, 1.0, 0.0, 1.0, 0.0, 1.0, 0.0, 1.0])
    cx = dx[..., None] * ux
    cy = dy[..., None] * uy
    cz = dz[..., None] * uz
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    rx = c * cx - s * cy
    ry = s * cx + c * cy
    return torch.stack([rx + x[..., None], ry + y[..., None], cz + z[..., None]], -1)


def bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """4 BEV corners [..., 4, 2] (ccw), from (x, y, dx, dy, yaw)."""
    x, y = boxes[..., 0], boxes[..., 1]
    dx, dy, yaw = boxes[..., 3], boxes[..., 4], boxes[..., 6]
    with span("di.sync.boxes.bev_corners_x"):
        ux = boxes.new_tensor([0.5, -0.5, -0.5, 0.5])
    cx = dx[..., None] * ux
    with span("di.sync.boxes.bev_corners_y"):
        uy = boxes.new_tensor([0.5, 0.5, -0.5, -0.5])
    cy = dy[..., None] * uy
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    return torch.stack([c * cx - s * cy + x[..., None], s * cx + c * cy + y[..., None]], -1)
