"""Hard voxelization by one stable sort (port of
``deepinteraction_tpu/ops/voxelize.py``).

Points are stably sorted by linear voxel id, so point order inside a voxel
is kept. When more than ``max_voxels`` voxels exist, the voxels with the
smallest linear ids are kept (the JAX package's documented rule).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.spans import span


class VoxelizedOutput(NamedTuple):
    voxels: torch.Tensor  # [max_voxels, max_pts, D], zero padded
    num_points: torch.Tensor  # [max_voxels] int32
    coords: torch.Tensor  # [max_voxels, 3] int32 (iz, iy, ix), -1 for pad
    num_voxels: torch.Tensor  # [] int32


def _bin_points(points, points_mask, voxel_size, point_cloud_range):
    vx, vy, vz = voxel_size
    x0, y0, z0, x1, y1, z1 = point_cloud_range
    nx = int(round((x1 - x0) / vx))
    ny = int(round((y1 - y0) / vy))
    nz = int(round((z1 - z0) / vz))
    ix = torch.floor((points[:, 0] - x0) / vx).int()
    iy = torch.floor((points[:, 1] - y0) / vy).int()
    iz = torch.floor((points[:, 2] - z0) / vz).int()
    valid = (
        (ix >= 0) & (ix < nx) & (iy >= 0) & (iy < ny) & (iz >= 0) & (iz < nz)
    ) & points_mask
    n_cells = nx * ny * nz
    lin = torch.where(valid, (iz * ny + iy) * nx + ix, torch.full_like(ix, n_cells))
    return lin, valid, torch.stack([iz, iy, ix], -1)


def voxelize(
    points: torch.Tensor,
    points_mask: torch.Tensor,
    *,
    voxel_size,
    point_cloud_range,
    max_num_points: int,
    max_voxels: int,
) -> VoxelizedOutput:
    """points [N, D], points_mask [N] bool -> static-shape voxels."""
    n, d = points.shape
    dev = points.device
    lin, _, _ = _bin_points(points, points_mask, voxel_size, point_cloud_range)
    order = torch.sort(lin, stable=True).indices
    pts_s = points[order]
    lin_s, valid_s, izyx_s = _bin_points(
        pts_s, points_mask[order], voxel_size, point_cloud_range
    )

    first = torch.ones_like(valid_s)
    first[1:] = lin_s[1:] != lin_s[:-1]
    first &= valid_s
    with span("di.sync.voxelize.num_kept"):
        num_kept = min(int(first.sum().item()), max_voxels)

    idx = torch.arange(n, device=dev, dtype=torch.int32)

    # starts[r] = sorted index of voxel r's first point; the first dropped
    # voxel's start (or the count of valid points) closes the last segment
    with span("di.sync.voxelize.starts"):
        starts = idx[first][: num_kept + 1]
    with span("di.sync.voxelize.total_valid"):
        total_valid = int(valid_s.sum().item())
    ends = torch.cat([starts[1:], starts.new_full((1,), total_valid)])[:num_kept]
    starts = starts[:num_kept]
    counts = torch.zeros(max_voxels, dtype=torch.int32, device=dev)
    counts[:num_kept] = torch.clamp(ends - starts, max=max_num_points)

    slot_start = torch.zeros(max_voxels, dtype=torch.long, device=dev)
    slot_start[:num_kept] = starts.long()
    p = torch.arange(max_num_points, device=dev)
    src = (slot_start[:, None] + p).clamp(max=max(n - 1, 0))
    pmask = p[None, :] < counts[:, None]
    voxels = torch.where(pmask[..., None], pts_s[src], pts_s.new_zeros(()))

    coords = torch.full((max_voxels, 3), -1, dtype=torch.int32, device=dev)
    coords[:num_kept] = izyx_s[slot_start[:num_kept]]
    with span("di.sync.voxelize.num_voxels"):
        num_voxels = torch.tensor(num_kept, dtype=torch.int32, device=dev)
    return VoxelizedOutput(voxels=voxels, num_points=counts, coords=coords, num_voxels=num_voxels)


def voxelize_batched(points, points_mask, **kw) -> VoxelizedOutput:
    """``voxelize`` per sample of [B, N, D] points, stacked."""
    with span("di.voxelize"):
        outs = [voxelize(points[i], points_mask[i], **kw) for i in range(points.shape[0])]
        return VoxelizedOutput(*(torch.stack(f) for f in zip(*outs)))


def hard_simple_vfe(voxels: torch.Tensor, num_points: torch.Tensor) -> torch.Tensor:
    """Mean of the valid points of each voxel: [..., V, P, D] -> [..., V, D]."""
    p = voxels.shape[-2]
    mask = (torch.arange(p, device=voxels.device) < num_points[..., None]).to(voxels.dtype)
    s = (voxels * mask[..., None]).sum(-2)
    return s / torch.clamp(num_points[..., None].to(voxels.dtype), min=1.0)
