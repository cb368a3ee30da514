"""Sparse 3D convolution over a static-capacity COO voxel list (port of
``deepinteraction_tpu/ops/sparse_conv.py``).

A sparse tensor is (features [K, C], coords [K, 3] (z, y, x), valid [K]) with
coords sorted by linear id. Neighbor tables come from one dense index map
(linear id -> row, K = empty) and one lookup per tap; the convolutions
themselves run on K1 (``ops/subm_conv.py``), whose plain version
``gathered_matmul`` is re-exported here.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from .subm_conv import gathered_matmul  # noqa: F401  (the plain version of K1)


class SparseTensor(NamedTuple):
    features: torch.Tensor  # [K, C]
    coords: torch.Tensor  # [K, 3] int32 (z, y, x); arbitrary where ~valid
    valid: torch.Tensor  # [K] bool
    shape: Tuple[int, int, int]  # (nz, ny, nx)


def _kernel_offsets(kernel: Sequence[int]) -> list:
    kz, ky, kx = kernel
    return [(dz, dy, dx) for dz in range(kz) for dy in range(ky) for dx in range(kx)]


def out_shape(shape, kernel, stride, padding):
    """Grid shape after a conv of this kernel, stride and padding."""
    return tuple((shape[i] + 2 * padding[i] - kernel[i]) // stride[i] + 1 for i in range(3))


def dense_index_map(coords: torch.Tensor, valid: torch.Tensor, shape) -> torch.Tensor:
    """Flat [nz*ny*nx] int32 map: linear id -> row of the active set (K =
    empty). 340 MB at the full 41x1440x1440 grid."""
    nz, ny, nx = shape
    k = coords.shape[0]
    c = coords[valid].long()
    ids = (c[:, 0] * ny + c[:, 1]) * nx + c[:, 2]
    dense = torch.full((nz * ny * nx,), k, dtype=torch.int32, device=coords.device)
    dense[ids] = torch.arange(k, dtype=torch.int32, device=coords.device)[valid]
    return dense


def _lookup(dense, in_shape, tz, ty, tx, ok, miss):
    nz, ny, nx = in_shape
    inb = ok & (tz >= 0) & (tz < nz) & (ty >= 0) & (ty < ny) & (tx >= 0) & (tx < nx)
    tid = (tz.long() * ny + ty) * nx + tx
    pos = dense[tid.clamp(0, nz * ny * nx - 1)]
    return torch.where(inb, pos, torch.full_like(pos, miss))


def subm_neighbor_table(st: SparseTensor, kernel=(3, 3, 3)) -> torch.Tensor:
    """[K, prod(kernel)] int32 rows of the active set (K = miss). Tap d of
    site i reads the site at coords[i] + offset(d) - kernel // 2."""
    k = st.coords.shape[0]
    dense = dense_index_map(st.coords, st.valid, st.shape)
    rz, ry, rx = (kk // 2 for kk in kernel)
    c = st.coords
    cols = [
        _lookup(dense, st.shape, c[:, 0] + dz - rz, c[:, 1] + dy - ry, c[:, 2] + dx - rx, st.valid, k)
        for dz, dy, dx in _kernel_offsets(kernel)
    ]
    return torch.stack(cols, 1).int()


def strided_neighbor_table(
    in_st: SparseTensor, out_coords, out_valid, kernel, stride, padding
) -> torch.Tensor:
    """[Ko, prod(kernel)] int32 input rows for a strided sparse conv."""
    k = in_st.coords.shape[0]
    dense = dense_index_map(in_st.coords, in_st.valid, in_st.shape)
    oc = out_coords
    cols = []
    for dz, dy, dx in _kernel_offsets(kernel):
        tz = oc[:, 0] * stride[0] - padding[0] + dz
        ty = oc[:, 1] * stride[1] - padding[1] + dy
        tx = oc[:, 2] * stride[2] - padding[2] + dx
        cols.append(_lookup(dense, in_st.shape, tz, ty, tx, out_valid, k))
    return torch.stack(cols, 1).int()


def downsample_candidates(coords, valid, shape, kernel, stride, padding) -> torch.Tensor:
    """[8K] candidate output linear ids (sentinel = prod(out shape))."""
    oshape = out_shape(shape, kernel, stride, padding)

    def axis_candidates(x, k, s, p, n_out):
        hi = torch.div(x + p, s, rounding_mode="floor")
        lo = -torch.div(-(x + p - k + 1), s, rounding_mode="floor")
        c0 = hi
        c1 = torch.maximum(hi - 1, lo)
        v0 = (c0 >= lo) & (c0 >= 0) & (c0 < n_out)
        v1 = (c1 < hi) & (c1 >= 0) & (c1 < n_out)
        return (c0, v0), (c1, v1)

    zc, yc, xc = (
        axis_candidates(coords[:, i], kernel[i], stride[i], padding[i], oshape[i])
        for i in range(3)
    )
    onz, ony, onx = oshape
    sentinel = onz * ony * onx
    cands = []
    for cz, vz in zc:
        for cy, vy in yc:
            for cx, vx in xc:
                ok = vz & vy & vx & valid
                lid = (cz * ony + cy) * onx + cx
                cands.append(torch.where(ok, lid, torch.full_like(lid, sentinel)))
    return torch.cat(cands)


def downsample_sites(coords, valid, shape, kernel, stride, padding, out_capacity: int):
    """Output active set of a strided conv: sorted, deduped, the smallest
    linear ids kept on overflow. Returns (coords, valid, out_shape)."""
    oshape = out_shape(shape, kernel, stride, padding)
    onz, ony, onx = oshape
    sentinel = onz * ony * onx
    s_ids = torch.sort(downsample_candidates(coords, valid, shape, kernel, stride, padding)).values
    first = torch.ones_like(s_ids, dtype=torch.bool)
    first[1:] = s_ids[1:] != s_ids[:-1]
    first &= s_ids != sentinel
    ids = s_ids[first][:out_capacity]
    n_out = ids.shape[0]
    out_ids = torch.zeros(out_capacity, dtype=s_ids.dtype, device=s_ids.device)
    out_ids[:n_out] = ids
    valid_out = torch.arange(out_capacity, device=s_ids.device) < n_out
    oc = torch.stack([out_ids // (ony * onx), (out_ids // onx) % ony, out_ids % onx], 1)
    return oc.int(), valid_out, oshape


def to_dense_bev(st: SparseTensor) -> torch.Tensor:
    """Scatter to dense [ny, nx, C*nz] with channel index c*nz + z (the
    reference's ``out.dense().view(N, C*D, H, W)`` fold)."""
    nz, ny, nx = st.shape
    c = st.features.shape[1]
    dense = st.features.new_zeros(nz, ny, nx, c)
    co = st.coords[st.valid].long()
    dense[co[:, 0], co[:, 1], co[:, 2]] = st.features[st.valid]
    return dense.permute(1, 2, 3, 0).reshape(ny, nx, c * nz)
