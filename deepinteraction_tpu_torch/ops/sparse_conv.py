"""Sparse 3D convolution over a static-capacity COO voxel list (port of
``deepinteraction_tpu/ops/sparse_conv.py``).

A sparse tensor is (features [K, C], coords [K, 3] (z, y, x), valid [K]) with
coords sorted by linear id. Neighbor tables come from one dense index map
(linear id -> row, K = empty) and one lookup per tap; the convolutions
themselves run on K1 (``ops/subm_conv.py``), whose plain version
``gathered_matmul`` is re-exported here. K1's d/dfeat runs over a table's
inverse (``inv[j, d] = i`` where ``nbr[i, d] = j``): :func:`mirror_table`
for a submanifold table, :func:`inverse_table` for any table in which each
input row is reached at most once per tap (a strided one).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import torch

from ..utils.spans import grad_span, span
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
    with span("di.sync.sparse.active_coords"):
        c = coords[valid].long()
    ids = (c[:, 0] * ny + c[:, 1]) * nx + c[:, 2]
    dense = torch.full((nz * ny * nx,), k, dtype=torch.int32, device=coords.device)
    with span("di.sync.sparse.active_rows"):
        rows = torch.arange(k, dtype=torch.int32, device=coords.device)[valid]
    dense[ids] = rows
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


def banded_overflow(nbr: torch.Tensor, valid: torch.Tensor, t: int = 128, w: int = 512) -> torch.Tensor:
    """[] bool on the table's device: the overflow flag of the JAX banded
    plan (``deepinteraction_tpu/ops/sparse_conv_banded.py::make_banded_plan``,
    ``:73-95``, its ``ovf``) for tiles of ``t`` rows and a window of ``w``.
    Each tile's 9 (dz, dy) groups of 3 x-taps share a window that starts at
    the smallest row they reach (8-aligned, clipped to the padded output);
    the flag is set where a hit lies ``w`` or more rows past its window's
    start. JAX then computes the sample-stage's convs with the fp32 gather.
    nbr [K, 27] int32 (K = miss), valid [K] bool. No host sync."""
    k, taps = nbr.shape
    if taps != 27:
        raise ValueError(f"banded_overflow: a 3x3x3 submanifold table, not {taps} taps")
    nt = -(-k // t)
    kp = nt * t
    rout = -(-(kp + 1 + w) // 512) * 512
    nbrp = torch.full((kp, taps), k, dtype=torch.int32, device=nbr.device)
    nbrp[:k] = torch.where(valid[:, None], nbr, torch.full_like(nbr, k))
    miss = (nbrp == k).reshape(nt, t, 9, 3)
    nbrp = nbrp.reshape(nt, t, 9, 3)
    big = torch.iinfo(torch.int32).max
    starts = torch.where(miss, big, nbrp).amin(dim=(1, 3))  # [nt, 9]
    starts = torch.where(starts == big, 0, starts)
    starts = (starts & ~7).clamp(0, rout - w)
    local = torch.where(miss, -1, nbrp - starts[:, None, :, None])
    return (local >= w).any()


def mirror_table(nbr: torch.Tensor) -> torch.Tensor:
    """Inverse of a submanifold table: ``inv[:, d] = nbr[:, mirror(d)]``
    with ``mirror(d) = D - 1 - d`` (tap offset negated; the JAX backward's
    trick, ``deepinteraction_tpu/ops/sparse_conv_banded.py:54-55``). Exact
    because site i reaches site j at offset o iff j reaches i at -o, and
    the table's miss value K is also the inverse's (Ko = K)."""
    return nbr.flip(1).contiguous()


def inverse_table(nbr: torch.Tensor, k_in: int) -> torch.Tensor:
    """[k_in, D] int32 with ``inv[j, d] = i`` where ``nbr[i, d] = j`` and
    Ko = ``nbr.shape[0]`` for a miss: one index scatter. Exact where each
    (j, d) is reached at most once, as in a strided table (an output site
    and a tap fix the input site, and the stride makes the converse unique
    too); misses (``nbr == k_in``) land in a dropped extra row."""
    ko, taps = nbr.shape
    inv = torch.full((k_in + 1, taps), ko, dtype=torch.int32, device=nbr.device)
    rows = torch.arange(ko, dtype=torch.int32, device=nbr.device)[:, None].expand(ko, taps)
    cols = torch.arange(taps, device=nbr.device)[None].expand(ko, taps)
    inv[nbr.long(), cols] = rows
    return inv[:k_in].contiguous()


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
    with span("di.sync.sparse.down_sites"):
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
    with span("di.sync.sparse.bev_coords"):
        co = st.coords[st.valid].long()
    with span("di.sync.sparse.bev_features"):
        feats = grad_span(st.features[st.valid], "di.sync.sparse.bev_features.grad")
    dense[co[:, 0], co[:, 1], co[:, 2]] = feats
    return dense.permute(1, 2, 3, 0).reshape(ny, nx, c * nz)
