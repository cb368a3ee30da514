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

The tables are built by :func:`dense_index_map`, :func:`subm_neighbor_table`,
:func:`strided_neighbor_table`, :func:`banded_overflow`,
:func:`downsample_sites` and :func:`inverse_table`. On a CUDA tensor each
launches the kernels of ``csrc/sparse_tables.cu`` (a few a table, no host
sync; its source note says what bounds them) and counts them in its
``.launches``; on a CPU tensor it runs its plain version (the same name with
``_plain``), a chain of PyTorch ops whose boolean-mask reads each wait for
the device (``di.sync.sparse.*``); other tensors raise. The tables are
integers, and the two give the same values.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from ..utils.spans import grad_span, span
from . import cuda_lib
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


def _on_card(name: str, *tensors: torch.Tensor) -> bool:
    """False for CPU tensors (the plain version runs), True for CUDA tensors
    on one device; raises for anything else."""
    if tensors[0].device.type == "cpu":
        return False
    cuda_lib.require_cuda(name, *tensors)
    return True


def _check_sites(name: str, coords: torch.Tensor, valid: torch.Tensor) -> None:
    if coords.dtype != torch.int32 or valid.dtype != torch.bool:
        raise TypeError(f"{name}: want int32 coords and bool valid, got {coords.dtype} and {valid.dtype}")
    if coords.dim() != 2 or coords.shape[1] != 3 or valid.shape != coords.shape[:1]:
        raise ValueError(f"{name}: coords {tuple(coords.shape)} and valid {tuple(valid.shape)} do not agree")


_SITES_THREADS = 256  # csrc/sparse_tables.cu's kThreads


def _geometry(kernel, stride, padding, grid):
    """The int[12] a table kernel takes: kernel, stride, padding, grid."""
    return (ctypes.c_int * 12)(*kernel, *stride, *padding, *grid)


def dense_index_map(coords: torch.Tensor, valid: torch.Tensor, shape) -> torch.Tensor:
    """Flat [nz*ny*nx] int32 map: linear id -> row of the active set (K =
    empty). 340 MB at the full 41x1440x1440 grid. On the card: a fill and
    a scatter, a thread a row (valid coords are unique)."""
    if not _on_card("dense_index_map", coords, valid):
        return dense_index_map_plain(coords, valid, shape)
    _check_sites("dense_index_map", coords, valid)
    nz, ny, nx = shape
    dense = torch.empty(nz * ny * nx, dtype=torch.int32, device=coords.device)
    code = cuda_lib.library().di_dense_index_map(coords.data_ptr(), valid.data_ptr(), dense.data_ptr(),
                                                 coords.shape[0], nz, ny, nx, cuda_lib.stream_ptr(coords.device))
    cuda_lib.check(code, "dense_index_map")
    dense_index_map.launches += 2
    return dense


def _table_on_card(counter, dense, out_coords, out_valid, miss, kernel, stride, padding, grid) -> torch.Tensor:
    """The lookup kernel: [Ko, prod(kernel)] int32 over ``dense``."""
    _check_sites(counter.__name__, out_coords, out_valid)
    ko, taps = out_coords.shape[0], kernel[0] * kernel[1] * kernel[2]
    table = torch.empty(ko, taps, dtype=torch.int32, device=out_coords.device)
    code = cuda_lib.library().di_neighbor_table(
        dense.data_ptr(), out_coords.data_ptr(), out_valid.data_ptr(), table.data_ptr(), ko, miss,
        _geometry(kernel, stride, padding, grid), cuda_lib.stream_ptr(out_coords.device))
    cuda_lib.check(code, counter.__name__)
    counter.launches += 1
    return table


def dense_index_map_plain(coords: torch.Tensor, valid: torch.Tensor, shape) -> torch.Tensor:
    """The plain version of :func:`dense_index_map`: two mask reads."""
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
    site i reads the site at coords[i] + offset(d) - kernel // 2. On the
    card: :func:`dense_index_map`, then the lookup kernel with stride 1."""
    if not _on_card("subm_neighbor_table", st.coords, st.valid):
        return subm_neighbor_table_plain(st, kernel)
    dense = dense_index_map(st.coords, st.valid, st.shape)
    return _table_on_card(subm_neighbor_table, dense, st.coords, st.valid, st.coords.shape[0], kernel,
                          (1, 1, 1), tuple(kk // 2 for kk in kernel), st.shape)


def subm_neighbor_table_plain(st: SparseTensor, kernel=(3, 3, 3)) -> torch.Tensor:
    """The plain version of :func:`subm_neighbor_table`: a lookup a tap."""
    k = st.coords.shape[0]
    dense = dense_index_map_plain(st.coords, st.valid, st.shape)
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
    nbr [K, 27] int32 (K = miss), valid [K] bool. No host sync. On the
    card: a block a tile, each group's smallest and largest hit, and a
    store of true where ``largest - start >= w``."""
    k, taps = nbr.shape
    if taps != 27:
        raise ValueError(f"banded_overflow: a 3x3x3 submanifold table, not {taps} taps")
    if not _on_card("banded_overflow", nbr, valid):
        return banded_overflow_plain(nbr, valid, t, w)
    if nbr.dtype != torch.int32 or valid.dtype != torch.bool or valid.shape != (k,):
        raise TypeError("banded_overflow: want an int32 [K, 27] table and a bool [K] valid")
    kp = -(-k // t) * t
    rout = -(-(kp + 1 + w) // 512) * 512
    flag = torch.empty((), dtype=torch.bool, device=nbr.device)
    code = cuda_lib.library().di_banded_overflow(nbr.data_ptr(), valid.data_ptr(), flag.data_ptr(), k, t, w,
                                                 rout - w, cuda_lib.stream_ptr(nbr.device))
    cuda_lib.check(code, "banded_overflow")
    banded_overflow.launches += 1
    return flag


def banded_overflow_plain(nbr: torch.Tensor, valid: torch.Tensor, t: int = 128, w: int = 512) -> torch.Tensor:
    """The plain version of :func:`banded_overflow`: the plan's windows
    written out over the padded table."""
    k, taps = nbr.shape
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
    too); misses (``nbr == k_in``) land in a dropped extra row. On the
    card: a fill and a scatter, a thread a table element."""
    if not _on_card("inverse_table", nbr):
        return inverse_table_plain(nbr, k_in)
    if nbr.dtype != torch.int32 or nbr.dim() != 2:
        raise TypeError("inverse_table: want an int32 [Ko, D] table")
    ko, taps = nbr.shape
    inv = torch.empty(k_in, taps, dtype=torch.int32, device=nbr.device)
    code = cuda_lib.library().di_inverse_table(nbr.data_ptr(), inv.data_ptr(), ko, taps, k_in,
                                               cuda_lib.stream_ptr(nbr.device))
    cuda_lib.check(code, "inverse_table")
    inverse_table.launches += 2
    return inv


def inverse_table_plain(nbr: torch.Tensor, k_in: int) -> torch.Tensor:
    """The plain version of :func:`inverse_table`: one index scatter."""
    ko, taps = nbr.shape
    inv = torch.full((k_in + 1, taps), ko, dtype=torch.int32, device=nbr.device)
    rows = torch.arange(ko, dtype=torch.int32, device=nbr.device)[:, None].expand(ko, taps)
    cols = torch.arange(taps, device=nbr.device)[None].expand(ko, taps)
    inv[nbr.long(), cols] = rows
    return inv[:k_in].contiguous()


def strided_neighbor_table(
    in_st: SparseTensor, out_coords, out_valid, kernel, stride, padding
) -> torch.Tensor:
    """[Ko, prod(kernel)] int32 input rows for a strided sparse conv (K =
    miss). On the card: :func:`dense_index_map` of the input, then the
    lookup kernel."""
    if not _on_card("strided_neighbor_table", in_st.coords, in_st.valid, out_coords, out_valid):
        return strided_neighbor_table_plain(in_st, out_coords, out_valid, kernel, stride, padding)
    dense = dense_index_map(in_st.coords, in_st.valid, in_st.shape)
    return _table_on_card(strided_neighbor_table, dense, out_coords, out_valid, in_st.coords.shape[0], kernel,
                          stride, padding, in_st.shape)


def strided_neighbor_table_plain(
    in_st: SparseTensor, out_coords, out_valid, kernel, stride, padding
) -> torch.Tensor:
    """The plain version of :func:`strided_neighbor_table`: a lookup a tap."""
    k = in_st.coords.shape[0]
    dense = dense_index_map_plain(in_st.coords, in_st.valid, in_st.shape)
    oc = out_coords
    cols = []
    for dz, dy, dx in _kernel_offsets(kernel):
        tz = oc[:, 0] * stride[0] - padding[0] + dz
        ty = oc[:, 1] * stride[1] - padding[1] + dy
        tx = oc[:, 2] * stride[2] - padding[2] + dx
        cols.append(_lookup(dense, in_st.shape, tz, ty, tx, out_valid, k))
    return torch.stack(cols, 1).int()


def downsample_candidates(coords, valid, shape, kernel, stride, padding) -> torch.Tensor:
    """[8K] candidate output linear ids (sentinel = prod(out shape)): the
    first step of :func:`downsample_sites_plain`."""
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
    linear ids kept on overflow, the rows past the count at (0, 0, 0) and
    not valid. Returns (coords, valid, out_shape). On the card: each valid
    site marks its candidates in a bitmask over the output grid, and a
    stream compaction writes the marked ids in order; the count stays on
    the card, and the scratch is freed before this returns."""
    oshape = out_shape(shape, kernel, stride, padding)
    if not _on_card("downsample_sites", coords, valid):
        return downsample_sites_plain(coords, valid, shape, kernel, stride, padding, out_capacity)
    _check_sites("downsample_sites", coords, valid)
    dev = coords.device
    # the bitmask (a bit a cell of the output grid), the blocks' counts and
    # their offsets; a block of the compaction takes _SITES_THREADS words
    words = -(-(oshape[0] * oshape[1] * oshape[2]) // 32)
    nb = max(1, -(-words // _SITES_THREADS))
    scratch = torch.empty(words + 2 * nb + 1, dtype=torch.int32, device=dev)
    oc = torch.empty(out_capacity, 3, dtype=torch.int32, device=dev)
    valid_out = torch.empty(out_capacity, dtype=torch.bool, device=dev)
    code = cuda_lib.library().di_downsample_sites(
        coords.data_ptr(), valid.data_ptr(), scratch.data_ptr(), oc.data_ptr(), valid_out.data_ptr(),
        coords.shape[0], out_capacity, _geometry(kernel, stride, padding, oshape),
        cuda_lib.stream_ptr(coords.device))
    cuda_lib.check(code, "downsample_sites")
    downsample_sites.launches += 4
    return oc, valid_out, oshape


def downsample_sites_plain(coords, valid, shape, kernel, stride, padding, out_capacity: int):
    """The plain version of :func:`downsample_sites`: a sort of the
    candidates and a mask read."""
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


dense_index_map.launches = 0
subm_neighbor_table.launches = 0
strided_neighbor_table.launches = 0
banded_overflow.launches = 0
downsample_sites.launches = 0
inverse_table.launches = 0
