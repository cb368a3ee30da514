"""The sparse encoder's neighbour tables (``ops/sparse_conv.py``): the
kernels of ``csrc/sparse_tables.cu`` on the card, and their design on the
CPU.

On the card (marked ``gpu``; each test skips where
``torch.cuda.is_available()`` is false, decided inside the fixture): every
table function against its plain version on a CPU copy, bit for bit, at
the encoder's realistic shapes (the full 41x1440x1440 grid with about
160 000 sites laid out like a LiDAR surface, then each later stage's grid),
with invalid rows, sites on every grid face, a capacity below the number
of output sites, the ``(3,1,1)``/``(2,1,1)``/pad-0 ``conv_out`` table, the
``(0,1,1)`` pad of stage 2 and the inverse tables; all of it under
``torch.cuda.set_sync_debug_mode("error")``, so that a host sync fails, with
the launches a table read from the wrappers' ``.launches``. Run them with

    python -m pytest --noconftest -q -m gpu tests/test_torch_port_sparse_tables.py

On the CPU: the plain path is the one taken (no launch counted, the mask
reads' ``di.sync.sparse.*`` spans recorded), tensors on neither device
raise, the kernels are in the build, and the tables the public functions
give on CPU tensors, which the kernels are held to on the card, follow
their definitions.
"""

import json
import os
import re

import numpy as np
import pytest
import torch

from deepinteraction_tpu_torch.ops import cuda_lib
from deepinteraction_tpu_torch.ops import sparse_conv as sc

GRID = (41, 1440, 1440)
LOW, HIGH = np.array([-5.0, -54.0, -54.0]), np.array([3.0, 54.0, 54.0])  # z, y, x (fusion_base)
# (kernel, stride, pad) of the encoder's three downsamplings, then conv_out
DOWNS = [((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (1, 1, 1)), ((3, 3, 3), (2, 2, 2), (0, 1, 1))]
CONV_OUT = ((3, 1, 1), (2, 1, 1), (0, 0, 0))
COUNTERS = ("dense_index_map", "subm_neighbor_table", "strided_neighbor_table", "banded_overflow",
            "downsample_sites", "inverse_table")


def lidar_sites(seed: int, grid=GRID, capacity: int = 160_000, invalid: int = 0) -> tuple:
    """(coords [capacity, 3] int32, valid [capacity] bool): the voxels of a
    LiDAR-like cloud (ground rings from a spinning sensor over several
    sweeps, box surfaces, two walls) in ``fusion_base``'s point cloud range
    cut into ``grid`` (its voxel size at ``GRID``), sorted by linear id; a site on each of the grid's faces and corners;
    ``invalid`` random rows among them marked not valid; the rows past the
    sites at -1, as the voxelizer leaves them."""
    rng = np.random.default_rng(seed)
    pts = []
    elev = np.linspace(np.deg2rad(-30.7), np.deg2rad(-2.0), 32)
    for sweep in range(10):
        az = rng.uniform(0, 2 * np.pi, 4000)
        r = (1.8 / np.tan(-elev))[:, None] * rng.normal(1.0, 0.005, (32, az.size))
        r = np.minimum(r, 54.0)
        pts.append(np.stack([np.full(r.size, -1.8) + rng.normal(0, 0.03, r.size),
                             (r * np.sin(az)).ravel(), (r * np.cos(az)).ravel() + 0.4 * sweep], 1))
    for _ in range(40):
        ctr = rng.uniform(-45, 45, 2)
        w, l, h = rng.uniform(0.5, 3.0), rng.uniform(0.5, 12.0), rng.uniform(1.0, 3.8)
        u = rng.uniform(-0.5, 0.5, (2500, 3))
        face = rng.integers(0, 5, 2500)
        u[face == 0, 0], u[face == 1, 0], u[face == 2, 1], u[face == 3, 1], u[face == 4, 2] = 0.5, -0.5, 0.5, -0.5, 0.5
        pts.append(np.stack([-1.8 + (u[:, 2] + 0.5) * h, ctr[0] + u[:, 1] * w, ctr[1] + u[:, 0] * l], 1))
    for x in (-30.0, 35.0):
        u = rng.uniform(0, 1, (20_000, 2))
        pts.append(np.stack([-1.8 + 4.0 * u[:, 1], -50 + 100 * u[:, 0], np.full(len(u), x)], 1))
    p = np.concatenate(pts)
    voxel = (HIGH - LOW) / (np.array(grid) - (1, 0, 0))
    c = np.floor((p - LOW) / voxel).astype(np.int64)
    c = c[((c >= 0) & (c < np.array(grid))).all(1)]
    nz, ny, nx = grid
    faces = np.array([[z, y, x] for z in (0, nz // 2, nz - 1) for y in (0, ny // 3, ny - 1)
                      for x in (0, nx // 2, nx - 1)])
    face_ids = (faces[:, 0] * ny + faces[:, 1]) * nx + faces[:, 2]
    ids = np.setdiff1d((c[:, 0] * ny + c[:, 1]) * nx + c[:, 2], face_ids)
    keep = min(ids.size, capacity - face_ids.size - 32)
    ids = np.sort(np.concatenate([rng.choice(ids, keep, replace=False), face_ids]))
    coords = np.full((capacity, 3), -1, np.int32)
    coords[: ids.size] = np.stack([ids // (ny * nx), (ids // nx) % ny, ids % nx], 1)
    valid = np.arange(capacity) < ids.size
    if invalid:
        valid[rng.choice(ids.size, invalid, replace=False)] = False
    return torch.from_numpy(coords), torch.from_numpy(valid)


def encoder_chain(coords, valid, grid, capacities, with_inverse: bool, plan=(128, 512)) -> list:
    """Every table the encoder builds for one sample, in its order:
    [(name, output tensors)], with the sites each downsampling leaves."""
    out = []
    shape = grid
    for i in range(len(capacities) + 1):
        nbr = sc.subm_neighbor_table(sc.SparseTensor(None, coords, valid, shape))
        ovf = sc.banded_overflow(nbr, valid, *plan)
        ovf_tight = sc.banded_overflow(nbr, valid, 64, 16)  # a window every realistic tile overflows
        out.append((f"subm{i}", (nbr, ovf, ovf_tight) + ((sc.mirror_table(nbr),) if with_inverse else ())))
        kernel, stride, pad = DOWNS[i] if i < len(DOWNS) else CONV_OUT
        cap = capacities[i] if i < len(capacities) else coords.shape[0]
        oc, ov, oshape = sc.downsample_sites(coords, valid, shape, kernel, stride, pad, cap)
        snbr = sc.strided_neighbor_table(sc.SparseTensor(None, coords, valid, shape), oc, ov, kernel, stride, pad)
        inv = (sc.inverse_table(snbr, coords.shape[0]),) if with_inverse else ()
        out.append((f"down{i}", (oc, ov, snbr) + inv))
        if i == len(DOWNS):
            break
        coords, valid, shape = oc, ov, oshape
    return out


# ---------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is False)")
    cuda_lib.library()  # built before any timing or sync check
    return torch.device("cuda")


def _launches() -> dict:
    return {n: getattr(sc, n).launches for n in COUNTERS}


def _on_card_without_sync(fn):
    """fn() with every host sync an error, then synchronised."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("seed,invalid,capacities,with_inverse", [
    (1, 0, (90_000, 60_000, 30_000), False),  # the eval frame's capacities
    (2, 3_000, (90_000, 60_000, 30_000), True),  # invalid rows, the train step's inverse tables
    # every capacity below its stage's sites (an output site covers at most
    # 27 input sites, so each stage has more than 1/27 of its input's)
    (3, 0, (20_000, 700, 25), True),
])
def test_encoder_tables_match_plain(cuda, seed, invalid, capacities, with_inverse):
    coords, valid = lidar_sites(seed, invalid=invalid)
    assert int(valid.sum()) > 100_000
    on_card = coords.to(cuda), valid.to(cuda)
    before = _launches()
    got = _on_card_without_sync(lambda: encoder_chain(*on_card, GRID, capacities, with_inverse))
    spent = {n: v - before[n] for n, v in _launches().items()}
    want = encoder_chain(coords, valid, GRID, capacities, with_inverse)
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g), (_, w) in zip(got, want):
        for i, (a, b) in enumerate(zip(g, w)):
            assert a.dtype == b.dtype and a.shape == b.shape, (name, i)
            assert torch.equal(a.cpu(), b), (name, i)
    subm = [w for n, w in want if n.startswith("subm")]
    assert [bool(w[2]) for w in subm] == [True] * 4  # the tight window overflows
    if seed == 3:
        n_out = [int(w[1].sum()) for n, w in want if n.startswith("down")]
        assert n_out[:3] == list(capacities)  # each stage cut at its capacity
    # launches a table: the dense map 2, a lookup 1, a flag 1, the sites 4,
    # an inverse 2 (a memset beside the flag and the sites)
    n = len(subm)
    assert spent == {"dense_index_map": 2 * 2 * n, "subm_neighbor_table": n, "strided_neighbor_table": n,
                     "banded_overflow": 2 * n, "downsample_sites": 4 * n,
                     "inverse_table": 2 * n if with_inverse else 0}


@pytest.mark.gpu
def test_small_grids_and_faces_match_plain(cuda):
    """Every site of a small grid's faces, ragged tiles, and the pads of
    each downsampling; each function alone."""
    grid = (7, 13, 11)
    z, y, x = np.meshgrid(*[np.arange(n) for n in grid], indexing="ij")
    on_face = (z == 0) | (z == grid[0] - 1) | (y == 0) | (y == grid[1] - 1) | (x == 0) | (x == grid[2] - 1)
    c = np.stack([z[on_face], y[on_face], x[on_face]], 1).astype(np.int32)
    k = c.shape[0] + 5
    coords = torch.full((k, 3), -1, dtype=torch.int32)
    coords[: c.shape[0]] = torch.from_numpy(c)
    valid = torch.arange(k) < c.shape[0]
    valid[::17] = False

    def run(coords, valid):
        st = sc.SparseTensor(None, coords, valid, grid)
        out = [sc.dense_index_map(coords, valid, grid), sc.subm_neighbor_table(st)]
        out += [sc.banded_overflow(out[1], valid, t, w) for t, w in ((128, 512), (16, 8), (8, 64))]
        for kernel, stride, pad in DOWNS + [CONV_OUT]:
            for cap in (k, 40):
                oc, ov, _ = sc.downsample_sites(coords, valid, grid, kernel, stride, pad, cap)
                snbr = sc.strided_neighbor_table(st, oc, ov, kernel, stride, pad)
                out += [oc, ov, snbr, sc.inverse_table(snbr, k)]
        return out

    on_card = coords.to(cuda), valid.to(cuda)
    got = _on_card_without_sync(lambda: run(*on_card))
    for i, (a, b) in enumerate(zip(got, run(coords, valid))):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a.cpu(), b), i


# ---------------------------------------------------------------- on the CPU


def test_cpu_path_is_the_plain_one(tmp_path):
    """CPU tensors take the plain versions: no launch is counted, and the
    mask reads' sync spans are recorded under a profiler."""
    coords, valid = lidar_sites(5, grid=(41, 64, 64), capacity=3_000, invalid=40)
    before = _launches()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        encoder_chain(coords, valid, (41, 64, 64), (1_500, 600, 200), True)
    assert _launches() == before
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    names = [e.get("name") for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    # 8 dense maps a sample (two masks each) and 4 site selections
    assert names.count("di.sync.sparse.active_coords") == names.count("di.sync.sparse.active_rows") == 8
    assert names.count("di.sync.sparse.down_sites") == 4


def test_other_devices_raise():
    coords, valid = lidar_sites(6, grid=(9, 20, 20), capacity=100)
    meta_c, meta_v = coords.to("meta"), valid.to("meta")
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        sc.dense_index_map(meta_c, meta_v, (9, 20, 20))
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        sc.downsample_sites(meta_c, meta_v, (9, 20, 20), (3, 3, 3), (2, 2, 2), (1, 1, 1), 50)
    with pytest.raises(RuntimeError, match="expected CUDA tensors"):
        sc.inverse_table(torch.zeros(4, 27, dtype=torch.int32, device="meta"), 4)


def test_kernels_are_in_the_build():
    """``sparse_tables.cu`` is a source of the build, and every C entry the
    binding declares is defined (``extern "C"``) in one of the sources."""
    assert "sparse_tables.cu" in cuda_lib.SOURCES
    defined = set()
    for name in cuda_lib.SOURCES:
        with open(os.path.join(cuda_lib.CSRC_DIR, name)) as f:
            defined |= set(re.findall(r'extern "C"[^(]*?\b(di_\w+)\s*\(', f.read()))
    assert set(cuda_lib._SIGNATURES) <= defined, set(cuda_lib._SIGNATURES) - defined
    for name in ("di_dense_index_map", "di_neighbor_table", "di_banded_overflow", "di_downsample_sites",
                 "di_inverse_table"):
        assert name in cuda_lib._SIGNATURES


def definition_table(coords, valid, out_coords, out_valid, kernel, stride, pad) -> torch.Tensor:
    """A neighbour table from its definition: tap (dz, dy, dx) of output
    site o reads the valid input site at o * stride - pad + (dz, dy, dx),
    K where there is none or o is not valid."""
    k = coords.shape[0]
    rows = {tuple(c): i for i, (c, v) in enumerate(zip(coords.tolist(), valid.tolist())) if v}
    offsets = [(dz, dy, dx) for dz in range(kernel[0]) for dy in range(kernel[1]) for dx in range(kernel[2])]
    return torch.tensor([[rows.get(tuple(o[a] * stride[a] - pad[a] + off[a] for a in range(3)), k) if ov else k
                          for off in offsets] for o, ov in zip(out_coords.tolist(), out_valid.tolist())],
                        dtype=torch.int32).reshape(-1, len(offsets))


@pytest.mark.parametrize("capacity", [400, 40])
@pytest.mark.parametrize("geometry", DOWNS + [CONV_OUT], ids=["down0", "down1", "down2", "conv_out"])
def test_cpu_tables_follow_their_definitions(geometry, capacity):
    """What the kernels are held to on the card, the public functions give
    on CPU tensors, with no launch counted: over a small grid with sites on
    its faces and invalid rows, the output sites of a strided conv (every
    site some valid input reaches, sorted by linear id, the smallest kept
    past the capacity, the rest (0, 0, 0) and not valid), the submanifold
    and strided tables and the strided table's inverse, each against its
    definition."""
    kernel, stride, pad = geometry
    grid = (9, 14, 12)
    coords, valid = lidar_sites(7, grid=grid, capacity=150, invalid=10)
    before = _launches()
    oc, ov, oshape = sc.downsample_sites(coords, valid, grid, kernel, stride, pad, capacity)
    st = sc.SparseTensor(None, coords, valid, grid)
    nbr = sc.subm_neighbor_table(st)
    snbr = sc.strided_neighbor_table(st, oc, ov, kernel, stride, pad)
    inv = sc.inverse_table(snbr, coords.shape[0])
    assert _launches() == before

    reached = set()
    for c, v in zip(coords.tolist(), valid.tolist()):
        for off in np.ndindex(*kernel):
            o = [(c[a] + pad[a] - off[a]) / stride[a] for a in range(3)]
            if v and all(x == int(x) and 0 <= x < oshape[a] for a, x in enumerate(o)):
                reached.add(tuple(int(x) for x in o))
    sites = sorted(reached, key=lambda o: (o[0] * oshape[1] + o[1]) * oshape[2] + o[2])[:capacity]
    assert (len(reached) > capacity) == (capacity == 40)  # the cut is taken where asked
    want_oc = torch.zeros(capacity, 3, dtype=torch.int32)
    want_oc[: len(sites)] = torch.tensor(sites, dtype=torch.int32)
    assert torch.equal(oc, want_oc) and torch.equal(ov, torch.arange(capacity) < len(sites))

    assert torch.equal(nbr, definition_table(coords, valid, coords, valid, (3, 3, 3), (1, 1, 1), (1, 1, 1)))
    assert torch.equal(snbr, definition_table(coords, valid, oc, ov, kernel, stride, pad))
    want_inv = torch.full((coords.shape[0], snbr.shape[1]), capacity, dtype=torch.int32)
    for i, row in enumerate(snbr.tolist()):
        for d, j in enumerate(row):
            if j < coords.shape[0]:
                want_inv[j, d] = i
    assert torch.equal(inv, want_inv)
