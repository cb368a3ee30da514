"""The port's on-device matching (``deepinteraction_tpu_torch/ops/
hungarian.py``, ``targets/assign.py``) against the JAX package, on the CPU.

- ``auction_assign_plain`` against JAX ``auction_assign``: assignments
  exactly equal (ties broken alike, not merely equally optimal) on the
  cases of ``tests/test_auction_lap.py`` (three shapes x 5 seeds, zero GT,
  the batched [2, 3, 12, 8] case, the 200 x 200 / 30-GT model scale, the
  extreme cost scales, the tied integer costs, the constant costs), on a
  single row and on two eps phases; on the same cases every valid column
  is assigned once and the objective is within eps * G of scipy's (eps =
  1e-3 of the cost scale, with 10 % for float32 prices).
- The kernel's rounds (``csrc/auction_lap.cu``) written out step by step
  in float32 numpy scalars (each open column's scan by 32 lanes merged as
  the warp's redux.sync steps merge them, one shared scan for the columns
  without a cost, the row pass by the atomicMax of (bid key, ~column))
  equal the plain version on the small cases, a mostly-dummy one and one
  whose real columns tie the dummies: the kernel is held to the plain
  version itself on the card (``tests/test_torch_port_kernels.py``,
  ``chip_smoke.py``).
- ``build_targets`` with ``lap_impl=auction`` against JAX ``build_targets``
  on the same ``tiny_config`` predictions and GT: labels and weights
  exactly, the regression and IoU targets, heatmap and mean IoU at 1e-5;
  ``hungarian_assign`` refuses another ``impl`` and G > P.
- ``heuristic_assign`` against JAX on ``tests/test_auction_lap.py``'s
  cases, with class gating, masked GTs, exact distance ties (the smallest
  GT index wins) and a random case.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax
import jax.numpy as jnp

from deepinteraction_tpu import configs as jcfg
from deepinteraction_tpu.ops import hungarian as jhung
from deepinteraction_tpu.targets import assign as jassign
from deepinteraction_tpu.utils.testing import make_synthetic_batch as jax_batch
from deepinteraction_tpu_torch import configs as tcfg
from deepinteraction_tpu_torch.ops import hungarian as thung
from deepinteraction_tpu_torch.targets import assign as tassign
from deepinteraction_tpu_torch.train.step import bev_shape

torch.set_num_threads(1)

EPS_REL = 1e-3  # JAX auction_assign's default phase
GAP_SLACK = 1.1  # the eps * G bound with 10 % for float32 prices
TARGET_TOL = 1e-5


def _seeded(p, g, trial, low=0.0, high=5.0, seed=0):
    """The ``trial``-th cost of ``test_auction_lap.py``'s loop over one rng."""
    rng = np.random.default_rng(seed)
    for _ in range(trial + 1):
        cost = rng.uniform(low, high, size=(p, g)).astype(np.float32)
    return cost


def _scales(scale):
    rng = np.random.default_rng(7)
    return (rng.uniform(0, 1, size=(64, 40)) * scale).astype(np.float32)


CASES = {  # name: () -> (cost [..., P, G], num_gt [...], eps_phases)
    **{f"p{p}_g{g}_ng{ng}_seed{t}": (lambda p=p, g=g, ng=ng, t=t: (_seeded(p, g, t), np.int32(ng), (EPS_REL,)))
       for p, g, ng in [(20, 10, 10), (30, 30, 17), (8, 8, 8)] for t in range(5)},
    "zero_gt": lambda: (np.ones((10, 5), np.float32), np.int32(0), (EPS_REL,)),
    "batched": lambda: (np.random.default_rng(1).uniform(0, 3, size=(2, 3, 12, 8)).astype(np.float32),
                        np.array([[8, 8, 8], [5, 5, 5]], np.int32), (EPS_REL,)),
    "model_scale": lambda: (np.random.default_rng(5).uniform(0, 10, size=(200, 200)).astype(np.float32),
                            np.int32(30), (EPS_REL,)),
    **{f"scale_{s:g}": (lambda s=s: (_scales(s), np.int32(40), (EPS_REL,))) for s in (1e-3, 1.0, 1e3)},
    "integer_ties": lambda: (np.random.default_rng(11).integers(0, 4, size=(100, 60)).astype(np.float32),
                             np.int32(60), (EPS_REL,)),
    "constant": lambda: (np.full((50, 20), 2.5, np.float32), np.int32(20), (EPS_REL,)),
    "one_row": lambda: (np.array([[3.0]], np.float32), np.int32(1), (EPS_REL,)),
    "two_phases": lambda: (_seeded(30, 30, 0, high=10.0, seed=3), np.int32(25), (1e-2, EPS_REL)),
    # 59 of 64 columns dummies (three of them with costs past num_gt)
    "mostly_dummies": lambda: (_seeded(64, 8, 0, seed=13), np.int32(5), (EPS_REL,)),
    # zero costs: real columns see the dummies' benefit (-0 against +0)
    # and tie with their bids, so the smaller (real) column must win
    "dummy_ties": lambda: (np.random.default_rng(17).integers(0, 2, size=(40, 12)).astype(np.float32),
                           np.int32(12), (EPS_REL,)),
}
# the cases whose kernel rounds the test writes out in Python
EMULATED = [k for k in CASES if k.startswith(("p8_", "p20_", "p30_"))] + [
    "zero_gt", "one_row", "two_phases", "integer_ties", "mostly_dummies", "dummy_ties"]


def _objective(cost, a):
    rows = np.nonzero(a >= 0)[0]
    return float(cost[rows, a[rows]].astype(np.float64).sum())


@pytest.mark.parametrize("case", list(CASES))
def test_auction_plain_equals_jax(case):
    cost, num_gt, phases = CASES[case]()
    want = np.asarray(jhung.auction_assign(jnp.asarray(cost), jnp.asarray(num_gt), eps_phases=phases))
    got = thung.auction_assign(torch.from_numpy(cost), torch.from_numpy(np.asarray(num_gt)), eps_phases=phases)
    assert got.dtype == torch.int32 and got.shape == cost.shape[:-1]
    np.testing.assert_array_equal(got.numpy(), want)

    # complete and eps-optimal against scipy, problem by problem
    lead = cost.shape[:-2]
    ngs = np.broadcast_to(num_gt, lead)
    for idx in np.ndindex(*lead):
        c, a, ng = cost[idx], want[idx], int(ngs[idx])
        assigned = a[a >= 0]
        assert len(assigned) == ng and len(set(assigned.tolist())) == ng and (assigned < ng).all()
        if ng == 0:
            continue
        rows, cols = linear_sum_assignment(c[:, :ng])
        ref = np.full(c.shape[0], -1)
        ref[rows] = cols
        eps = EPS_REL * max(float(np.abs(c[:, :ng]).max()), 1e-6)
        assert _objective(c, a) <= _objective(c, ref) + GAP_SLACK * eps * ng, case


_FULL = 0xFFFFFFFF


def _key(v):
    """The kernel's order-preserving key of a float32, -0 keyed as +0."""
    u = int((v + np.float32(0.0)).view(np.uint32))
    return (~u & _FULL) if u & 0x80000000 else u | 0x80000000


def _unkey(k):
    return np.uint32(k & 0x7FFFFFFF if k & 0x80000000 else ~k & _FULL).view(np.float32)


def _warp_bid(ben, price, eps):
    """One warp's bid for a column of benefits ``ben`` [P] (float32): lane l
    scans rows l, l + 32, ... in order for (top, its first row, runner-up),
    then the lanes merge as the kernel's redux.sync steps do: the runner-up
    over the other rows is the largest of every lane's runner-up, the tops
    below the largest, and the largest itself where two lanes hold it.
    -> (row, bid)."""
    p = len(price)
    lanes = []
    for lane in range(32):
        top = second = np.float32(-np.inf)
        best = lane if lane < p else _FULL
        for i in range(lane, p, 32):
            v = ben[i] - price[i]
            if v > top:
                second, top, best = top, v, i
            elif v > second:
                second = v
        lanes.append((_key(top), best, _key(second)))
    # first the largest top and runner-up; then the best row, the tops
    # below the largest and how many lanes hold it
    t = max(tk for tk, _, _ in lanes)
    s_all = max(sk for _, _, sk in lanes)
    bi = min(b if tk == t else _FULL for tk, b, _ in lanes)
    t_below = max(tk if tk < t else 0 for tk, _, _ in lanes)
    tied = sum(tk == t for tk, _, _ in lanes)
    hi, lo = _unkey(t), _unkey(max(s_all, t_below, t if tied > 1 else 0))
    if not np.isfinite(lo):
        lo = hi
    return bi, (price[bi] + (hi - lo)) + eps


def _kernel_rounds(cost, ng, phases, cap=4096):
    """``auction_kernel`` of ``csrc/auction_lap.cu`` for one problem, its
    steps written out in float32 numpy scalars: (assignment [P], rounds).

    A round: the open columns with a cost (j < min(ng, G)) each bid through
    :func:`_warp_bid`; the columns without one (padded real columns and the
    dummies) bid once, as their smallest open member; each bidder takes the
    atomicMax of (key of its bid, ~column) on its row, and the one holding
    its row's maximum hands the row over (the previous owner reopens, the
    price becomes the winner's bid). Which warp scans which column, and in
    what order the atomics land, does not change the result."""
    p, g_in = cost.shape
    gr = max(0, min(ng, g_in))
    ben = np.zeros((p, p), np.float32)
    ben[:, :gr] = -cost[:, :gr]
    scale = max(np.float32(1e-6), np.abs(ben).max())
    price = np.zeros(p, np.float32)
    zero = np.zeros(p, np.float32)
    total = 0
    for eps_rel in phases:
        eps = np.float32(eps_rel) * scale
        open_ = np.ones(p, bool)
        owner = np.full(p, -1)
        r = 0
        while open_.any() and r < cap:
            bidders = [int(j) for j in np.nonzero(open_[:gr])[0]]
            const = np.nonzero(open_[gr:])[0]
            bids = [(j, *_warp_bid(ben[:, j], price, eps)) for j in bidders]
            if len(const):
                bids.append((gr + int(const[0]), *_warp_bid(zero, price, eps)))
            row_key = {}
            for j, row, b in bids:
                row_key[row] = max(row_key.get(row, 0), _key(b) << 32 | (_FULL - j))
            for j, row, b in bids:
                if row_key[row] == _key(b) << 32 | (_FULL - j):
                    prev, owner[row], price[row] = owner[row], j, b
                    open_[j] = False
                    if prev >= 0:
                        open_[prev] = True
            r += 1
        total += r
    return np.where((owner >= 0) & (owner < ng), owner, -1).astype(np.int32), total


@pytest.mark.parametrize("case", EMULATED)
def test_kernel_rounds_equal_plain(case):
    cost, num_gt, phases = CASES[case]()
    plain, rounds = thung.auction_assign_plain(torch.from_numpy(cost), torch.tensor([int(num_gt)]), phases,
                                               with_rounds=True)
    got, got_rounds = _kernel_rounds(cost, int(num_gt), phases)
    np.testing.assert_array_equal(got, plain[0].numpy())
    assert got_rounds == int(rounds[0]) > 0


def test_auction_refuses_more_columns_than_rows_and_other_impls():
    cost, ng = torch.ones(2, 5, 6), torch.tensor([3, 3])
    with pytest.raises(ValueError, match="G=6 > P=5"):
        thung.auction_assign(cost, ng)
    with pytest.raises(ValueError, match="G=6 > P=5"):
        thung.hungarian_assign(cost, ng, impl="auction")
    with pytest.raises(ValueError, match=r"expected one of \('callback', 'auction'\)"):
        thung.hungarian_assign(cost[:, :, :5], ng, impl="scipy")


def _head_preds(cfg, b, rng):
    """Random decoder outputs of ``cfg`` at batch ``b``: centres spread over
    the BEV grid, so boxes land near and far from the GTs."""
    d = cfg.model.pts_bbox_head
    n = max(d.num_mmpi, 1) * d.num_proposals
    hb, wb = bev_shape(tcfg.tiny_config())
    preds = {
        "center": np.stack([rng.uniform(0, wb, (b, n)), rng.uniform(0, hb, (b, n))], -1),
        "height": rng.normal(0, 1, (b, n, 1)),
        "dim": rng.normal(0.5, 0.5, (b, n, 3)),
        "rot": rng.normal(0, 1, (b, n, 2)),
        "vel": rng.normal(0, 1, (b, n, 2)),
        "heatmap": rng.normal(-2, 2, (b, n, d.num_classes)),
    }
    return {k: v.astype(np.float32) for k, v in preds.items()}


def test_build_targets_auction_matches_jax():
    jc = jcfg.tiny_config()
    jc = dataclasses.replace(jc, model=dataclasses.replace(
        jc.model, assigner=dataclasses.replace(jc.model.assigner, lap_impl="auction")))
    tc = tcfg.apply_overrides(tcfg.tiny_config(), {"model.assigner.lap_impl": "auction"})
    assert tc.model.assigner == tcfg.AssignerConfig(**dataclasses.asdict(jc.model.assigner))
    batch = jax_batch(jc, b=2, with_gt=True, seed=3)
    preds = _head_preds(jc, 2, np.random.default_rng(4))
    gt = [batch[k] for k in ("gt_boxes", "gt_labels", "gt_mask")]
    shape = bev_shape(tc)
    m = jc.model
    want = jax.jit(lambda pr, *g: jassign.build_targets(pr, *g, m.pts_bbox_head, m.bbox_coder, m.assigner,
                                                         shape))(preds, *gt)
    tm = tc.model
    got = tassign.build_targets({k: torch.from_numpy(v) for k, v in preds.items()},
                                *map(torch.from_numpy, gt), tm.pts_bbox_head, tm.bbox_coder, tm.assigner, shape)
    matched = got.assign >= 0
    assert int(matched.sum()) == 4 * int(batch["gt_mask"].sum())  # every GT in every layer
    for name in ("labels", "label_weights", "bbox_weights"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)), err_msg=name)
    for name in ("bbox_targets", "ious", "heatmap", "mean_iou"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(want, name)), rtol=TARGET_TOL,
                                   atol=TARGET_TOL, err_msg=name)
    # the callback path matches the same costs with scipy's optimum
    cb = tassign.build_targets({k: torch.from_numpy(v) for k, v in preds.items()}, *map(torch.from_numpy, gt),
                               tm.pts_bbox_head, tm.bbox_coder, tcfg.AssignerConfig(), shape)
    assert int((cb.assign >= 0).sum()) == int(matched.sum())


_BOXES = np.array([[0.0, 0.0], [10.0, 0.0], [20.0, 0.0], [500.0, 0.0]], np.float32)
_GTS = np.array([[0.5, 0.0], [9.0, 0.0], [9.5, 0.0], [400.5, 0.0]], np.float32)


def _random_heuristic():
    rng = np.random.default_rng(8)
    boxes = rng.uniform(-60, 60, (50, 9)).astype(np.float32)
    gts = rng.uniform(-60, 60, (20, 9)).astype(np.float32)
    return (boxes, gts, np.arange(20) < 15, rng.integers(0, 3, 50).astype(np.int32),
            rng.integers(0, 3, 20).astype(np.int32))


HEURISTIC = {  # name: (boxes, gts, mask, pred labels, gt labels)
    "nearest": (_BOXES, _GTS, np.ones(4, bool), None, None),
    "class_gated": (_BOXES, _GTS, np.ones(4, bool), np.array([0, 1, 0, 0], np.int32),
                    np.array([1, 1, 1, 1], np.int32)),
    "masked": (_BOXES, _GTS, np.zeros(4, bool), None, None),
    # two GTs exactly 1 m from pred 0 (and 3 from pred 1): gt 0 keeps it
    "tied": (np.array([[0.0, 0.0], [4.0, 0.0]], np.float32), np.array([[-1.0, 0.0], [1.0, 0.0]], np.float32),
             np.ones(2, bool), None, None),
    # the tie between gts 1 and 2 at pred 0, whose class they share; gt 0,
    # as near but of another class, goes to pred 1 of its own class
    "tied_labelled": (np.array([[0.0, 0.0], [4.0, 0.0]], np.float32),
                      np.array([[1.0, 0.0], [-1.0, 0.0], [1.0, 0.0]], np.float32), np.ones(3, bool),
                      np.array([2, 1], np.int32), np.array([1, 2, 2], np.int32)),
    "random": _random_heuristic(),
}


@pytest.mark.parametrize("case", list(HEURISTIC))
def test_heuristic_assign_matches_jax(case):
    boxes, gts, mask, pl, gl = HEURISTIC[case]
    labels = (pl, gl) if pl is not None else ()
    want = np.asarray(jassign.heuristic_assign(*map(jnp.asarray, (boxes, gts, mask) + labels)))
    got = tassign.heuristic_assign(*map(torch.from_numpy, (boxes, gts, mask) + labels))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "nearest":  # test_auction_lap.py's reading of the same case
        assert want[0] == 0 and want[1] == 2 and want[3] == 3 and want[2] == -1
    elif case == "tied":
        np.testing.assert_array_equal(want, [0, -1])
    elif case == "tied_labelled":
        np.testing.assert_array_equal(want, [1, 0])
    elif case == "random":
        assert 0 < (want >= 0).sum() < 15
