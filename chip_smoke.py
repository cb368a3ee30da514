#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

The main path is the DeepInteraction-base (``fusion_base``) eval forward
plus box decode at batch 1, at full width: 6 views of 448x800, 320 000
points, ResNet-50 + FPN, the sparse encoder on the 41x1440x1440 grid, two
MMRI layers, four MMPI blocks. Weights are random, drawn from a seed with
the recipe of ``deepinteraction_tpu/utils/testing.py::fast_init_variables``.

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build both kernels from ``deepinteraction_tpu_torch/csrc`` with nvcc;
3. TF32 off for matmuls and cuDNN convolutions (fp32 everywhere), and
   cuDNN autotuning on (its default heuristic picks FFT convolutions for
   the fp32 3x3 BEV convs, 60x slower here);
4. K1 (``subm_conv_gemm``) against its plain version at the nine conv
   shapes of one eval frame (``conv_input``, stages 0-3, ``down0-2``,
   ``conv_out``, from the synthetic batch's tables) and at a random table
   with 9 hits per row; per shape the kernel's and the plain version's
   device time, the bound and what sets it, the share of the bound, the
   launches per frame and their sum of launches x time;
5. K2 (``local_attn_fwd``) the same at [6,112,200,128] (4 launches a
   frame) and [1,180,180,128] (2), k=9;
6. the tiny config on the card against the port's CPU path (which the CPU
   tests hold to the JAX package);
7. the full slice through the kernels, with the launch counters set to 0
   just before and read just after; then once with every kernel swapped
   for its plain version, comparing the sparse encoder's BEV map and the
   MMRI outputs; then ms/frame and peak memory.

The second slice is the LiDAR-only (TransFusion-L, ``lidar_only_config``)
detector, eval and one train step, through K1's forward and its backward
kernels (d/dfeat: K1 over the inverse table; d/dW: ``subm_conv_wgrad``):

8. K1's forward, d/dfeat and d/dW against autograd of the plain version at
   the nine conv shapes of the train batch's tables and a random table
   with 9 hits per row, and two d/dW calls at stage 3 to the same bits;
   times as in phase 4, summed per train step;
9. one ``tiny_lidar_config`` train step on the card against the port's
   CPU path (which tests/test_torch_port_train.py holds to JAX);
10. full width, B=2: one eval frame + ``get_bboxes``; one train step with
    the launch counters set to 0 just before and read just after; the
    sparse encoder's gradients against a step with K1 swapped for its plain
    versions on the same matching, ReLU masks and proposal order; then
    ms/step (2 warm-ups, 5 timed) and peak memory.

The third slice is the ``fusion_base`` train step (the paper's fusion
fine-tune: image and LiDAR branches frozen, the MMRI encoder and the MMPI
blocks trained), through K1's forward and K2's forward and backward:

11. K2's backward (``local_attn_bwd``) against autograd of the plain
    version at [12,112,200,128] (4 launches a step) and [2,180,180,128]
    (2), k=9, each of dq, dk, dv within 1e-4 of its scale; times as in
    phase 5;
12. one ``tiny_config`` train step on the card against the port's CPU path
    (which tests/test_torch_port_fusion_train.py holds to JAX), as phase 9,
    the card replaying the CPU run's ReLU masks, sort orders and
    sampling positions (:func:`sample_grids`) for the gradients, at the
    fusion tolerances (FUSION_*);
13. full width, B=2: one train step with the launch counters set to 0 just
    before and read just after; the same step again from the same weights
    and seed, logging whether every trainable gradient leaf came out with
    the same bits (``F.grid_sample``'s backward sums with atomics) and, if
    not, the largest difference over a leaf's scale; every trainable
    gradient leaf against a step with K2's forward and backward swapped for
    the plain version on the same matching, ReLU masks, sort orders and
    dropout seed; then ms/step (2 warm-ups, 5 timed) and peak memory.

The fourth slice is the DeepInteraction++ (``fusion_plusplus``) eval
forward: Swin-T + FPN levels 0-1, the same LiDAR branch (K1's forward, 21
launches a frame), ``FusionTransformerPP`` (deformable attention, BEVWarp,
the polar and pillar I2P) and the V2 decoder; no K2:

14. the tiny ``tiny_pp_config`` on the card against the port's CPU path
    (which tests/test_torch_port_pp.py holds to JAX), as phase 6;
15. full width, B=1: one frame with the launch counters set to 0 just before
    and read just after (21 K1 launches, no other kernel); every output head
    against the same frame with K1 swapped for its plain version, replaying
    the kernel run's sort orders (so its proposals), within 1e-3 of scale,
    and the trunks (the BEV map, FPN levels 0-1, the neck's outputs), where
    K1's difference is not yet amplified, within 1e-4 of scale;
    then ms/frame (3 warm-ups, 10 timed) and peak memory, host-clock splits
    by module (each fenced by ``torch.cuda.synchronize()``) and a
    ``torch.profiler`` frame for K1's device time a frame and the device's
    busy share.

The fifth slice is the DeepInteraction++ train step (``fusion_plusplus``,
both branches frozen as in ``fusion_base``: Swin-T runs in train mode for
its DropPath with frozen weights, K1 forward only, 42 launches a step; the
``FusionTransformerPP`` neck, each interaction layer recomputed in the
backward, and the V2 decoder train):

16. one ``tiny_pp_config`` train step on the card against the port's CPU
    path (which tests/test_torch_port_pp_train.py holds to JAX), as phase
    12, the card replaying the CPU run's ReLU masks, sort orders, dropout
    masks (:func:`dropout_masks`: the CPU and CUDA generators draw
    differently from one seed) and deformable-attention sampling positions
    (:func:`sample_grids`), at the fusion tolerances;
17. full width and depth, B=2, nothing cut: one train step with the launch
    counters set to 0 just before and read just after (42 ``subm_conv_gemm``,
    no other kernel); the same step with K1 swapped for its plain version on
    the same matching, ReLU masks, sort orders and dropout seed, the frozen
    trunks (BEV map, FPN levels 0-1, the neck's ``pts_feat_conv``) within
    PP_TRUNK_TOL of scale; every trainable gradient leaf, logged with the
    ReLU masks and sort orders replayed and then with all replays but one
    of the MMPI blocks' boxes (:func:`block_boxes`), the sampling positions
    and the L1 residual signs (:func:`l1_signs`), logged against the
    kernels' run again with every replay (the floor), then held within
    PP_GRAD_TOL of its scale with every replay; ms/step (2 warm-ups, 5
    timed) and peak memory;
    host-clock splits by module (``profile_train.timed_step``) and a
    ``torch.profiler`` step for K1's device time and the busy share.

Record and replay of ReLU masks, sort orders, dropout masks, sampling
positions, boxes and L1 signs span the whole forward and backward (:func:`step_grads` wraps
``TrainStep.backward``), so the calls that the backward's recompute of the
++ interaction layers makes are recorded and replayed in the same order
too, and the end-of-run asserts (every recorded value used) hold.

A bound is the larger of the bytes (each input read once, each output
written once) over 3.35 TB/s and the useful operations over the peak rate
of the units the kernel multiplies on: TF32 tensor cores for every kernel
(split TF32); phase 8 also gives d/dW's bound at the fp32 CUDA-core rate,
the units it multiplied on before. The line before the
last is the kernels' JSON record, each kernel with its numbers at one
main-path shape and at every shape it was timed at; the last line is
``{"ok": true, "device": {...}}``. Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import statistics
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from deepinteraction_tpu_torch.configs import (
    fusion_base_config,
    fusion_plusplus_config,
    lidar_only_config,
    tiny_config,
    tiny_lidar_config,
    tiny_pp_config,
)
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.models import mmri_encoder, sparse_encoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops import cuda_lib
from deepinteraction_tpu_torch.ops import local_attention as la
from deepinteraction_tpu_torch.ops import sparse_conv as sc
from deepinteraction_tpu_torch.ops import subm_conv as smc
from deepinteraction_tpu_torch.ops.voxelize import voxelize
from deepinteraction_tpu_torch.profile_train import MODULES, fenced_module_times, timed_step
from deepinteraction_tpu_torch.targets import assign
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch

# K1 and K2 keep fp32 accuracy like their plain versions (split TF32 on the
# tensor cores); only the summation order differs
K1_TOL = 1e-4  # max|kernel - plain| / max|plain|
K2_TOL = 2e-5  # absolute and relative, as torch.testing.assert_close
K2_BWD_TOL = 1e-4  # max|kernel - plain| / max|plain| for each of dq, dk, dv
SLICE_TOL = 1e-3  # max|d| / max|plain| for the BEV map and MMRI outputs
# phase 15's trunks, K1 against plain: 2.7e-5 of scale on an H100 (K1's
# split-TF32 sums), before the decoder's MMPI blocks amplify it ~30x; phase
# 17 holds the train step's frozen trunks to it too
PP_TRUNK_TOL = 1e-4
TINY_RTOL, TINY_ATOL = 2e-3, 5e-4  # the golden fixtures' tolerance
# the train step's tolerance in tests/test_torch_port_train.py: losses and
# grad norm rtol 1e-3, each gradient leaf 1e-3 of its scale (a leaf whose
# gradient is 0 in exact arithmetic holds noise below 1e-8 of the largest);
# phase 17 holds the ++ step's leaves, K1 against plain, to GRAD_TOL
TRAIN_RTOL, GRAD_TOL, GRAD_NOISE = 1e-3, 1e-3, 1e-8
# the fusion model has ~30 leaves whose gradient is 0 in exact arithmetic
# (biases a softmax or a train-mode BN cancels); their fp32 noise reaches
# 8.7e-9 of the largest leaf at tiny_config (fp32 against fp64 on the CPU)
# and grows with the sums' length, so phases 12-13 and 16-17 draw the line
# at 1e-6
FUSION_GRAD_NOISE = 1e-6
# Phase 12 runs the tiny fusion step on two devices. With every ReLU mask and
# sort order replayed, the card's trunks still leave the CPU's by 1e-5 to
# 6e-5 of scale (K1's split-TF32 sums, cuDNN), and the four MMPI blocks at
# random init amplify that to ~1e-3 at the decoder's outputs (printed by
# phase 12); gradient leaves follow (1.6e-3 at worst on this card). The
# step's parity with JAX is the float64 CPU test's; here each leaf is held
# to 1e-2 of its scale, in phase 16's tiny ++ step as well
FUSION_TINY_GRAD_TOL = 1e-2
# Phase 17 holds the full ++ step's gradient leaves, K1 against plain, with
# every discrete choice replayed (ReLU masks, sort orders, the MMPI blocks'
# boxes, the sampling positions, the L1 residual signs): on an H100 the
# trunks' 4.7e-5 (pts_feat_conv) reaches 8.6e-4 of scale at the decoder's
# outputs through the frozen first decoder layer and the four MMPI blocks
# at random init, and 3.976e-3 at the worst leaf (an MMPI block's
# self-attention). The same cause as phase 12's, so its bound: 1e-2
PP_GRAD_TOL = 1e-2
# BN running statistics after one step: 1e-5 (absolute and relative), as
# tests/test_torch_port_train.py holds them; the fusion decoder's BNs sit
# four MMPI blocks deep, where two fp32 runs already differ by 1e-5 (the
# port's fp32 step against JAX's float64 one, on the CPU), so 1e-4 there
STATS_TOL, FUSION_STATS_TOL = 1e-5, 1e-4
# matched_ious is a mean IoU in [0, 1]: with random weights the matched
# boxes barely overlap (mean ~3e-5 at tiny_config), so a 1e-6 move of a box
# edge moves it by percents; it is held absolutely
IOU_ATOL = 1e-5
REPS, WARMUP, BATCH = 10, 3, 5
TRAIN_REPS, TRAIN_WARMUP = 5, 2
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and FLOP/s of the
# units each kernel multiplies on: dense TF32 on the tensor cores for K1's
# forward (so d/dfeat), d/dW and K2, which run split TF32 and are bounded over
# the useful operations, not the three TF32 products of each; fp32 on CUDA
# cores, where d/dW ran before, for comparison with earlier records
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"tf32": 495e12, "fp32": 67e12}
K1_UNITS = {"fwd": "tf32", "dgrad": "tf32", "wgrad": "tf32"}


def log(*a):
    print(*a, flush=True)


def device_time_ms(fn) -> float:
    """Device time of one call: the median over REPS samples, after WARMUP
    calls, of CUDA-event time around BATCH back-to-back calls over BATCH.
    Back to back, the host enqueues ahead of the card, so its launch
    overhead overlaps the device work instead of being timed with it."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(BATCH):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / BATCH)
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def bound(n_bytes: float, flops: float, units: str) -> dict:
    """Least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak rate of ``units``."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOP_PER_S[units] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "peak": f"{units} {PEAK_FLOP_PER_S[units] / 1e12:g} TFLOP/s"}


def k1_bound(kind: str, nbr, valid_out, kin: int, cin: int, cout: int, units: str = "") -> dict:
    """Bound of one K1 call (``fwd``, ``dgrad`` or ``wgrad``) over the
    table ``nbr`` [Ko, D]: each input read once, each output written once,
    2 * cin * cout operations per hit (i, d) of this table, at the peak of
    ``units`` (default: the kernel's own, ``K1_UNITS``)."""
    ko, taps = nbr.shape
    hits = ((nbr < kin) & valid_out[:, None]).sum().item()
    w = taps * cin * cout
    n_bytes = {
        "fwd": kin * cin + ko * taps + w + ko * cout + ko / 4,  # feat, nbr, W, out, valid
        "dgrad": ko * cout + kin * taps + w + kin * cin + kin / 4,  # dy, inv, W^T, dfeat, valid
        "wgrad": kin * cin + ko * taps + ko * cout + w,  # feat, nbr, dy, dW
    }[kind] * 4
    return bound(n_bytes, 2.0 * hits * cin * cout, units or K1_UNITS[kind])


def timing(kern, plain, bd: dict, launches: int) -> dict:
    """Kernel and plain times beside the bound, the share of the bound the
    kernel reaches, and launches x time on the path."""
    ms, plain_ms = device_time_ms(kern), device_time_ms(plain)
    return dict(ms=ms, plain_ms=plain_ms, **bd, share=bd["bound_ms"] / ms, launches=launches,
                launch_ms=launches * ms)


def timing_text(t: dict) -> str:
    return (f"kernel_ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} bound_ms={t['bound_ms']:.4f} "
            f"({t['bound_by']}, {t['peak']}) share={100 * t['share']:.1f}% launches={t['launches']} "
            f"launches*ms={t['launch_ms']:.4f}")


@contextlib.contextmanager
def plain_kernels(k1: bool = True):
    """Swap K2, and K1 unless ``k1`` is False, for their plain versions where
    the model calls them (the reference runs of phases 7, 10 and 13;
    autograd of a plain version is the plain version of its backward);
    restored on exit."""
    saved = (sparse_encoder.subm_conv_gemm, mmri_encoder.local_attn_fwd)
    if k1:
        sparse_encoder.subm_conv_gemm = lambda f, nbr, w, valid, inv=None: smc.gathered_matmul(f, nbr, w, valid)
    mmri_encoder.local_attn_fwd = la.local_attention
    try:
        yield
    finally:
        sparse_encoder.subm_conv_gemm, mmri_encoder.local_attn_fwd = saved


@contextlib.contextmanager
def relu_masks(masks: list, replay: bool):
    """Record the sign mask of every ReLU input in call order
    (``replay=False``), or apply recorded masks in that order in place of
    the signs (``replay=True``). ReLU's gradient jumps at 0: two fp32 runs
    that round one input to opposite sides of 0 differ in their gradients by
    far more than their rounding (a whole weight gradient moves), so a
    comparison of gradients replays one run's masks in the other."""
    relu = F.relu
    replayed = iter(masks)

    def record(x, inplace=False):
        masks.append(x.detach() > 0)
        return relu(x)

    def apply(x, inplace=False):
        return x * next(replayed).to(x.device, x.dtype)

    F.relu = apply if replay else record
    try:
        yield
    finally:
        F.relu = relu
    assert not replay or next(replayed, None) is None, "fewer ReLU calls than recorded masks"


@contextlib.contextmanager
def sort_orders(orders: list, replay: bool, flips: list):
    """Record the permutation of every ``torch.sort`` call in call order
    (``replay=False``), or impose recorded permutations in that order
    (``replay=True``), appending to ``flips`` each call whose own order
    differed. The decoder picks its proposals by sorting the heatmap: two
    fp32 runs that order two near-equal scores differently train different
    queries, so a comparison of gradients replays one run's orders in the
    other, as it replays its ReLU masks."""
    sort = torch.sort
    replayed = iter(orders)

    def record(x, *a, **k):
        out = sort(x, *a, **k)
        orders.append(out.indices)
        return out

    def apply(x, *a, **k):
        own = sort(x, *a, **k).indices
        idx = next(replayed).to(x.device)
        flips.append(not torch.equal(own, idx))
        dim = k.get("dim", a[0] if a else -1)
        return torch.return_types.sort((torch.gather(x, dim, idx), idx))

    torch.sort = apply if replay else record
    try:
        yield
    finally:
        torch.sort = sort
    assert not replay or next(replayed, None) is None, "fewer sort calls than recorded orders"


@contextlib.contextmanager
def dropout_masks(masks: list, replay: bool):
    """Record every ``Tensor.bernoulli_`` draw (the dropout and DropPath
    masks) in call order (``replay=False``), or fill the tensors with
    recorded draws in that order (``replay=True``). One seed gives other
    masks on the CPU's generator than on the card's, so a comparison across
    devices replays one run's masks in the other."""
    bern = torch.Tensor.bernoulli_
    replayed = iter(masks)

    def record(x, *a, **k):
        out = bern(x, *a, **k)
        masks.append(out.detach().clone())
        return out

    def apply(x, *a, **k):
        return x.copy_(next(replayed))

    torch.Tensor.bernoulli_ = apply if replay else record
    try:
        yield
    finally:
        torch.Tensor.bernoulli_ = bern
    assert not replay or next(replayed, None) is None, "fewer Bernoulli draws than recorded masks"


@contextlib.contextmanager
def sample_grids(grids: list, replay: bool):
    """Record the sampling grid of every ``F.grid_sample`` call in call
    order (``replay=False``), or sample at the recorded positions in that
    order (``replay=True``) while the gradient still flows into the run's
    own grid. Bilinear sampling is continuous, but its gradient with respect
    to the position jumps where a sample crosses a pixel edge: the
    deformable attentions' positions come from the features, so two runs
    whose features differ by rounding put a few of their millions of samples
    on either side of an edge, as they put ReLU inputs on either side of 0.
    The other samplers' grids come from the points and calibration and are
    the same in both runs."""
    sample = F.grid_sample
    replayed = iter(grids)

    def record(x, grid, *a, **k):
        grids.append(grid.detach())
        return sample(x, grid, *a, **k)

    def apply(x, grid, *a, **k):
        rec = next(replayed).to(grid.device, grid.dtype)
        return sample(x, rec + (grid - grid.detach()), *a, **k)

    F.grid_sample = apply if replay else record
    try:
        yield
    finally:
        F.grid_sample = sample
    assert not replay or next(replayed, None) is None, "fewer grid_sample calls than recorded grids"


@contextlib.contextmanager
def l1_signs(signs: list, replay: bool, flips: list):
    """Record the sign of every box residual (prediction - target) whose
    absolute value the weighted L1 loss takes, in call order
    (``replay=False``), or weight each residual by the recorded sign in
    place of its own (``replay=True``), appending to ``flips`` the number of
    weighted residuals whose own sign differed. ``|x|``'s gradient jumps at
    0 as ReLU's does: a matched query whose prediction lies within the two
    runs' difference of its target pulls the head's weights the other way
    in one run."""
    l1 = assign.weighted_l1_loss
    replayed = iter(signs)

    def record(pred, target, weights, avg_factor):
        signs.append(torch.sign((pred - target).detach()))
        return l1(pred, target, weights, avg_factor)

    def apply(pred, target, weights, avg_factor):
        rec = next(replayed).to(pred.device, pred.dtype)
        d = pred - target
        flips.append(int(((torch.sign(d.detach()) != rec) & (weights > 0)).sum()))
        return (d * rec * weights).sum() / torch.clamp(avg_factor, min=1.0)

    assign.weighted_l1_loss = apply if replay else record
    try:
        yield
    finally:
        assign.weighted_l1_loss = l1
    assert not replay or next(replayed, None) is None, "fewer L1 losses than recorded signs"


@contextlib.contextmanager
def block_boxes(head, boxes: list, replay: bool):
    """Record the boxes that each MMPI block of the decoder ``head`` decodes
    (the previous layer's predictions, which the block detaches) in call
    order (``replay=False``), or hand each block the recorded boxes in that
    order (``replay=True``). A block's on-image masks, its winning view and
    its ROI samples are all decided from those boxes: two runs whose boxes
    differ by rounding can put a query on an image in one and off it in the
    other, and that query then trains in one only. The boxes carry no
    gradient, so the replaying run's gradient paths stay its own."""
    replayed = iter(boxes)

    def hook(mod, args):
        if not replay:
            boxes.append({k: t.detach().clone() for k, t in args[1].items()})
            return None
        return (args[0], next(replayed)) + args[2:]

    blocks = [m for n, m in head.named_children() if n.startswith("mmpi") and not n.endswith("_pred")]
    handles = [m.register_forward_pre_hook(hook) for m in blocks]
    try:
        yield
    finally:
        for h in handles:
            h.remove()
    assert not replay or next(replayed, None) is None, "fewer MMPI block calls than recorded boxes"


def encoder_tables(cfg, batch, dev, capacity: int, with_inverse: bool) -> list:
    """K1's nine conv shapes in the sparse encoder, on sample 0 of ``batch``
    voxelized at ``capacity``, in the order the encoder runs them:
    [(name, nbr, inv, valid_out, kin, cin, cout, convs per sample)]; inv is
    the inverse table d/dfeat runs over (None unless ``with_inverse``)."""
    vl = cfg.model.pts_voxel_layer
    enc = cfg.model.pts_middle_encoder
    vo = voxelize(batch["points"][0], batch["points_mask"][0], voxel_size=vl.voxel_size,
                  point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
                  max_voxels=capacity)
    coords, shape = vo.coords, tuple(enc.sparse_shape)
    valid = torch.arange(coords.shape[0], device=dev) < vo.num_voxels

    def subm():
        nbr = sc.subm_neighbor_table(sc.SparseTensor(None, coords, valid, shape))
        return nbr, sc.mirror_table(nbr) if with_inverse else None

    def down(kernel, stride, pad, cap):
        oc, ov, oshape = sc.downsample_sites(coords, valid, shape, kernel, stride, pad, cap)
        snbr = sc.strided_neighbor_table(sc.SparseTensor(None, coords, valid, shape), oc, ov, kernel, stride, pad)
        return (snbr, sc.inverse_table(snbr, coords.shape[0]) if with_inverse else None, ov), (oc, ov, oshape)

    nbr, inv = subm()
    k = coords.shape[0]
    out = [("conv_input", nbr, inv, valid, k, enc.in_channels, enc.base_channels, 1)]
    specs = enc.encoder_channels
    for i, blocks in enumerate(specs):
        ch, last = blocks[0], i == len(specs) - 1
        n_basic = len(blocks) if last else len(blocks) - 1
        out.append((f"stage{i}", nbr, inv, valid, k, ch, ch, 2 * n_basic))
        if last:
            break
        (snbr, sinv, ov), (coords, valid, shape) = down(
            (3, 3, 3), (2, 2, 2), sparse_encoder.SparseEncoder.STRIDED_PADS[i], enc.stage_capacities[i + 1])
        out.append((f"down{i}", snbr, sinv, ov, k, ch, blocks[-1], 1))
        nbr, inv = subm()
        k = coords.shape[0]
    (snbr, sinv, ov), _ = down((3, 1, 1), (2, 1, 1), (0, 0, 0), k)
    out.append(("conv_out", snbr, sinv, ov, k, specs[-1][-1], enc.output_channels, 1))
    return out


def check_k1(cfg, batch, dev, gen):
    """Phase 4: K1's forward against its plain version at the nine conv
    shapes of one eval frame (and a random table with 9 hits per row);
    times and the per-frame sum of launches x time."""
    rec = {"max_abs_err": 0.0, "shapes": []}
    cases = encoder_tables(cfg, batch, dev, cfg.model.pts_voxel_layer.max_voxels[1], False)
    # the synthetic cloud is uniform, so its stage-0 table is nearly empty
    # beyond the centre tap; time a table with 9 random hits per row too
    _, nbr0, _, valid0, k0, _, _, _ = cases[1]
    dense = torch.randint(0, k0, nbr0.shape, generator=gen, dtype=torch.int32)
    dense[torch.rand(nbr0.shape, generator=gen) >= 1 / 3] = k0
    cases.append(("random9", dense.to(dev), None, valid0, k0, 16, 16, 0))
    per_frame = 0.0
    for name, nbr, _, valid, kin, cin, cout, n in cases:
        ko, taps = nbr.shape
        hits = ((nbr < kin) & valid[:, None]).sum().item() / max(valid.sum().item(), 1)
        feats = torch.randn(kin, cin, generator=gen).to(dev)
        w = (torch.randn(taps, cin, cout, generator=gen) / (taps * cin) ** 0.5).to(dev)
        err, rel = rel_err(smc.subm_conv_gemm(feats, nbr, w, valid), smc.gathered_matmul(feats, nbr, w, valid))
        assert rel <= K1_TOL, f"K1 {name}: max rel err {rel:.3e} > {K1_TOL}"
        t = timing(lambda: smc.subm_conv_gemm(feats, nbr, w, valid), lambda: smc.gathered_matmul(feats, nbr, w, valid),
                   k1_bound("fwd", nbr, valid, kin, cin, cout), n)
        shape = f"eval {name}, K={kin}->{ko} {cin}->{cout} {taps} taps, {hits:.2f} hits/row"
        log(f"K1 subm_conv_gemm {shape}: max_abs_err={err:.3e} max_rel_err={rel:.3e} {timing_text(t)}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["shapes"].append(dict(t, shape=shape))
        per_frame += t["launch_ms"]
    log(f"K1 subm_conv_gemm per fusion_base eval frame: sum of launches*ms = {per_frame:.4f} ms")
    rec["ms_per_frame"] = per_frame
    return rec


def check_k2(dev, gen):
    """Phase 5: K2 against its plain version at the two main-path shapes;
    times and the per-frame sum of launches x time."""
    rec = {"max_abs_err": 0.0, "shapes": []}
    per_frame = 0.0
    # p2i_local and i_iml of both MMRI layers; p_iml of both
    for shape, n in (((6, 112, 200, 128), 4), ((1, 180, 180, 128), 2)):
        q, k, v = (torch.randn(shape, generator=gen).to(dev) for _ in range(3))
        out = la.local_attn_fwd(q, k, v, 9)
        ref = la.local_attention(q, k, v, 9)
        torch.testing.assert_close(out, ref, atol=K2_TOL, rtol=K2_TOL)
        err, rel = rel_err(out, ref)
        b, h, w, c = shape
        # q, k, v read and out written once; per pixel 81 taps x (dot + axpy)
        t = timing(lambda: la.local_attn_fwd(q, k, v, 9), lambda: la.local_attention(q, k, v, 9),
                   bound(4 * 4 * b * h * w * c, b * h * w * 4 * 81 * c, "tf32"), n)
        log(f"K2 local_attn_fwd {list(shape)} k=9: max_abs_err={err:.3e} max_rel_err={rel:.3e} {timing_text(t)}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["shapes"].append(dict(t, shape=f"{list(shape)} k=9"))
        per_frame += t["launch_ms"]
    log(f"K2 local_attn_fwd per fusion_base eval frame: sum of launches*ms = {per_frame:.4f} ms")
    rec["ms_per_frame"] = per_frame
    return rec


def headline(rec: dict, shape: str) -> dict:
    """A kernel's JSON record: its numbers at the main-path shape that
    starts with ``shape``, beside every shape it was timed at and its sums
    over the path."""
    top = next(t for t in rec["shapes"] if t["shape"].startswith(shape))
    return {**{k: v for k, v in rec.items() if k != "shapes"},
            **{k: top[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by", "peak", "share")},
            "shapes": rec["shapes"]}


def check_tiny(dev, cfg, name: str):
    """A tiny config on the card (kernels) vs the port's CPU path."""
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals).eval()
    init_weights(model, seed=7)
    np_batch = make_synthetic_batch(cfg, b=1, seed=7)
    ref = model(to_torch(np_batch, "cpu"))
    got = model.to(dev)(to_torch(np_batch, dev))
    for key, want in ref.items():
        g = got[key].cpu()
        if key in ("query_labels", "on_image_masks"):
            assert torch.equal(g, want), key
        else:
            torch.testing.assert_close(g, want, rtol=TINY_RTOL, atol=TINY_ATOL, msg=key)
    log(f"{name} slice on the card == CPU path on {len(ref)} heads "
        f"(rtol {TINY_RTOL}, atol {TINY_ATOL}; labels and masks exact)")


def train_tables(cfg, batch, dev, gen):
    """K1's tables for sample 0 of the train batch (capacity ``max_voxels[0]``):
    the nine conv shapes of :func:`encoder_tables` with their inverse tables
    and a random table with 9 hits per row in which each input row is
    reached at most once per tap."""
    cases = encoder_tables(cfg, batch, dev, cfg.model.pts_voxel_layer.max_voxels[0], True)
    k0 = cases[0][4]
    perm = torch.stack([torch.randperm(k0, generator=gen) for _ in range(27)], 1).int()
    rnd = torch.where(torch.rand(k0, 27, generator=gen) < 1 / 3, perm, k0).to(dev)
    every = torch.ones(k0, dtype=torch.bool, device=dev)
    return cases + [("random9", rnd, sc.inverse_table(rnd, k0), every, k0, 16, 16, 0)]


def check_k1_backward(cfg, batch, dev, gen, b: int):
    """Phase 8: K1's forward, d/dfeat and d/dW against autograd of the plain
    version at every conv shape of the train step; kernel and plain times
    of the three kernels, and the per-step sums of launches x time at batch
    ``b`` (d/dfeat does not run for ``conv_input``, whose inputs are data)."""
    recs = {k: {"max_abs_err": 0.0, "shapes": []} for k in ("fwd", "dgrad", "wgrad")}
    per_step = dict.fromkeys(recs, 0.0)
    for name, nbr, inv, valid, kin, cin, cout, n in train_tables(cfg, batch, dev, gen):
        taps = nbr.shape[1]
        hits = ((nbr < kin) & valid[:, None]).float().sum().item() / max(valid.sum().item(), 1)
        f0 = torch.randn(kin, cin, generator=gen).to(dev)
        w0 = (torch.randn(taps, cin, cout, generator=gen) / (taps * cin) ** 0.5).to(dev)
        dy = torch.where(valid[:, None], torch.randn(nbr.shape[0], cout, generator=gen).to(dev), 0.0)
        res = []
        for conv in (lambda f, w: smc.subm_conv_gemm(f, nbr, w, valid, inv),
                     lambda f, w: smc.gathered_matmul(f, nbr, w, valid)):
            f, w = f0.clone().requires_grad_(True), w0.clone().requires_grad_(True)
            out = conv(f, w)
            (out * dy).sum().backward()
            res.append((out.detach(), f.grad, w.grad))
        torch.cuda.synchronize()
        shape = f"train {name}, K={kin}->{nbr.shape[0]} {cin}->{cout} {taps} taps, {hits:.2f} hits/row"
        msg = [f"K1 backward {shape}:"]
        wt = w0.transpose(1, 2).contiguous()
        every = torch.ones(kin, dtype=torch.bool, device=dev)
        timed = {
            "fwd": (lambda: smc.subm_conv_gemm(f0, nbr, w0, valid), lambda: smc.gathered_matmul(f0, nbr, w0, valid)),
            "dgrad": (lambda: smc.subm_conv_dgrad(dy, inv, w0), lambda: smc.gathered_matmul(dy, inv, wt, every)),
            "wgrad": (lambda: smc.subm_conv_wgrad(f0, nbr, dy), lambda: smc.gathered_wgrad(f0, nbr, dy)),
        }
        for i, kind in enumerate(("fwd", "dgrad", "wgrad")):
            got, ref = res[0][i], res[1][i]
            err, rel = rel_err(got, ref)
            assert rel <= K1_TOL, f"K1 {kind} {name}: max rel err {rel:.3e} > {K1_TOL}"
            recs[kind]["max_abs_err"] = max(recs[kind]["max_abs_err"], err)
            msg.append(f"{kind} max_abs_err={err:.3e} max_rel_err={rel:.3e}")
        if name == "stage3":
            again = [smc.subm_conv_wgrad(f0, nbr, dy) for _ in range(2)]
            assert torch.equal(*again), "K1 wgrad stage3: two calls differ"
            msg.append("wgrad two calls bit-equal")
        log(" ".join(msg))
        for kind, (kern, plain) in timed.items():
            launches = 0 if kind == "dgrad" and name == "conv_input" else n * b
            t = timing(kern, plain, k1_bound(kind, nbr, valid, kin, cin, cout), launches)
            text = f"  {kind} {timing_text(t)}"
            if kind == "wgrad":
                fp32 = k1_bound(kind, nbr, valid, kin, cin, cout, "fp32")["bound_ms"]
                t["bound_fp32_ms"], t["share_fp32"] = fp32, fp32 / t["ms"]
                text += f" (at the fp32 rate: bound_ms={fp32:.4f} share={100 * t['share_fp32']:.1f}%)"
            log(text)
            recs[kind]["shapes"].append(dict(t, shape=shape))
            per_step[kind] += t["launch_ms"]
    log(f"K1 per lidar_only train step (B={b}), sum of launches*ms: forward {per_step['fwd']:.4f} ms, "
        f"d/dfeat {per_step['dgrad']:.4f} ms (forward + d/dfeat {per_step['fwd'] + per_step['dgrad']:.4f}), "
        f"d/dW {per_step['wgrad']:.4f} ms")
    for kind, r in recs.items():
        r["ms_per_step"] = per_step[kind]
    return recs


def close_grads(got: dict, ref: dict, what: str, noise: float = GRAD_NOISE, tol: float = GRAD_TOL) -> float:
    """Every gradient leaf within ``tol`` of its scale (leaves below
    ``noise`` of the largest, which are 0 in exact arithmetic: noise on both
    sides); returns the worst ratio."""
    line = noise * max(g.abs().max().item() for g in ref.values())
    worst, bad = 0.0, []
    for name, r in ref.items():
        scale = r.abs().max().item()
        if scale < line:
            if got[name].abs().max().item() >= line:
                bad.append((float("inf"), f"{what} {name}: not ~0"))
            continue
        rel = (got[name] - r).abs().max().item() / scale
        if rel > tol:
            bad.append((rel, f"{what} {name}: gradient max rel err {rel:.3e} > {tol} (scale {scale:.3e})"))
        worst = max(worst, rel)
    bad.sort(reverse=True)
    assert not bad, f"{len(bad)} leaves: " + "; ".join(m for _, m in bad[:5])
    return worst


def step_grads(step, batch, seed, targets=None, masks=None, replay=False, orders=None, flips=None,
               drops=None, drop_replay=False, grids=None, boxes=None, signs=None, sign_flips=None):
    """One forward + loss + backward of ``step`` (no update): metrics,
    targets and {name: gradient}; ``masks``: see :func:`relu_masks`;
    ``orders``, ``flips``: see :func:`sort_orders`; ``grids``: see
    :func:`sample_grids`, ``boxes``: see :func:`block_boxes`, ``signs``,
    ``sign_flips``: see :func:`l1_signs` (all three replayed with
    ``replay``); ``drops``, ``drop_replay``: see :func:`dropout_masks`."""
    gen = torch.Generator(device=step.device).manual_seed(seed)
    with relu_masks([] if masks is None else masks, replay), contextlib.ExitStack() as stack:
        if orders is not None:
            stack.enter_context(sort_orders(orders, replay, flips))
        if drops is not None:
            stack.enter_context(dropout_masks(drops, drop_replay))
        if grids is not None:
            stack.enter_context(sample_grids(grids, replay))
        if boxes is not None:
            stack.enter_context(block_boxes(step.model.pts_bbox_head, boxes, replay))
        if signs is not None:
            stack.enter_context(l1_signs(signs, replay, sign_flips))
        metrics, targets = step.backward(batch, gen, targets)
    grads = {n: p.grad.detach().clone() for n, p in step.model.named_parameters() if p.grad is not None}
    return metrics, targets, grads


def check_tiny_train(dev, cfg, name: str, fusion: bool = False) -> list:
    """Phases 9, 12 and 16: one tiny train step on the card vs the CPU path
    (the CPU test's seed): the matching, losses and BN statistics of the
    card's own step; the grad norm and gradients of a card step that replays
    the CPU run's ReLU masks (:func:`relu_masks`), sort orders
    (:func:`sort_orders`, the matching's included) and sampling positions
    (:func:`sample_grids`), and how far that run's decoder outputs are from
    the CPU's. Both card steps replay the CPU run's dropout masks
    (:func:`dropout_masks`; none where dropout is 0)."""
    noise, stats_tol, iou_atol, grad_tol = ((FUSION_GRAD_NOISE, FUSION_STATS_TOL, IOU_ATOL, FUSION_TINY_GRAD_TOL)
                                            if fusion else (GRAD_NOISE, STATS_TOL, 0.0, GRAD_TOL))
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=3)
    card_models = [copy.deepcopy(model) for _ in range(2)]
    np_batch = make_synthetic_batch(cfg, b=2, seed=3, with_gt=True)
    cpu_masks, card_masks, cpu_orders, flips, preds, drops, cpu_grids = [], [], [], [], [], [], []
    hooks = [m.pts_bbox_head.register_forward_hook(lambda mod, a, out: preds.append(out))
             for m in (model, card_models[1])]
    ref_m, ref_t, ref_g = step_grads(TrainStep(cfg, model, 10, device="cpu"), to_torch(np_batch, "cpu"), 0,
                                     masks=cpu_masks, orders=cpu_orders, drops=drops, grids=cpu_grids)
    got_m, got_t, _ = step_grads(TrainStep(cfg, card_models[0], 10, device=dev), to_torch(np_batch, dev), 0,
                                 masks=card_masks, drops=drops, drop_replay=True)
    problems = []

    def held(check, *args, **kw):
        try:
            return check(*args, **kw)
        except AssertionError as e:
            problems.append(f"{name}: {e}")

    def same(got, k):
        a, r = (iou_atol, 0.0) if k == "matched_ious" and iou_atol else (0.0, TRAIN_RTOL)
        held(torch.testing.assert_close, got[k].cpu(), ref_m[k], rtol=r, atol=a, msg=lambda m: f"{k}: {m}")

    if not torch.equal(got_t.assign.cpu(), ref_t.assign):
        problems.append(f"{name}: the card's matching differs")
    for k in ref_m:
        if k != "grad_norm":  # a gradient: compared with the masks replayed
            same(got_m, k)
    stats_err = 0.0
    for b_name, b in model.named_buffers():
        got = card_models[0].get_buffer(b_name).cpu()
        stats_err = max(stats_err, (got - b).abs().max().item())
        held(torch.testing.assert_close, got, b, rtol=stats_tol, atol=stats_tol,
             msg=lambda m, n=b_name: f"{n}: {m}")
    relu_flips = sum((a != b.cpu()).sum().item() for a, b in zip(cpu_masks, card_masks))
    rep_m, _, got_g = step_grads(TrainStep(cfg, card_models[1], 10, device=dev), to_torch(np_batch, dev), 0,
                                 masks=cpu_masks, replay=True, orders=cpu_orders, flips=flips, drops=drops,
                                 drop_replay=True, grids=cpu_grids)
    for h in hooks:
        h.remove()
    head_div = max(rel_err(preds[1][k].detach().cpu(), v.detach())[1] for k, v in preds[0].items()
                   if v.is_floating_point())
    same(rep_m, "grad_norm")
    assert set(got_g) == set(ref_g) <= {n for n, _ in model.named_parameters()}
    worst = held(close_grads, {k: v.cpu() for k, v in got_g.items()}, ref_g, "card vs CPU", noise, grad_tol)
    log(f"{name} train step on the card vs the CPU path: matching, {len(ref_m)} metrics (rtol {TRAIN_RTOL}; "
        f"matched_ious atol {iou_atol:g}: {got_m['matched_ious'].item():.6g} vs {ref_m['matched_ious'].item():.6g}), "
        f"BN statistics ({stats_tol:g}; max abs diff {stats_err:.3e}); ReLU inputs of opposite sign: "
        f"{relu_flips} of {sum(m.numel() for m in cpu_masks)}; sort calls whose order differed: {sum(flips)} of "
        f"{len(flips)}; dropout masks replayed: {len(drops)}; sampling grids replayed: {len(cpu_grids)}; with "
        f"the CPU's ReLU masks, sort orders and sampling positions the decoder outputs within "
        f"{head_div:.3e} of scale, grad_norm (rtol {TRAIN_RTOL}) and {len(ref_g)} gradient leaves (worst "
        f"{worst if worst is not None else float('nan'):.3e} of scale, tolerance {grad_tol}); checks failed: "
        f"{len(problems)}")
    for p in problems:
        log(f"  FAILED {p}")
    return problems


def run_lidar(dev, gen):
    """Phases 8-10: the LiDAR-only slice at full width, B=2."""
    cfg = lidar_only_config()
    b = cfg.data.samples_per_device
    assert b == 2, b
    batch = to_torch(make_synthetic_batch(cfg, b=b, seed=0, with_gt=True), dev)
    k1 = check_k1_backward(cfg, batch, dev, gen, b)
    problems = check_tiny_train(dev, tiny_lidar_config(), "tiny_lidar_config")
    assert not problems, problems

    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape).to(dev)
    init_weights(model, seed=0)
    p = cfg.model.pts_bbox_head.num_proposals
    det = get_bboxes(model(batch), cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)
    for name, t in det._asdict().items():
        assert torch.isfinite(t.float()).all(), f"non-finite {name}"
    assert det.boxes.shape == (b, p, 9), det.boxes.shape
    log(f"lidar_only eval + get_bboxes, B={b}: boxes {tuple(det.boxes.shape)} finite, "
        f"score max {det.scores.max().item():.4f}")

    start = copy.deepcopy(model.state_dict())
    step = TrainStep(cfg, model, 1000, device=dev)
    for c in (smc.subm_conv_gemm, smc.subm_conv_dgrad, smc.subm_conv_wgrad):
        c.launches = 0
    metrics, targets, grads = step_grads(step, batch, seed=1)
    torch.cuda.synchronize()
    launches = {"subm_conv_gemm": smc.subm_conv_gemm.launches, "subm_conv_dgrad": smc.subm_conv_dgrad.launches,
                "subm_conv_wgrad": smc.subm_conv_wgrad.launches}
    log(f"lidar_only train step launches, B={b}: {launches}")
    assert launches == {"subm_conv_gemm": 21 * b, "subm_conv_dgrad": 20 * b, "subm_conv_wgrad": 21 * b}, launches
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), f"non-finite {k}"
    assert set(grads) == {n for n, q in model.named_parameters() if q.requires_grad}, "a parameter has no gradient"
    assert all(torch.isfinite(g).all() for g in grads.values())
    log("lidar_only train step: " + " ".join(f"{k}={v.item():.6g}" for k, v in metrics.items())
        + f"; {len(grads)} of {len(list(model.parameters()))} parameters have finite gradients")

    # K1 swapped for its plain versions, from the same weights, statistics,
    # dropout masks and matching; the kernels' run records its ReLU masks
    # and sort orders (so its proposals) and the plain run replays them
    masks, orders, flips = [], [], []
    model.load_state_dict(start)
    metrics, _, grads = step_grads(step, batch, seed=1, targets=targets, masks=masks, orders=orders)
    model.load_state_dict(start)
    with plain_kernels():
        plain_metrics, _, plain_grads = step_grads(step, batch, seed=1, targets=targets, masks=masks, replay=True,
                                                   orders=orders, flips=flips)
    del masks, orders
    enc = [n for n in grads if n.startswith("pts_middle_encoder.")]
    worst = close_grads({n: grads[n] for n in enc}, {n: plain_grads[n] for n in enc}, "K1 vs plain")
    err, rel = rel_err(metrics["loss_total"], plain_metrics["loss_total"])
    log(f"lidar_only train step, K1 kernels vs plain: {len(enc)} sparse-encoder gradient leaves, worst "
        f"{worst:.3e} of scale (tolerance {GRAD_TOL}); loss_total rel diff {rel:.3e}; sort calls whose own "
        f"order differed from the kernel run's: {sum(flips)} of {len(flips)}")

    model.load_state_dict(start)
    for _ in range(TRAIN_WARMUP):
        step(batch, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_REPS):
        t0 = time.perf_counter()
        m = step(batch, torch.Generator(device=dev).manual_seed(3 + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert torch.isfinite(m["loss_total"]), m
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"lidar_only train step, B={b}: ms/step median {statistics.median(times):.3f} "
        f"(min {min(times):.3f}, max {max(times):.3f}, {TRAIN_REPS} steps after {TRAIN_WARMUP} warm-ups); "
        f"peak memory allocated {peak / 2**30:.3f} GiB")
    return k1, launches


def check_k2_backward(dev, gen):
    """Phase 11: K2's backward against autograd of the plain version at the
    two shapes of the fusion_base train step (B=2); times and the per-step
    sum of launches x time."""
    rec = {"max_abs_err": 0.0, "shapes": []}
    per_step = 0.0
    # p2i_local and i_iml of both MMRI layers over 2 x 6 views; p_iml of both
    for shape, n in (((12, 112, 200, 128), 4), ((2, 180, 180, 128), 2)):
        q, k, v, dout = (torch.randn(shape, generator=gen).to(dev) for _ in range(4))
        got = la.local_attn_bwd(q, k, v, dout, 9)
        ref = la.local_attention_bwd(q, k, v, dout, 9)
        msg = []
        for name, a, r in zip("qkv", got, ref):
            err, rel = rel_err(a, r)
            assert rel <= K2_BWD_TOL, f"K2 backward d{name} {list(shape)}: max rel err {rel:.3e} > {K2_BWD_TOL}"
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            msg.append(f"d{name} max_abs_err={err:.3e} max_rel_err={rel:.3e}")
        b, h, w, c = shape
        # q, k, v, dO read and dq, dk, dv written once; per pixel 81 taps x
        # (q.k, dO.v, dS k, dS q, P dO), 2 C operations each, on the TF32
        # tensor cores (split TF32)
        t = timing(lambda: la.local_attn_bwd(q, k, v, dout, 9), lambda: la.local_attention_bwd(q, k, v, dout, 9),
                   bound(7 * 4 * b * h * w * c, b * h * w * 10 * 81 * c, "tf32"), n)
        log(f"K2 local_attn_bwd {list(shape)} k=9: {' '.join(msg)} {timing_text(t)}")
        rec["shapes"].append(dict(t, shape=f"{list(shape)} k=9"))
        per_step += t["launch_ms"]
        del q, k, v, dout, got, ref
    log(f"K2 local_attn_bwd per fusion_base train step (B=2): sum of launches*ms = {per_step:.4f} ms")
    rec["ms_per_step"] = per_step
    return rec


def run_fusion_train(dev, gen):
    """Phases 11-13: the fusion_base train step at full width, B=2."""
    k2b = check_k2_backward(dev, gen)
    # phase 12's failures are raised after phase 13 has run and reported
    problems = check_tiny_train(dev, tiny_config(), "tiny_config", fusion=True)

    cfg = fusion_base_config()
    b = cfg.data.samples_per_device
    assert b == 2, b
    batch = to_torch(make_synthetic_batch(cfg, b=b, seed=0, with_gt=True), dev)
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape).to(dev)
    init_weights(model, seed=0)
    start = copy.deepcopy(model.state_dict())
    step = TrainStep(cfg, model, 1000, device=dev)
    counted = (smc.subm_conv_gemm, smc.subm_conv_dgrad, smc.subm_conv_wgrad, la.local_attn_fwd, la.local_attn_bwd)
    for c in counted:
        c.launches = 0
    metrics, targets, grads = step_grads(step, batch, seed=1)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counted}
    log(f"fusion_base train step launches, B={b}: {launches}")
    # the LiDAR branch is frozen: K1 runs forward only (21 convs a sample);
    # K2 runs 3 blocks in each MMRI layer (6), forward and backward
    k2n = 3 * cfg.model.imgpts_neck.num_layers
    assert launches == {"subm_conv_gemm": 21 * b, "subm_conv_dgrad": 0, "subm_conv_wgrad": 0,
                        "local_attn_fwd": k2n, "local_attn_bwd": k2n}, launches
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), f"non-finite {k}"
    trainable = {n for n, q in model.named_parameters() if q.requires_grad}
    assert set(grads) == trainable, sorted(trainable ^ set(grads))[:10]
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert not any(n.startswith(("img_backbone.", "pts_middle_encoder.", "pts_backbone.")) for n in grads)
    log("fusion_base train step: " + " ".join(f"{k}={v.item():.6g}" for k, v in metrics.items())
        + f"; {len(grads)} trainable of {len(list(model.parameters()))} parameters have finite gradients")

    # the whole step again (matching included) from the same weights and
    # seed: logged, not asserted, since F.grid_sample's backward sums with
    # atomics (the port's own kernels add in a fixed order). Leaves below
    # FUSION_GRAD_NOISE of the largest are 0 in exact arithmetic: their
    # differences are given over the largest leaf's scale
    model.load_state_dict(start)
    _, _, again = step_grads(step, batch, seed=1)
    largest = max(g.abs().max().item() for g in grads.values())
    line = FUSION_GRAD_NOISE * largest
    moved = [n for n, g in grads.items() if not torch.equal(again[n], g)]
    real = sorted(((rel_err(again[n], grads[n])[1], n) for n in moved if grads[n].abs().max().item() >= line),
                  reverse=True)
    noise = max([(again[n] - grads[n]).abs().max().item() / largest for n in moved
                 if grads[n].abs().max().item() < line], default=0.0)
    log(f"fusion_base train step run twice from one seed: {len(grads) - len(moved)} of {len(grads)} trainable "
        f"gradient leaves bit-equal; {len(real)} leaves above {FUSION_GRAD_NOISE:g} of the largest differ, by at "
        f"most {real[0][0] if real else 0.0:.3e} of their scale ("
        + ", ".join(f"{n} {r:.3e}" for r, n in real[:3]) + f"); {len(moved) - len(real)} leaves that are ~0 "
        f"differ by at most {noise:.3e} of the largest leaf's scale")
    del again

    # K2's forward and backward swapped for the plain version (K1 stays),
    # from the same weights, statistics, dropout seed and matching; the
    # kernels' run records its ReLU masks and sort orders, the plain run
    # replays them
    masks, orders, flips = [], [], []
    model.load_state_dict(start)
    metrics, _, grads = step_grads(step, batch, seed=1, targets=targets, masks=masks, orders=orders)
    model.load_state_dict(start)
    with plain_kernels(k1=False):
        plain_metrics, _, plain_grads = step_grads(step, batch, seed=1, targets=targets, masks=masks, replay=True,
                                                   orders=orders, flips=flips)
    del masks, orders
    worst = close_grads(grads, plain_grads, "K2 vs plain", FUSION_GRAD_NOISE)
    line = FUSION_GRAD_NOISE * max(g.abs().max().item() for g in plain_grads.values())
    small = sum(g.abs().max().item() < line for g in plain_grads.values())
    err, rel = rel_err(metrics["loss_total"], plain_metrics["loss_total"])
    log(f"fusion_base train step, K2 kernels vs plain: {len(grads)} trainable gradient leaves (MMRI encoder, "
        f"MMPI blocks, image heatmap head), worst {worst:.3e} of scale (tolerance {GRAD_TOL}; {small} leaves "
        f"below {FUSION_GRAD_NOISE:g} of the largest held as ~0); loss_total rel "
        f"diff {rel:.3e}; sort calls whose own order differed from the kernel run's: {sum(flips)} of {len(flips)}")
    del grads, plain_grads

    model.load_state_dict(start)
    for _ in range(TRAIN_WARMUP):
        step(batch, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_REPS):
        t0 = time.perf_counter()
        m = step(batch, torch.Generator(device=dev).manual_seed(3 + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert torch.isfinite(m["loss_total"]), m
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"fusion_base train step, B={b}: ms/step median {statistics.median(times):.3f} "
        f"(min {min(times):.3f}, max {max(times):.3f}, {TRAIN_REPS} steps after {TRAIN_WARMUP} warm-ups); "
        f"peak memory allocated {peak / 2**30:.3f} GiB")
    assert not problems, problems
    return k2b, launches


def run_slice(dev, gen):
    cfg = fusion_base_config()
    p = cfg.test_num_proposals
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, p).to(dev).eval()
    init_weights(model, seed=0)
    batch = to_torch(make_synthetic_batch(cfg, b=1, seed=0), dev)
    captured = {}
    hooks = [
        model.pts_middle_encoder.register_forward_hook(lambda m, a, o: captured.__setitem__("bev", o)),
        model.imgpts_neck.register_forward_hook(lambda m, a, o: captured.__setitem__("mmri", o)),
    ]

    k1 = check_k1(cfg, batch, dev, gen)
    k2 = check_k2(dev, gen)
    check_tiny(dev, tiny_config(), "tiny_config")

    smc.subm_conv_gemm.launches = 0
    la.local_attn_fwd.launches = 0
    preds = model(batch)
    torch.cuda.synchronize()
    launches = {"subm_conv_gemm": smc.subm_conv_gemm.launches, "local_attn_fwd": la.local_attn_fwd.launches}
    log(f"main path launches per frame: {launches}")
    assert launches["subm_conv_gemm"] == 21, launches
    assert launches["local_attn_fwd"] == 6, launches
    kern = {k: captured[k] for k in captured}

    det = get_bboxes(preds, cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)
    for name, t in list(preds.items()) + list(det._asdict().items()):
        assert torch.isfinite(t.float()).all(), f"non-finite {name}"
    assert det.boxes.shape == (1, p, 9) and preds["heatmap"].shape == (1, 4 * p, 10)
    log(f"detections: boxes {tuple(det.boxes.shape)} finite, kept {int(det.keep.sum())}, "
        f"score max {det.scores.max().item():.4f}")

    with plain_kernels():
        model(batch)
    torch.cuda.synchronize()
    plain = captured
    err, rel = rel_err(kern["bev"], plain["bev"])
    log(f"slice sparse-encoder BEV {tuple(kern['bev'].shape)}: kernels vs plain max_abs_err={err:.3e} max_rel_err={rel:.3e}")
    assert rel <= SLICE_TOL, rel
    (ki, (kc, kp)), (pi, (pc, pp)) = kern["mmri"], plain["mmri"]
    for name, a, b in (("img", ki, pi), ("pts_conv", kc, pc), ("pts", kp, pp)):
        err, rel = rel_err(a, b)
        log(f"slice MMRI {name} {tuple(a.shape)}: kernels vs plain max_abs_err={err:.3e} max_rel_err={rel:.3e}")
        assert rel <= SLICE_TOL, (name, rel)
    for h in hooks:
        h.remove()

    def frame():
        get_bboxes(model(batch), cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)

    for _ in range(WARMUP):
        frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"fusion_base eval + get_bboxes, B=1: ms/frame median {statistics.median(times):.3f} "
        f"(min {min(times):.3f}, max {max(times):.3f}, {REPS} runs after {WARMUP} warm-ups); "
        f"peak memory allocated {peak / 2**30:.3f} GiB")
    return k1, k2, launches


def module_splits(model, fn, names, runs: int = 3) -> dict:
    """Median host-clock ms of each module in ``names`` over ``runs`` calls
    of ``fn`` (each forward fenced by ``torch.cuda.synchronize()``), and of
    the whole call (``total``)."""
    total = []
    with fenced_module_times(model, names) as times:
        for _ in range(runs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
    return {"total": statistics.median(total), **{n: statistics.median(v) for n, v in times.items()}}


def tensors(x) -> list:
    """The tensors of a nest of lists and tuples, in order."""
    return [x] if torch.is_tensor(x) else [t for y in x for t in tensors(y)]


def run_pp(dev):
    """Phases 14-15: the fusion_plusplus eval forward, B=1, full width."""
    check_tiny(dev, tiny_pp_config(), "tiny_pp_config")
    cfg = fusion_plusplus_config()
    p = cfg.test_num_proposals
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, p).to(dev).eval()
    init_weights(model, seed=0)
    batch = to_torch(make_synthetic_batch(cfg, b=1, seed=0), dev)
    counted = (smc.subm_conv_gemm, smc.subm_conv_dgrad, smc.subm_conv_wgrad, la.local_attn_fwd, la.local_attn_bwd)

    # the trunks' outputs, compared beside the heads
    trunks = ("pts_middle_encoder", "img_neck", "imgpts_neck")
    captured = {}
    hooks = [model.get_submodule(n).register_forward_hook(lambda m, a, o, n=n: captured.__setitem__(n, o))
             for n in trunks]
    orders, flips = [], []
    for c in counted:
        c.launches = 0
    with sort_orders(orders, False, flips):
        preds = model(batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counted}
    kern = dict(captured)
    log(f"fusion_plusplus eval launches per frame: {launches}")
    assert launches == {"subm_conv_gemm": 21, "subm_conv_dgrad": 0, "subm_conv_wgrad": 0,
                        "local_attn_fwd": 0, "local_attn_bwd": 0}, launches
    det = get_bboxes(preds, cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)
    for name, t in list(preds.items()) + list(det._asdict().items()):
        assert torch.isfinite(t.float()).all(), f"non-finite {name}"
    n_mmpi = cfg.model.pts_bbox_head.num_mmpi
    assert det.boxes.shape == (1, p, 9) and preds["heatmap"].shape == (1, n_mmpi * p, 10)
    assert preds["on_image_masks"].shape == (n_mmpi, 1, p)
    log(f"fusion_plusplus detections: boxes {tuple(det.boxes.shape)} finite, kept {int(det.keep.sum())}, "
        f"score max {det.scores.max().item():.4f}; queries on an image after each MMPI layer: "
        f"{preds['on_image_masks'].sum((1, 2)).tolist()} of {p}")

    # K1 swapped for its plain version, replaying the kernel run's sort
    # orders (the proposals are a sort of the heatmap)
    with plain_kernels(), sort_orders(orders, True, flips):
        plain = model(batch)
    torch.cuda.synchronize()
    for h in hooks:
        h.remove()
    del orders
    # the trunks (the sparse encoder's BEV map, FPN levels 0-1, the neck's
    # three outputs) and each MMPI layer's heads, for where a difference grows
    trunk_err = {f"{n}[{i}]": rel_err(a, b)[1] for n in trunks
                 for i, (a, b) in enumerate(zip(tensors(kern[n]), tensors(captured[n])))}
    log(f"fusion_plusplus eval, K1 kernels vs plain, trunks (max rel err, tolerance {PP_TRUNK_TOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in trunk_err.items()))
    problems = [f"trunk {k}: kernels vs plain max rel err {v:.3e} > {PP_TRUNK_TOL}"
                for k, v in trunk_err.items() if v > PP_TRUNK_TOL]
    per_head = {}
    for key, want in plain.items():
        if want.is_floating_point():
            rel = rel_err(preds[key], want)[1]
            per_head[key] = rel
            if rel > SLICE_TOL:
                problems.append(f"{key}: kernels vs plain max rel err {rel:.3e} > {SLICE_TOL}")
        elif not torch.equal(preds[key], want):
            problems.append(f"{key}: kernels vs plain differ")
    layers = list(zip(preds["heatmap"].chunk(n_mmpi, 1), plain["heatmap"].chunk(n_mmpi, 1)))
    by_layer = [rel_err(a, b)[1] for a, b in layers]
    # how many queries carry the worst layer's difference
    a, b = layers[max(range(n_mmpi), key=by_layer.__getitem__)]
    per_query = ((a - b).abs().amax(-1) / b.abs().max())[0]
    log(f"fusion_plusplus eval, K1 kernels vs plain: {len(plain)} heads (tolerance {SLICE_TOL} of scale; "
        f"labels and on-image masks exact): " + ", ".join(f"{k} {v:.3e}" for k, v in per_head.items())
        + f"; the heatmap head by MMPI layer: {', '.join(f'{v:.3e}' for v in by_layer)} (worst layer: "
        f"{int((per_query > 1e-4).sum())} of {p} queries above 1e-4 of scale, second largest "
        f"{per_query.topk(2).values[1].item():.3e}); sort calls whose own "
        f"order differed from the kernel run's: {sum(flips)} of {len(flips)}; checks failed: {len(problems)}")
    assert not problems, problems
    del preds, plain, det, kern, captured

    def frame():
        get_bboxes(model(batch), cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)

    for _ in range(WARMUP):
        frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated(dev)
    ms = statistics.median(times)
    log(f"fusion_plusplus eval + get_bboxes, B=1: ms/frame median {ms:.3f} "
        f"(min {min(times):.3f}, max {max(times):.3f}, {REPS} runs after {WARMUP} warm-ups); "
        f"peak memory allocated {peak / 2**30:.3f} GiB")

    # host-clock splits: (label, modules whose forward it sums)
    layers = range(cfg.model.imgpts_neck.num_layers)
    groups = (
        ("Swin-T", ("img_backbone",)),
        ("FPN", ("img_neck",)),
        ("sparse encoder", ("pts_middle_encoder",)),
        ("SECOND + SECONDFPN", ("pts_backbone", "pts_neck")),
        ("FusionTransformerPP", ("imgpts_neck",)),
        ("  image layers", tuple(f"imgpts_neck.img_layer{i}" for i in layers)),
        ("  pts layers", tuple(f"imgpts_neck.pts_layer{i}" for i in layers)),
        ("    polar I2P", tuple(f"imgpts_neck.pts_layer{i}.polar_i2p" for i in layers)),
        ("    pillar I2P", tuple(f"imgpts_neck.pts_layer{i}.i2p" for i in layers)),
        ("decoder", ("pts_bbox_head",)),
    )
    split = module_splits(model, frame, [n for _, mods in groups for n in mods])
    parts = {label: sum(split[n] for n in mods) for label, mods in groups}
    top = sum(v for k, v in parts.items() if not k.startswith(" "))
    log("fusion_plusplus eval host-clock splits (median of 3 frames, each module fenced by synchronize): "
        f"frame {split['total']:.3f} ms = " + ", ".join(f"{k.strip()} {v:.3f}" for k, v in parts.items())
        + f", voxelization, pillars, get_bboxes and the rest {split['total'] - top:.3f}")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    device = k1_ms = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            dt = ev.time_range.elapsed_us() / 1e3
            device += dt
            k1_ms += dt if "subm_conv" in ev.name else 0.0
    log(f"fusion_plusplus eval under torch.profiler, one frame: window {window:.3f} ms, device time "
        f"{device:.3f} ms (busy {100 * device / window:.1f} %), K1 subm_conv_gemm device time {k1_ms:.4f} ms")
    return launches


def run_pp_train(dev):
    """Phases 16-17: the fusion_plusplus train step at full width, B=2."""
    # phase 16's failures are raised after phase 17 has run and reported
    problems = check_tiny_train(dev, tiny_pp_config(), "tiny_pp_config", fusion=True)

    cfg = fusion_plusplus_config()
    b = cfg.data.samples_per_device
    assert b == 2, b
    batch = to_torch(make_synthetic_batch(cfg, b=b, seed=0, with_gt=True), dev)
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape).to(dev)
    init_weights(model, seed=0)
    start = copy.deepcopy(model.state_dict())
    step = TrainStep(cfg, model, 1000, device=dev)
    counted = (smc.subm_conv_gemm, smc.subm_conv_dgrad, smc.subm_conv_wgrad, la.local_attn_fwd, la.local_attn_bwd)

    for c in counted:
        c.launches = 0
    metrics, targets, grads = step_grads(step, batch, seed=1)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counted}
    log(f"fusion_plusplus train step launches, B={b}: {launches}")
    # both branches frozen: K1 runs forward only, 21 convs a sample; no K2
    assert launches == {"subm_conv_gemm": 21 * b, "subm_conv_dgrad": 0, "subm_conv_wgrad": 0,
                        "local_attn_fwd": 0, "local_attn_bwd": 0}, launches
    for k, v in metrics.items():
        assert torch.isfinite(v).all(), f"non-finite {k}"
    trainable = {n for n, q in model.named_parameters() if q.requires_grad}
    assert set(grads) == trainable, sorted(trainable ^ set(grads))[:10]
    assert all(torch.isfinite(g).all() for g in grads.values())
    assert not any(n.startswith(("img_backbone.", "img_neck.", "pts_middle_encoder.", "imgpts_neck.shared_conv_pts."))
                   for n in grads)
    log("fusion_plusplus train step: " + " ".join(f"{k}={v.item():.6g}" for k, v in metrics.items())
        + f"; {len(grads)} trainable of {len(list(model.parameters()))} parameters have finite gradients")

    # K1 swapped for its plain version, from the same weights, statistics,
    # dropout seed and matching. The kernels' run records every discrete
    # choice downstream of K1's rounding: ReLU masks, sort orders, the MMPI
    # blocks' boxes (on-image masks, winning views, ROI samples), the
    # deformable attentions' sampling positions and the L1 loss's residual
    # signs. The plain run replays the first two (logged, with how many
    # on-image decisions differ), then all five (asserted). The frozen
    # trunks are compared beside the gradients: the sparse encoder's BEV
    # map, FPN levels 0-1 and the neck's pts_feat_conv
    trunks = ("pts_middle_encoder", "img_neck", "imgpts_neck.shared_conv_pts")
    captured, views = {}, []
    head = model.pts_bbox_head
    hooks = [model.get_submodule(n).register_forward_hook(lambda m, a, o, n=n: captured.__setitem__(n, o))
             for n in trunks + ("pts_bbox_head",)]
    hooks += [m.register_forward_hook(lambda m, a, o: views.append(o[1])) for n, m in head.named_children()
              if n.startswith("mmpi") and n.endswith("_img")]
    masks, orders, grids, boxes, signs = [], [], [], [], []
    model.load_state_dict(start)
    metrics, _, grads = step_grads(step, batch, seed=1, targets=targets, masks=masks, orders=orders, grids=grids,
                                   boxes=boxes, signs=signs)
    kern = {n: [t.detach().clone() for t in tensors(captured[n])] for n in trunks}
    kern_heads = captured["pts_bbox_head"]
    kern_views = views[:]
    log(f"fusion_plusplus train step, kernels' run: recorded {len(masks)} ReLU masks, {len(orders)} sort orders, "
        f"{len(boxes)} MMPI blocks' boxes, {len(grids)} sampling grids, {len(signs)} L1 residual signs")
    line = FUSION_GRAD_NOISE * max(g.abs().max().item() for g in grads.values())
    scales = sorted(g.abs().max().item() for g in grads.values())

    def plain_run(what, plain=True, flips=None, **replays):
        views.clear()
        model.load_state_dict(start)
        sign_flips = []
        with plain_kernels() if plain else contextlib.nullcontext():
            out = step_grads(step, batch, seed=1, targets=targets, masks=masks, replay=True, orders=orders,
                             flips=[] if flips is None else flips, sign_flips=sign_flips, **replays)
        torch.cuda.synchronize()
        errs = sorted(((out[2][n] - g).abs().max().item() / g.abs().max().item(), n)
                      for n, g in grads.items() if g.abs().max().item() >= line)[::-1]
        moved = sum(int((a != b).sum()) for a, b in zip(kern_views, views))
        log(f"fusion_plusplus train step, K1 kernels vs {'plain' if plain else 'kernels again'}, {what} replayed: "
            f"{sum(e > GRAD_TOL for e, _ in errs)} of {len(errs)} leaves above {GRAD_TOL} of scale, "
            f"{sum(e > PP_GRAD_TOL for e, _ in errs)} above {PP_GRAD_TOL}, worst "
            + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]) + f"; on-image winning views that differ from the "
            f"kernel run's: {moved} of {sum(v.numel() for v in views)}"
            + (f"; L1 residuals whose own sign differed: {sum(sign_flips)}" if "signs" in replays else ""))
        return out

    # what each replay holds back: without it, and the kernels' run again
    # with all of them (the floor: grid_sample's backward adds with atomics)
    replays = {"the MMPI blocks' boxes": dict(boxes=boxes), "the sampling positions": dict(grids=grids),
               "the L1 residual signs": dict(signs=signs)}
    every = {k: v for r in replays.values() for k, v in r.items()}
    plain_run("ReLU masks and sort orders")
    for left in replays:
        plain_run(f"ReLU masks, sort orders and every other replay but {left}",
                  **{k: v for name, r in replays.items() if name != left for k, v in r.items()})
    plain_run("ReLU masks, sort orders, " + ", ".join(replays), plain=False, **every)
    flips = []
    plain_metrics, _, plain_grads = plain_run("ReLU masks, sort orders, " + ", ".join(replays), flips=flips,
                                              **every)
    for h in hooks:
        h.remove()
    del masks, orders, grids, boxes, signs, replays, every, views, kern_views
    heads = {k: rel_err(captured["pts_bbox_head"][k].detach(), v.detach())[1]
             for k, v in kern_heads.items() if v.is_floating_point()}
    trunk_err = {f"{n}[{i}]": rel_err(a, p)[1] for n in trunks
                 for i, (a, p) in enumerate(zip(kern[n], tensors(captured[n])))}
    log(f"fusion_plusplus train step, K1 kernels vs plain, frozen trunks (max rel err, tolerance {PP_TRUNK_TOL}): "
        + ", ".join(f"{k} {v:.3e}" for k, v in trunk_err.items()) + "; decoder outputs (max rel err): "
        + ", ".join(f"{k} {v:.3e}" for k, v in heads.items()))
    problems += [f"trunk {k}: kernels vs plain max rel err {v:.3e} > {PP_TRUNK_TOL}"
                 for k, v in trunk_err.items() if v > PP_TRUNK_TOL]
    small = sum(v < line for v in scales)
    err, rel = rel_err(metrics["loss_total"], plain_metrics["loss_total"])
    log(f"fusion_plusplus train step, K1 kernels vs plain: {len(grads)} trainable gradient leaves held to "
        f"{PP_GRAD_TOL} of scale, {small} below {FUSION_GRAD_NOISE:g} of the largest held as ~0 (leaf scales: "
        f"largest {scales[-1]:.3e}, median {scales[len(scales) // 2]:.3e}); loss_total rel diff {rel:.3e}; sort "
        f"calls whose own order differed from the kernel run's: {sum(flips)} of {len(flips)}")
    try:
        close_grads(grads, plain_grads, "K1 vs plain", FUSION_GRAD_NOISE, PP_GRAD_TOL)
    except AssertionError as e:
        problems.append(str(e))
    del grads, plain_grads, kern, kern_heads, captured

    model.load_state_dict(start)
    for _ in range(TRAIN_WARMUP):
        step(batch, torch.Generator(device=dev).manual_seed(2))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(TRAIN_REPS):
        t0 = time.perf_counter()
        m = step(batch, torch.Generator(device=dev).manual_seed(3 + i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        assert torch.isfinite(m["loss_total"]), m
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"fusion_plusplus train step, B={b}: ms/step median {statistics.median(times):.3f} "
        f"(min {min(times):.3f}, max {max(times):.3f}, {TRAIN_REPS} steps after {TRAIN_WARMUP} warm-ups); "
        f"peak memory allocated {peak / 2**30:.3f} GiB")

    runs = [timed_step(step, batch, 100 + i, MODULES["fusion_plusplus"]) for i in range(3)]
    split = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    log("fusion_plusplus train step host-clock splits (median of 3 steps, each part fenced by synchronize): "
        + ", ".join(f"{k.strip()} {v:.3f}" for k, v in split.items()))

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(batch, torch.Generator(device=dev).manual_seed(200))
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    device = k1_ms = 0.0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA and not ev.is_user_annotation:
            dt = ev.time_range.elapsed_us() / 1e3
            device += dt
            k1_ms += dt if "subm_conv" in ev.name else 0.0
    log(f"fusion_plusplus train step under torch.profiler, one step: window {window:.3f} ms, device time "
        f"{device:.3f} ms (busy {100 * device / window:.1f} %), K1 subm_conv_gemm device time {k1_ms:.4f} ms")
    for p in problems:
        log(f"  FAILED {p}")
    assert not problems, problems
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(nvcc.stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    lib = cuda_lib.build()
    log(f"built {lib} in {time.perf_counter() - t0:.1f} s")
    cuda_lib.library()

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True

    gen = torch.Generator().manual_seed(0)
    k1_eval, k2, eval_launches = run_slice(dev, gen)
    k1, train_launches = run_lidar(dev, gen)
    k2b, fusion_launches = run_fusion_train(dev, gen)
    pp_launches = run_pp(dev)
    pp_train_launches = run_pp_train(dev)

    src = "deepinteraction_tpu_torch/csrc/subm_conv.cu"
    eval_path, train_path = "fusion_base eval, B=1", "lidar_only train step, B=2"
    fusion_path, pp_path = "fusion_base train step, B=2", "fusion_plusplus eval, B=1"
    pp_train_path = "fusion_plusplus train step, B=2"

    def by_path(name, eval_n=0):
        return {eval_path: eval_n, train_path: train_launches.get(name, 0), fusion_path: fusion_launches[name],
                pp_path: pp_launches[name], pp_train_path: pp_train_launches[name]}

    fwd = dict(k1["fwd"], shapes=k1_eval["shapes"] + k1["fwd"]["shapes"], ms_per_frame=k1_eval["ms_per_frame"],
               max_abs_err=max(k1_eval["max_abs_err"], k1["fwd"]["max_abs_err"]))
    kernels = [
        {"name": "subm_conv_gemm", "route": "cuda", "source": src,
         "replaces": "deepinteraction_tpu/ops/sparse_conv_banded.py:98", **headline(fwd, "eval stage3"),
         "launches": eval_launches["subm_conv_gemm"], "path": eval_path,
         "launches_by_path": by_path("subm_conv_gemm", eval_launches["subm_conv_gemm"]), "library_ms": None},
        {"name": "subm_conv_dgrad", "route": "cuda", "source": src,
         "replaces": "deepinteraction_tpu/ops/sparse_conv_banded.py:227", **headline(k1["dgrad"], "train stage3"),
         "launches": train_launches["subm_conv_dgrad"], "path": train_path,
         "launches_by_path": by_path("subm_conv_dgrad"), "library_ms": None},
        {"name": "subm_conv_wgrad", "route": "cuda", "source": src,
         "replaces": "deepinteraction_tpu/ops/sparse_conv_banded.py:234", **headline(k1["wgrad"], "train stage3"),
         "launches": train_launches["subm_conv_wgrad"], "path": train_path,
         "launches_by_path": by_path("subm_conv_wgrad"), "library_ms": None},
        {"name": "local_attn_fwd", "route": "cuda",
         "source": "deepinteraction_tpu_torch/csrc/local_attention.cu",
         "replaces": "deepinteraction_tpu/ops/local_attention_pallas.py:58", **headline(k2, "[6, 112, 200, 128]"),
         "launches": eval_launches["local_attn_fwd"], "path": eval_path,
         "launches_by_path": by_path("local_attn_fwd", eval_launches["local_attn_fwd"]), "library_ms": None},
        {"name": "local_attn_bwd", "route": "cuda",
         "source": "deepinteraction_tpu_torch/csrc/local_attention.cu",
         "replaces": "deepinteraction_tpu/ops/local_attention_pallas.py:162", **headline(k2b, "[12, 112, 200, 128]"),
         "launches": fusion_launches["local_attn_bwd"], "path": fusion_path,
         "launches_by_path": by_path("local_attn_bwd"), "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
