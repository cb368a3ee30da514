#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU.

The main path is the DeepInteraction-base (``fusion_base``) eval forward
plus box decode at batch 1, at full width: 6 views of 448x800, 320 000
points, ResNet-50 + FPN, the sparse encoder on the 41x1440x1440 grid, two
MMRI layers, four MMPI blocks. Weights are random, drawn from a seed with
the recipe of ``deepinteraction_tpu/utils/testing.py::fast_init_variables``.

Phases, in order; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch, CUDA and nvcc;
2. build both kernels from ``deepinteraction_tpu_torch/csrc`` with nvcc, and
   the nvJPEG binding (``csrc/jpeg.cpp``) beside them;
3. TF32 off for matmuls and cuDNN convolutions (fp32 everywhere), and
   cuDNN autotuning on (its default heuristic picks FFT convolutions for
   the fp32 3x3 BEV convs, 60x slower here): ``cuda_lib.fp32_numerics``,
   which the eval CLI calls itself;
4. K1 (``subm_conv_gemm``) against its plain version at the nine conv
   shapes of one eval frame (``conv_input``, stages 0-3, ``down0-2``,
   ``conv_out``, from the synthetic batch's tables) and at a random table
   with 9 hits per row; per shape the kernel's and the plain version's
   device time, the bound and what sets it, the share of the bound, the
   launches per frame and their sum of launches x time;
5. K2 (``local_attn_fwd``) the same at [6,112,200,128] (4 launches a
   frame) and [1,180,180,128] (2), k=9, and at the B=2 shapes
   [12,112,200,128] and [2,180,180,128] (4 and 2 a batch: the eval CLI of
   phase 19 and the fusion train step of phase 13);
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

The sixth path is the evaluation entry point, ``python -m
deepinteraction_tpu_torch.tools.test`` (called as ``main(argv)``), on
``fusion_base`` at full width and depth with the CLI's own batch (2), over
a realistic nuScenes tree written on the card (``utils/
synthetic_nuscenes.py``: 3 scenes x 3 samples, all in val, so 9 frames and
a padded last batch; 6 cameras of 1600x900 JPEG, 9 sweeps over 3 LiDAR
spins a sample), with weights random from seed 0 saved as a port
checkpoint and loaded through ``--checkpoint``:

18. the card's JPEG decode (``ops/jpeg.py``: nvJPEG's YCbCr planes, from
    its own library built beside the kernels, then libjpeg's chroma
    upsampling and colour conversion) against libjpeg's pixels of the
    committed fixtures within JPEG_BOUNDS: 4:2:0 at 96x64 and 97x65
    (partial MCUs), the 97x65 one at 4:4:4, and a flat-block 4:2:0 one
    whose DC-only blocks every IDCT decodes exactly, so it must match
    exactly; one encode and decode of a frame's view at quality 95 above
    JPEG_PSNR_DB; the card's image stage against the CPU's on the same
    decoded pixels (1e-5); the decode time of a frame's six views;
19. the CLI plain, in this process with the fp32 settings first reset to
    PyTorch's defaults (the CLI sets them itself) and the launch counters
    set to 0 just before and read just after (21 K1 launches a sample, 6
    K2 a batch); its first batch bit for bit against the in-memory model,
    and against the plain-kernel forward with the sort orders replayed
    (1e-3 of scale, labels and keep exact); the CLI with ``nms_type=circle``
    and ``rotate``, its keep masks against the card's NMS of the in-memory
    boxes, and the card's NMS against the CPU's on the same boxes (the
    CLI's and a crowded set); the CLI with ``--tta``; these in-process runs
    load in the main process (``--num-workers 0``: spawned workers would
    import this script). Then the CLI as a user runs it, ``python -m
    deepinteraction_tpu_torch.tools.test`` in a process of its own with its
    4 loader workers, its frames against the in-process run's (1e-3 of
    scale): fps, ms/frame split into loader wait, decode, forward and
    post-processing, the whole run's and the steady peak memory, and the
    metrics. The tree and the checkpoint stay for phases 20-22; the
    directory is removed when the script ends.

The seventh path is training and data preparation from the command line:
each CLI runs as a user runs it, ``python -m deepinteraction_tpu_torch.
tools.<cli>`` in a process of its own with its own loader workers, and
prints its kernel launches (the process's counters) in its last line:

20. ``tools.create_data synthetic --profile realistic --gt-database
    --export-2d`` on the card: 7 scenes x 3 samples (``TRAIN_TREE``), the
    writer's last 6 scenes val, so 3 train samples, which CBGS draws into 9
    ``fusion_base`` steps at B=2, and 18 val frames; its seconds, sample
    counts, GT-database entries by class (every class drawn in the train
    split has some) and 2D annotation counts;
21. ``tools.train`` over that tree at full width and depth, B=2: (a)
    ``lidar_only`` for one epoch with ``--profile-steps 2`` (its trace
    exists); (b) ``fusion_base`` for one epoch from ``--load-from`` phase
    19's checkpoint with ``--eval-infos`` the val pkl; (c) the same again
    with ``--resume-from`` (b)'s checkpoints and ``optim.total_epochs=2``:
    it starts at (b)'s last step and writes epoch 1's lines. Each run's
    ``train_log.jsonl``, ``eval_log.jsonl`` and ``config.json`` read back:
    every loss finite, the log keys the train step's metric names plus
    TRAIN_LOG_EXTRA, ``tools/analyze_logs.py cal_train_time`` reads the
    log; ms/step (the median of the logged ``time`` after the first 2
    steps), ``data_time``, the first step's seconds and peak memory; the
    launches: K1's forward, d/dfeat and d/dW at phase 10's counts a step on
    ``lidar_only``, K1's forward and K2's forward and backward at phase 13's
    on ``fusion_base``, and phase 19's a batch in its evaluations;
22. ``tools.benchmark fusion_base`` with ``--synthetic --batch 1``,
    ``--synthetic --train --batch 2`` and ``--infos`` the val pkl ``--batch
    1``, each ``--samples 10 --warmup 3``: its JSON line, its launches
    (K1 21 a sample, K2 6 a batch, and 6 backward a train step), and its
    numbers beside phases 7 and 13 (logged: the host moves them 20-40 %).

The eighth path is data parallelism under ``torchrun`` and the eval-side
tools (23: ``tools.train`` and ``tools.test fusion_base`` under ``python -m
torch.distributed.run --standalone --nproc-per-node 1``; 24: ``misc_tools
fuse_conv_bn``, the eval CLI on the folded checkpoint, ``tools.ensemble``).
The ninth is the rest of the host side:

25. the native sweep reader (``data/native``, built with g++ beside the
    kernels) against its float32 numpy version on every sample of phase
    19's val tree, within NATIVE_TOL, ms a sample for each; the six image
    transforms of ``data/extra_transforms.py`` on one sample's six
    1600x900 views decoded by nvJPEG, on the card against the CPU within
    TRANSFORM_TOL levels, ms a sample on the card;
26. the tools, each as ``python -m deepinteraction_tpu_torch.tools.<cli>``
    in a process of its own: ``get_flops tiny`` on the CPU and on the card
    (equal parameters and FLOPs), ``get_flops`` on the card for
    ``fusion_base`` (eval and ``--train``), ``fusion_plusplus`` and
    ``lidar_only --train``; ``trace_model fusion_base --iters 2`` and
    ``analyze_trace`` over its trace: K1 and K2 launches a run at phase 7's
    counts (21 and 6), device ms a run, the busy share, the top categories
    and scopes.

The tenth is the JAX package's shipped defaults (``levers.py``): every
phase above builds its models with ``EvalLevers.from_env()``, so they run
nearest top-2-view I2P, the top-2-view BEVWarp scatter and, in ++ eval,
MSDA's top-k points, as the JAX package does by default. The two Pallas
kernels' bf16 numerics are the exception: phases 4-28 run with
FP32_KERNELS (``DI_SPARSE_IMPL=gather DI_LOCATT_MXU=f32``, set by
``main()`` and inherited by every CLI they start), so they hold the fp32
kernels and the paths through them at the tolerances of the slices that
ported them; phase 29 runs the bf16 defaults. Then:

27. with no ``DI_*`` variable set but FP32_KERNELS, the ``fusion_base`` eval forward at full
    width, B=1, on phase 19's first realistic frame, from phase 19's
    checkpoint: K1 and K2 launches (21 and 6), every head against the same
    frame with both kernels swapped for their plain versions under the same
    settings, sort orders replayed (SLICE_TOL of scale, labels and masks
    exact); how many pillars and points three or more views see; layer 0's
    I2P output at top-2 views against all views over the pillars at most
    two views see, and with the 8-key dedupe against nearest over the
    pillars whose views hold at most 8 distinct pixels (LEVER_TOL of
    scale); ms/frame and peak memory at the defaults, at parity, with the
    dedupe and with dense bf16, and the heads' deltas (logged); the ++
    frame at the defaults (joint top-4 MSDA; 21 K1 launches) against
    parity, ms/frame and the heads' deltas; the tiny model at 6 views with
    the dedupe and the lite depth fill, card against the CPU path; ``python
    -m deepinteraction_tpu_torch.tools.gate_eval fusion_base --gates parity
    default`` on phase 19's tree and checkpoint, its tables printed.

The eleventh is the JAX package's on-device matching (``model.assigner.
lap_impl=auction``, ``ops/hungarian.py``) and its bf16 I2P keys
(``DI_I2P_DTYPE``):

28. the auction kernel (``csrc/auction_lap.cu``) on the [2, 4, 200, 200]
    costs and ``num_gt`` of the ``fusion_base`` B=2 train step (phase 13's
    weights and batch, rebuilt) and on a uniform(0, 10) 200 x 200 cost with
    30 GTs: assignment and rounds equal to the plain version's on the card
    exactly, every valid column assigned once, the objective within
    1.1 eps G of scipy's (eps = 1e-3 of the cost scale), two calls the
    same bits; its time against the plain version and the callback path
    (``.cpu()``, scipy, ``.to(dev)``, fenced), its rounds a problem and
    its microseconds a round (the time over the largest round count);
    three ``fusion_base`` B=2 train steps with ``lap_impl=auction`` through
    ``TrainStep`` with the launch counters set to 0 just before and read
    just after (one ``auction_lap`` a step), finite losses, the first
    step's losses equal to the callback step's on the same weights and
    batch wherever the two matchings agree, how many of the 8 problems a
    step differ from scipy and by how much objective, and ms/step against
    the callback step in turns; ``tools.train fusion_base --cfg-options
    model.assigner.lap_impl=auction`` over phase 21's tree for one epoch in
    its own process (``lap_impl`` and the auction's launches in its
    summary, finite losses in its log); one realistic ``fusion_base``
    frame (phase 19's first) from phase 19's checkpoint with
    ``i2p_dtype=bfloat16`` (``EvalLevers``) beside the defaults: K1 and K2
    launches, ms/frame, peak memory and the heads' distance to the fp32
    frame.

The twelfth is the two Pallas kernels' bf16 numerics, the JAX package's
defaults in eval (``DI_SPARSE_IMPL=banded``, ``DI_LOCATT_MXU=bf16``):

29. with no ``DI_*`` variable set (FP32_KERNELS cleared): the banded
    plan's overflow flag (``sparse_conv.banded_overflow``, the JAX defaults'
    tiles and windows) of every (frame, stage) of phase 19's 9 realistic
    val frames; K1's bf16 variant (``subm_conv_gemm_bf16``, the bf16 kernel
    of ``csrc/subm_conv_bf16.cu`` after the wrapper's casts) against its
    bf16 plain version at the five submanifold conv shapes of phase 19's
    first realistic frame and at 9 random hits a row, and with
    ``per_tap=False`` (``DI_SPARSE_IMPL=s2d``) at the same shapes,
    K2's (``local_attn_fwd_bf16``, the kernel of
    ``csrc/local_attention_bf16.cu``, with its registers, shared memory and
    warps an SM) at phase 5's four shapes, within
    K1_BF16_TOL / K2_BF16_TOL of scale and BF16_MOVED_SHARE of the outputs
    moved (s2d within K1_TOL); each with its time, the fp32 kernel's at the
    same inputs, its bound at the bf16 tensor-core rate and its launches a
    frame; one conv whose plan overflows (an 8-row window) through the gated
    pair: the fp32 kernel computes it, bit for bit, ``subm_conv.taken``
    says so; then that frame through ``fusion_base`` from phase 19's
    checkpoint with the launch counters and ``taken`` set to 0 just before
    and read just after (17 bf16 launches, 4 + 17 fp32 ones, the 17 gated by
    the flags; ``taken`` as the flags say; 6 bf16 K2), each of its 17
    submanifold convs on its own inputs against the bf16 plain version and
    timed as it ran (the frame's K1 time at the defaults), its trunks
    against the same frame with both kernels swapped for their bf16 plain
    versions (flags and sort orders replayed) within BF16_TRUNK_TOL of
    scale, the heads logged, the heads' distance to the same weights with
    the fp32 kernels and ms/frame of both; the same for
    ``fusion_plusplus`` (K1 only).
30. the sparse encoder's neighbour tables (``csrc/sparse_tables.cu``) on
    phase 19's first realistic frame: the table calls of the encoder's own
    forward, recorded in eval at the defaults (with the overflow flags)
    and with gradients on as in train (with the inverses), the wrappers'
    ``.launches`` over each forward (44 and 48); each recorded table
    against its plain version on the same inputs on the same card, bit
    for bit; the recorded tables' device time, by CUDA events around
    back-to-back replays and with the host's gaps taken out (the card
    asleep while the host queues the replays), each with its share of the
    bound, and wall time (host clock to a synchronize), with the kernels
    and with the plain versions; the bound
    (bytes: a stage's map filled and scattered once, its coords read
    once, each table and site written once, at 3.35 TB/s).

Every phase that sets the launch counters to 0 and reads them counts the
six table wrappers' launches too (``TABLES``, ``table_launches``): 40 a
sample in eval, 44 where K1's bf16 variant takes the overflow flags, 48 a
sample in a train step (the strided tables' inverses), and so do the
CLIs' counters (``tools/test.py::launch_counts``).

Record and replay of ReLU masks, sort orders, dropout masks, sampling
positions, boxes and L1 signs span the whole forward and backward (:func:`step_grads` wraps
``TrainStep.backward``), so the calls that the backward's recompute of the
++ interaction layers makes are recorded and replayed in the same order
too, and the end-of-run asserts (every recorded value used) hold.

A bound is the larger of the bytes (each input read once, each output
written once) over 3.35 TB/s and the useful operations over the peak rate
of the units the kernel multiplies on: TF32 tensor cores for every fp32
kernel (split TF32), bf16 tensor cores (989 TFLOP/s) for the bf16
variants; phase 8 also gives d/dW's bound at the fp32 CUDA-core rate, the
units it multiplied on before. The line before the
last is the kernels' JSON record, each kernel with its numbers at one
main-path shape and at every shape it was timed at; the last line is
``{"ok": true, "device": {...}}``. Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
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
from deepinteraction_tpu_torch.data import DataLoader, NuScenesDataset, cbgs_indices
from deepinteraction_tpu_torch.data.nuscenes_converter import create_nuscenes_infos
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.models import mmri_encoder, sparse_encoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.data import extra_transforms as xt
from deepinteraction_tpu_torch.data import native, pipeline
from deepinteraction_tpu_torch.ops import cuda_lib, flops, hungarian, jpeg
from deepinteraction_tpu_torch.ops.images import prepare_images, to_device
from deepinteraction_tpu_torch.ops.nms import nms_keep
from deepinteraction_tpu_torch.ops import local_attention as la
from deepinteraction_tpu_torch.ops import sparse_conv as sc
from deepinteraction_tpu_torch.ops import subm_conv as smc
from deepinteraction_tpu_torch.ops.voxelize import hard_simple_vfe, voxelize, voxelize_batched
from deepinteraction_tpu_torch.profile_train import MODULES, fenced_module_times, timed_step
from deepinteraction_tpu_torch.targets import assign
from deepinteraction_tpu_torch.tools import ensemble
from deepinteraction_tpu_torch.tools import test as test_cli
from deepinteraction_tpu_torch.levers import ENV, EvalLevers
from deepinteraction_tpu_torch.train.checkpoint import load_weights, save_checkpoint
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch
from deepinteraction_tpu_torch.utils.geometry import nearest_row_ids, transform_points
from deepinteraction_tpu_torch.utils.synthetic_nuscenes import write_realistic_nuscenes

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
# phase 23: the first step under torchrun at one rank against one process,
# relative (a group of one computes the one-process arithmetic; what is
# left is the two processes' cuDNN algorithm choices); the eval CLI's boxes
# and scores, of scale (no collective in its forward)
DIST_LOSS_RTOL = 1e-4
DIST_EVAL_TOL = 1e-5
# phase 24: the eval CLI on the folded checkpoint against the unfolded one,
# of scale
FOLD_TOL = 1e-4
REPS, WARMUP, BATCH = 10, 3, 5
# Phase 30: ~0.1 s of the card's clock, asleep while the host queues BATCH
# calls of a few ms each
QUEUE_SLEEP_CYCLES = 200_000_000
# Phase 18: the card's decode against libjpeg's pixels (cv2.imread of the
# committed fixtures), max and mean abs levels. nvJPEG's own RGB output
# upsamples 4:2:0 chroma otherwise than libjpeg and read max abs 57 and 58
# levels at the red disc's chroma edges, mean abs 2.526 and 2.453 (H100,
# CUDA 12.9). The port decodes to nvJPEG's YCbCr planes and upsamples and
# converts them with libjpeg's arithmetic, which leaves the two IDCTs'
# rounding: max abs 2-3 levels, mean abs 0.026-0.033 at 4:2:0 and at 4:4:4
# alike (H100, the toolkit's nvJPEG); held to 4 and 0.1. The flat-block fixture's
# blocks are DC-only, which every IDCT decodes exactly: it must match
# exactly, and did. One encode and
# decode on the card of a 1600x900 render at quality 95 read 44.02 dB;
# held to 40 dB. The card's image stage against the CPU's on the same
# decoded pixels, after normalising: 1e-5 (it read 0)
JPEG_BOUNDS = {"jpeg_96x64": (4, 0.1), "jpeg_97x65": (4, 0.1), "jpeg_97x65_444": (4, 0.1),
               "jpeg_flat_97x65": (0, 0.0)}
JPEG_PSNR_DB = 40.0
IMAGE_STAGE_TOL = 1e-5
# Phase 25: the native sweep reader (double-precision transform, one cast)
# against its float32 numpy version, in metres: a float32 ulp at 50 m is
# 3.8e-6, and the two differ by up to two; the image transforms on the card
# against the CPU, in 0-255 levels (their only difference is the order of
# float32 operations)
NATIVE_TOL = 1e-5
TRANSFORM_TOL = 1e-3
# Phase 26: the launches a traced fusion_base eval run must show (phase 7's
# counts a frame)
TRACE_LAUNCHES = {"subm_conv_gemm": 21, "local_attn_fwd": 6}
# the sparse encoder's six table wrappers (csrc/sparse_tables.cu)
TABLES = (sc.dense_index_map, sc.subm_neighbor_table, sc.strided_neighbor_table, sc.banded_overflow,
          sc.downsample_sites, sc.inverse_table)
# every kernel wrapper's launch counter; at the default lap_impl=callback
# no path but phase 28's launches the auction, and only phase 29 runs the
# bf16 variants (FP32_KERNELS) and so the banded plan's overflow flags
COUNTED = (smc.subm_conv_gemm, smc.subm_conv_gemm_bf16, smc.subm_conv_dgrad, smc.subm_conv_wgrad, la.local_attn_fwd,
           la.local_attn_fwd_bf16, la.local_attn_bwd, hungarian.auction_lap) + TABLES
# Phase 27: top-2 views against all views over pillars that at most two
# views see, and the key dedupe against nearest over pillars whose views
# hold at most LEVER_DEDUPE distinct pixels: the same keys in another order
# (or once with a log-count bias), so rounding apart; of scale
LEVER_TOL = 1e-4
LEVER_DEDUPE = 8
# Phase 28: the auction's objective against scipy's, within GAP x eps x G
# (eps = 1e-3 of the problem's cost scale; the bound holds in exact
# arithmetic, the 10 % covers the float32 prices); the first auction train
# step's loss terms against the callback step's where the matchings agree
# (the same forward and the same targets: rounding apart)
AUCTION_EPS, AUCTION_GAP = 1e-3, 1.1
AUCTION_LOSS_RTOL = 1e-6
REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "deepinteraction_tpu_torch", "fixtures")
SMOKE_DIR = os.path.join(REPO, "work_dirs", "chip_smoke")  # listed in .gitignore; removed after the run
TRAIN_REPS, TRAIN_WARMUP = 5, 2
# Phases 4-28 hold the fp32 kernels (and every path through them) to their
# plain versions and the card to the CPU at the tolerances above, so they
# run with the two Pallas kernels' precision settings at their fp32 values
# (main() sets these variables; their CLIs inherit them). Phase 29 clears
# them: the JAX package's defaults, K1's and K2's bf16 variants in eval.
FP32_KERNELS = {"DI_SPARSE_IMPL": "gather", "DI_LOCATT_MXU": "f32"}
# Phase 29: the bf16 variants against their bf16 plain versions. Each
# multiplies the same bf16-rounded operands exactly but sums the products in
# fp32 in another order than the plain version (the tensor cores' own), so
# where the two sums fall on either side of a bf16 rounding boundary the
# rounded value (K1: one tap's product; K2: one probability) moves by one
# bf16 ulp. On an H100 that moved 5e-6 to 2.4e-3 of the outputs by more than
# 1e-6 of scale, the largest by 1.2e-3 (K1) and 1.6e-3 (K2) of scale, at the
# realistic frame's shapes (a one-ulp move of a product near the output's
# scale). Each is held to 4e-3 of scale at most, and to BF16_MOVED_SHARE of
# its outputs moved: a variant that skipped a rounding, or rounded in fp32
# where bf16 is due, would move nearly all of them. The trunks of a frame at
# the defaults (the sparse encoder's BEV map, the MMRI and ++ neck outputs)
# against the same frame with both plain versions, where such moves have
# passed through later layers and BatchNorms, read up to 2.4e-3 of scale
# there: held to BF16_TRUNK_TOL; the heads, further amplified at random
# init, are logged
K1_BF16_TOL = 4e-3
K2_BF16_TOL = 4e-3
BF16_MOVED_SHARE = 1e-2
BF16_TRUNK_TOL = 1e-2
# Phase 20's tree: 7 scenes of 3 samples, the writer's last 6 scenes val, so
# 3 train samples that CBGS draws 18 times (9 steps at B=2) and 18 val frames
TRAIN_TREE = (7, 3)
# the keys a train_log.jsonl line adds to the step's metrics (JAX's
# tools/train.py:194-214), as tests/test_torch_port_train_cli.py pins them
TRAIN_LOG_EXTRA = {"epoch", "iter", "step", "time", "data_time"}
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM3 bytes/s, and FLOP/s of the
# units each kernel multiplies on: dense TF32 on the tensor cores for K1's
# forward (so d/dfeat), d/dW and K2, which run split TF32 and are bounded over
# the useful operations, not the three TF32 products of each; fp32 on CUDA
# cores, where d/dW ran before, for comparison with earlier records
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOP_PER_S = {"tf32": 495e12, "fp32": 67e12, "bf16": 989e12}
K1_UNITS = {"fwd": "tf32", "dgrad": "tf32", "wgrad": "tf32"}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def defaults_env():
    """The JAX package's defaults for the block: FP32_KERNELS cleared from
    the environment, restored on exit."""
    saved = {k: os.environ.pop(k) for k in FP32_KERNELS if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def expect_launches(**nonzero) -> dict:
    """The launch counts of every counted kernel: ``nonzero``, 0 elsewhere."""
    assert set(nonzero) <= {c.__name__ for c in COUNTED}, nonzero
    return {c.__name__: nonzero.get(c.__name__, 0) for c in COUNTED}


def table_launches(samples: int, train: bool = False, flags: bool = False) -> dict:
    """The table wrappers' launches of ``samples`` samples through the
    sparse encoder's 4 stages. A stage: its submanifold table (the map's
    fill and scatter, a lookup), the banded plan's overflow flag where
    ``flags`` (K1's bf16 variant), the downsampling's sites (4) and strided
    table (a map, a lookup), and that table's inverse where ``train`` (2;
    the submanifold inverse is a flip, no kernel)."""
    per_stage = {"dense_index_map": 4, "subm_neighbor_table": 1, "strided_neighbor_table": 1,
                 "banded_overflow": int(flags), "downsample_sites": 4, "inverse_table": 2 * int(train)}
    return {k: 4 * v * samples for k, v in per_stage.items()}


def tables_total(counts: dict) -> int:
    """The six table wrappers' launches in ``counts``."""
    return sum(counts[c.__name__] for c in TABLES)


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
    hits = flops.k1_hits(nbr, kin, valid_out)
    w = taps * cin * cout
    n_bytes = {
        "fwd": kin * cin + ko * taps + w + ko * cout + ko / 4,  # feat, nbr, W, out, valid
        "dgrad": ko * cout + kin * taps + w + kin * cin + kin / 4,  # dy, inv, W^T, dfeat, valid
        "wgrad": kin * cin + ko * taps + ko * cout + w,  # feat, nbr, dy, dW
    }[kind] * 4
    return bound(n_bytes, flops.k1_ops(hits, cin, cout), units or K1_UNITS[kind])


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
        sparse_encoder.subm_conv_gemm = (lambda f, nbr, w, valid, inv=None, bf16=False, per_tap=True, ovf=None:
                                         smc.plain_conv(f, nbr, w, valid, bf16, per_tap, ovf))
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
    """Record the permutation of every ``torch.sort`` call of floating-point
    values in call order (``replay=False``), or impose recorded
    permutations in that order (``replay=True``), appending to ``flips``
    each call whose own order differed. The decoder picks its proposals by
    sorting the heatmap: two fp32 runs that order two near-equal scores
    differently train different queries, so a comparison of gradients
    replays one run's orders in the other, as it replays its ReLU masks.
    Sorts of integers (voxel ids, stable; the strided convs' output sites,
    values only, which the card builds with no sort) give the same result
    on every device and are left alone."""
    sort = torch.sort
    replayed = iter(orders)

    def record(x, *a, **k):
        out = sort(x, *a, **k)
        if x.is_floating_point():
            orders.append(out.indices)
        return out

    def apply(x, *a, **k):
        if not x.is_floating_point():
            return sort(x, *a, **k)
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


def check_k1(cfg, batch, dev, gen, label: str = "eval"):
    """Phase 4: K1's forward against its plain version at the nine conv
    shapes of one eval frame (and a random table with 9 hits per row);
    times and the per-frame sum of launches x time. Phase 19 runs it again
    on a frame of the realistic tree (``label``)."""
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
        shape = f"{label} {name}, K={kin}->{ko} {cin}->{cout} {taps} taps, {hits:.2f} hits/row"
        log(f"K1 subm_conv_gemm {shape}: max_abs_err={err:.3e} max_rel_err={rel:.3e} {timing_text(t)}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["shapes"].append(dict(t, shape=shape))
        per_frame += t["launch_ms"]
    log(f"K1 subm_conv_gemm per fusion_base {label} frame: sum of launches*ms = {per_frame:.4f} ms")
    rec["ms_per_frame"] = per_frame
    return rec


def check_k2(dev, gen):
    """Phase 5: K2 against its plain version at the two shapes of a B=1
    frame and the two of a B=2 batch (the eval CLI's batch, and the fusion
    train step's forward); times and the per-frame sum of launches x time
    (B=1)."""
    rec = {"max_abs_err": 0.0, "shapes": []}
    per_frame = 0.0
    # p2i_local and i_iml of both MMRI layers; p_iml of both
    for shape, n in (((6, 112, 200, 128), 4), ((1, 180, 180, 128), 2), ((12, 112, 200, 128), 4),
                     ((2, 180, 180, 128), 2)):
        q, k, v = (torch.randn(shape, generator=gen).to(dev) for _ in range(3))
        out = la.local_attn_fwd(q, k, v, 9)
        ref = la.local_attention(q, k, v, 9)
        torch.testing.assert_close(out, ref, atol=K2_TOL, rtol=K2_TOL)
        err, rel = rel_err(out, ref)
        b, h, w, c = shape
        # q, k, v read and out written once; per pixel 81 taps x (dot + axpy)
        t = timing(lambda: la.local_attn_fwd(q, k, v, 9), lambda: la.local_attention(q, k, v, 9),
                   bound(4 * 4 * b * h * w * c, flops.k2_ops(shape, 9), "tf32"), n)
        log(f"K2 local_attn_fwd {list(shape)} k=9: max_abs_err={err:.3e} max_rel_err={rel:.3e} {timing_text(t)}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        rec["shapes"].append(dict(t, shape=f"{list(shape)} k=9"))
        per_frame += t["launch_ms"] if shape[0] <= 6 else 0.0
        del q, k, v, out, ref
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


def check_tiny(dev, cfg, name: str, levers: EvalLevers | None = None):
    """A tiny config on the card (kernels) vs the port's CPU path, with
    ``levers`` (default: from the environment)."""
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals, levers=levers).eval()
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
    for c in COUNTED:
        c.launches = 0
    metrics, targets, grads = step_grads(step, batch, seed=1)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    log(f"lidar_only train step launches, B={b}: {launches}")
    assert launches == expect_launches(subm_conv_gemm=21 * b, subm_conv_dgrad=20 * b, subm_conv_wgrad=21 * b,
                                       **table_launches(b, train=True)), launches
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
    return k1, launches, {"ms": statistics.median(times), "peak_gib": peak / 2**30, "metric_keys": set(metrics)}


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
                   bound(7 * 4 * b * h * w * c, flops.k2_ops(shape, 9, backward=True), "tf32"), n)
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
    for c in COUNTED:
        c.launches = 0
    metrics, targets, grads = step_grads(step, batch, seed=1)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    log(f"fusion_base train step launches, B={b}: {launches}")
    # the LiDAR branch is frozen: K1 runs forward only (21 convs a sample);
    # K2 runs 3 blocks in each MMRI layer (6), forward and backward; the
    # tables are built with gradients on, so with their inverses
    k2n = 3 * cfg.model.imgpts_neck.num_layers
    assert launches == expect_launches(subm_conv_gemm=21 * b, local_attn_fwd=k2n, local_attn_bwd=k2n,
                                       **table_launches(b, train=True)), launches
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
    return k2b, launches, {"ms": statistics.median(times), "peak_gib": peak / 2**30, "metric_keys": set(metrics)}


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

    for c in COUNTED:
        c.launches = 0
    preds = model(batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    log(f"main path launches per frame: {launches}")
    assert launches == expect_launches(subm_conv_gemm=21, local_attn_fwd=6, **table_launches(1)), launches
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
    return k1, k2, launches, {"ms": statistics.median(times), "peak_gib": peak / 2**30}


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

    # the trunks' outputs, compared beside the heads
    trunks = ("pts_middle_encoder", "img_neck", "imgpts_neck")
    captured = {}
    hooks = [model.get_submodule(n).register_forward_hook(lambda m, a, o, n=n: captured.__setitem__(n, o))
             for n in trunks]
    orders, flips = [], []
    for c in COUNTED:
        c.launches = 0
    with sort_orders(orders, False, flips):
        preds = model(batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    kern = dict(captured)
    log(f"fusion_plusplus eval launches per frame: {launches}")
    assert launches == expect_launches(subm_conv_gemm=21, **table_launches(1)), launches
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

    for c in COUNTED:
        c.launches = 0
    metrics, targets, grads = step_grads(step, batch, seed=1)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    log(f"fusion_plusplus train step launches, B={b}: {launches}")
    # both branches frozen: K1 runs forward only, 21 convs a sample; no K2
    assert launches == expect_launches(subm_conv_gemm=21 * b, **table_launches(b, train=True)), launches
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


def check_jpeg(dev, frame_paths: list) -> dict:
    """Phase 18: nvJPEG (``ops/jpeg.py``) against libjpeg on the committed
    fixtures, one encode and decode of a frame's view, the card's image
    stage against the CPU's, and the decode time of a frame's six views."""
    want = np.load(os.path.join(FIXTURES, "jpeg_pixels.npz"))
    names = sorted(JPEG_BOUNDS)
    assert sorted(want.files) == names, want.files
    got = jpeg.decode([np.fromfile(os.path.join(FIXTURES, n + ".jpg"), np.uint8) for n in names], dev)
    torch.cuda.synchronize()
    for n, g in zip(names, got):
        ref = torch.from_numpy(want[n])
        assert tuple(g.shape) == tuple(ref.shape), (n, tuple(g.shape), tuple(ref.shape))
        d = (g.cpu().int() - ref.int()).abs()
        max_abs, mean_abs = JPEG_BOUNDS[n]
        log(f"card decode of {n}.jpg vs libjpeg (cv2.imread): max abs {d.max().item()} levels, "
            f"mean abs {d.float().mean().item():.4f}, {int((d > 2).sum())} of {d.numel()} beyond 2 "
            f"(bounds {max_abs}, {mean_abs})")
        assert d.max().item() <= max_abs and d.float().mean().item() <= mean_abs, n

    views = [np.fromfile(p, np.uint8) for p in frame_paths]
    pixels = jpeg.decode(views, dev)

    def host_ms(fn):
        for _ in range(WARMUP):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    decode_ms = host_ms(lambda: jpeg.decode(views, dev))
    encoded = jpeg.encode(pixels[0], quality=95)
    encode_ms = host_ms(lambda: jpeg.encode(pixels[0], quality=95))
    back = jpeg.decode([encoded], dev)[0]
    mse = (back.float() - pixels[0].float()).pow(2).mean().item()
    psnr = 10 * np.log10(255.0**2 / max(mse, 1e-12))
    log(f"nvJPEG, a frame's {len(views)} views of {tuple(pixels[0].shape)} ({sum(v.size for v in views)} bytes): "
        f"decode {decode_ms:.3f} ms (host clock, median of {REPS}); one view encoded at quality 95 in "
        f"{encode_ms:.3f} ms ({encoded.size} bytes), decoded again: PSNR {psnr:.2f} dB (bound {JPEG_PSNR_DB})")
    assert psnr >= JPEG_PSNR_DB, psnr

    d = fusion_base_config().data
    flips = [i % 2 == 1 for i in range(len(pixels))]
    card = prepare_images(pixels, flips, d)
    cpu = prepare_images([p.cpu() for p in pixels], flips, d)
    err = (card.cpu() - cpu).abs().max().item()
    stage_ms = host_ms(lambda: prepare_images(pixels, [False] * len(pixels), d))
    log(f"image stage (resize to {d.img_scale}, flip, normalise, pad to {d.padded_img_shape}) on the card vs "
        f"the CPU on the same decoded pixels: max abs {err:.3e} (tolerance {IMAGE_STAGE_TOL}); on the card "
        f"{stage_ms:.3f} ms for {len(pixels)} views")
    assert err <= IMAGE_STAGE_TOL, err
    return {"decode_ms": decode_ms, "encode_ms": encode_ms, "psnr_db": psnr, "stage_ms": stage_ms}


def run_eval_cli(dev, gen):
    """Phases 18-19: a realistic nuScenes tree written on the card, the JPEG
    checks, and the eval CLI (``python -m deepinteraction_tpu_torch.tools.
    test``, called as ``main(argv)``) on ``fusion_base`` at full width and
    depth with its own batch, plain, with circle and rotated NMS, and with
    double-flip TTA."""
    cfg = fusion_base_config()
    p, bsz = cfg.test_num_proposals, cfg.data.samples_per_device
    shutil.rmtree(SMOKE_DIR, ignore_errors=True)
    root = os.path.join(SMOKE_DIR, "nuscenes")
    t0 = time.perf_counter()
    write_realistic_nuscenes(root, num_scenes=3, samples_per_scene=3, num_val_scenes=3, seed=0, device=dev)
    _, val = create_nuscenes_infos(root, os.path.join(SMOKE_DIR, "infos"), version="v1.0-trainval")
    with open(val, "rb") as f:
        infos = pickle.load(f)["infos"]
    log(f"realistic nuScenes tree written on the card (3 scenes x 3 samples, 40 objects a scene, 6 cameras "
        f"of 1600x900, 9 sweeps a sample over 3 spins) and converted in {time.perf_counter() - t0:.1f} s: "
        f"{len(infos)} val frames")
    stats = check_jpeg(dev, [c["data_path"] for c in infos[0]["cams"].values()])

    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, p)
    init_weights(model, seed=0)
    ckpt = os.path.join(SMOKE_DIR, "ckpt")
    save_checkpoint(ckpt, TrainStep(cfg, model, total_steps=1, device=dev))
    model.eval()
    argv = ["fusion_base", "--infos", val, "--checkpoint", ckpt, "--num-workers", "0"]

    # PyTorch's defaults, as a user's process starts: the CLI sets fp32
    # (no TF32) and cuDNN autotuning itself
    torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark = True, False
    for c in COUNTED:
        c.launches = 0
    res = test_cli.main(argv)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, torch.backends.cudnn.benchmark)
    log(f"eval CLI from PyTorch's defaults: matmul TF32, cuDNN TF32, cuDNN autotuning = {flags}")
    assert flags == (False, False, True), flags
    n_batches = len(res["detections"])
    log(f"eval CLI, fusion_base, {res['timing']['frames']} frames in {n_batches} batches of {bsz}: "
        f"launches {launches}")
    assert res["timing"]["frames"] == len(infos) and n_batches == -(-len(infos) // bsz), res["timing"]
    assert len(infos) % bsz, "the last batch should be padded"
    # K1: 21 convs a sample; K2: 3 local attentions an MMRI layer, batched
    k2_per_batch = 3 * cfg.model.imgpts_neck.num_layers
    assert launches == expect_launches(subm_conv_gemm=21 * bsz * n_batches, local_attn_fwd=k2_per_batch * n_batches,
                                       **table_launches(bsz * n_batches)), launches
    for det in res["detections"]:
        for name, t in det._asdict().items():
            assert torch.isfinite(t.float()).all(), f"non-finite {name}"
        assert det.boxes.shape == (bsz, p, 9)

    # the first batch through the in-memory model: the checkpoint's
    # detections bit for bit, then K1 and K2 swapped for their plain
    # versions with the kernel run's sort orders replayed
    loader = DataLoader(NuScenesDataset(cfg, val, train=False), bsz, num_workers=0)
    host = next(loader.epoch(0, shuffle=False))
    host.pop("pad_count"), host.pop("token")
    batch = to_device(host, cfg.data, dev)
    # K1 at the realistic frame's tables (surfaces: far more hits a row
    # than the uniform synthetic cloud of phase 4)
    k1_real = check_k1(cfg, batch, dev, gen, label="realistic")
    orders, flips = [], []
    with sort_orders(orders, False, flips):
        det = get_bboxes(model(batch), cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)
    first = res["detections"][0]
    same = {k: torch.equal(getattr(det, k).cpu(), getattr(first, k)) for k in det._fields}
    log(f"eval CLI's first batch (checkpoint loaded by --checkpoint) vs the in-memory model: bit-equal {same}")
    assert all(same.values()), same
    with plain_kernels(), sort_orders(orders, True, flips):
        plain = get_bboxes(model(batch), cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)
    errs = {k: rel_err(getattr(first, k), getattr(plain, k).cpu())[1] for k in ("boxes", "scores")}
    exact = {k: torch.equal(getattr(first, k), getattr(plain, k).cpu()) for k in ("labels", "keep")}
    log(f"eval CLI's first batch vs the plain-kernel forward (sort orders replayed; {sum(flips)} of "
        f"{len(flips)} sorts differed): max rel err " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f" (tolerance {SLICE_TOL} of scale); exact {exact}")
    assert all(v <= SLICE_TOL for v in errs.values()) and all(exact.values()), (errs, exact)
    del plain, orders

    # NMS: the CLI with each nms_type; the card's keep masks against the
    # CPU's on the same boxes, the CLI's and a crowded set of the same
    # size (random weights need not put two boxes of one class together)
    pre = cfg.model.pts_bbox_head.pre_maxsize
    gen_nms = torch.Generator().manual_seed(1)
    crowd = det.boxes.clone()
    crowd[..., :2] = torch.randint(0, 20, crowd.shape[:2] + (2,), generator=gen_nms).to(dev) * 0.3
    crowd_labels = torch.randint(8, 10, det.labels.shape, generator=gen_nms).to(dev).to(det.labels.dtype)
    crowd_scores = torch.rand(det.scores.shape, generator=gen_nms).to(dev)
    nms = {}
    for kind in ("circle", "rotate"):
        r = test_cli.main(argv + ["--cfg-options", f"model.pts_bbox_head.nms_type={kind}"])
        for what, args in (("the CLI's first batch", (det.boxes, det.scores, det.labels, det.keep)),
                           ("a crowded set", (crowd, crowd_scores, crowd_labels, det.keep | True))):
            on_card = nms_keep(*args, kind, pre)
            on_cpu = nms_keep(*(t.cpu() for t in args), kind, pre)
            log(f"{kind} NMS on {what} (B={bsz}, {p} boxes): card keep == CPU keep "
                f"{torch.equal(on_card.cpu(), on_cpu)}; kept {int(on_cpu.sum())} of {int(args[3].sum())}")
            assert torch.equal(on_card.cpu(), on_cpu), (kind, what)
        assert int(on_cpu.sum()) < int(bsz * p), f"{kind} NMS suppressed nothing in the crowded set"
        cli_keep = nms_keep(det.boxes, det.scores, det.labels, det.keep, kind, pre).cpu()
        assert torch.equal(r["detections"][0].keep, cli_keep), kind
        ms = []
        for _ in range(WARMUP + REPS):
            t0 = time.perf_counter()
            nms_keep(det.boxes, det.scores, det.labels, det.keep, kind, pre)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        nms[kind] = statistics.median(ms[WARMUP:])
        log(f"{kind} NMS through the CLI: its first batch's keep == the card's NMS of the in-memory boxes; "
            f"{nms[kind]:.3f} ms a batch on the card (host clock, one host sync, median of {REPS}); "
            f"CLI fps {r['timing']['fps']:.3f}, mAP {r['metrics']['mAP']:.4f}, NDS {r['metrics']['NDS']:.4f}")

    tta_out = os.path.join(SMOKE_DIR, "frames_tta.pkl")
    tta = test_cli.main(argv + ["--tta", "--out", tta_out])
    assert len(tta["frames"]) == len(infos)
    for f in tta["frames"]:
        assert np.isfinite(f.boxes).all() and np.isfinite(f.scores).all()

    # the CLI as a user runs it: a process of its own, PyTorch's
    # defaults, its 4 loader workers; the timings and peaks are its own
    del model, batch, det, first, crowd
    gc.collect()
    torch.cuda.empty_cache()
    out = os.path.join(SMOKE_DIR, "frames.pkl")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepinteraction_tpu_torch.tools.test", "fusion_base",
                           "--infos", val, "--checkpoint", ckpt, "--out", out],
                          capture_output=True, text=True, timeout=600, cwd=REPO)
    wall = time.perf_counter() - t0
    assert proc.returncode == 0, proc.stderr[-4000:]
    summary = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(out, "rb") as f:
        frames = pickle.load(f)
    assert frames["tokens"] == res["tokens"], "the CLI's own process evaluated other frames"
    worst = 0.0
    for a, b in zip(frames["frames"], res["frames"]):
        assert len(a.boxes) == len(b.boxes) and np.array_equal(a.names, b.names)
        if len(b.boxes):
            worst = max(worst, np.abs(a.boxes - b.boxes).max() / np.abs(b.boxes).max(),
                        np.abs(a.scores - b.scores).max() / np.abs(b.scores).max())
    log(f"eval CLI in a process of its own ({wall:.1f} s wall): frames vs the in-process run: same boxes "
        f"kept, max rel err {worst:.3e} (tolerance {SLICE_TOL} of scale)")
    assert worst <= SLICE_TOL, worst
    t, tt = summary["timing"], tta["timing"]
    log(f"eval CLI summary (fusion_base, B={bsz}, {t['frames']} frames, its own process): {t['fps']:.3f} fps "
        f"(set-up {t['setup_s']:.3f} s, first batch {t['first_batch_s']:.3f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in t["first_batch_ms"].items()) + " ms), "
        f"ms/frame after the first batch: " + ", ".join(f"{k} {v:.3f}" for k, v in t["ms_per_frame"].items())
        + f" (total {t['ms_per_frame_total']:.3f}); peak memory {t['peak_memory_gib']:.3f} GiB over the run, "
        f"{t['steady_peak_memory_gib']:.3f} GiB after the first batch; in this process: plain "
        f"{res['timing']['fps']:.3f} fps, TTA {tt['fps']:.3f} fps, {tt['ms_per_frame_total']:.3f} ms/frame "
        f"(no workers); NMS circle {nms['circle']:.3f} ms, rotate {nms['rotate']:.3f} ms a batch; metrics "
        + json.dumps(res["metrics"], sort_keys=True))
    return launches, stats, k1_real, {"ckpt": ckpt, "val": val, "frames": out, "frames_tta": tta_out}


def run_cli(name: str, *args: str, timeout: int = 900, torchrun: bool = False) -> tuple:
    """``python -m deepinteraction_tpu_torch.tools.<name> args`` in a
    process of its own, as a user runs it (with ``torchrun``, one rank
    under ``python -m torch.distributed.run --standalone --nproc-per-node
    1``); returns (its last line as JSON, or None if that line is not JSON,
    the wall seconds). A non-zero exit raises."""
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "1"] if torchrun else []
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *launcher, "-m", f"deepinteraction_tpu_torch.tools.{name}", *args],
                          capture_output=True, text=True, timeout=timeout, cwd=REPO)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"tools.{name} {' '.join(args)} exited {proc.returncode}:\n{proc.stdout[-3000:]}\n"
                           f"{proc.stderr[-5000:]}")
    last = proc.stdout.strip().splitlines()[-1]
    return (json.loads(last) if last.startswith("{") else None), wall


def read_train_run(work: str, summary: dict, metric_keys: set, label: str) -> dict:
    """Phase 21: a train CLI run's logs, read back and checked; its ms/step
    (the median of the logged steps' ``time`` after the first 2), loader
    wait and image stage (``data_time``), first step and peak memory."""
    with open(os.path.join(work, "train_log.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    with open(os.path.join(work, "config.json")) as f:
        config = json.load(f)
    rows = [r for r in rows if r["step"] > summary["first_step"]]
    assert [r["step"] for r in rows] == list(range(summary["first_step"] + 1, summary["last_step"] + 1)), label
    for r in rows:
        assert set(r) == metric_keys | TRAIN_LOG_EXTRA, (label, sorted(set(r) ^ (metric_keys | TRAIN_LOG_EXTRA)))
        assert all(np.isfinite(v) for v in r.values()), (label, r)
    proc = subprocess.run([sys.executable, "-m", "deepinteraction_tpu_torch.tools.analyze_logs", "cal_train_time",
                           os.path.join(work, "train_log.jsonl")], capture_output=True, text=True, timeout=120,
                          cwd=REPO)
    assert proc.returncode == 0 and "iter time: mean" in proc.stdout, proc.stderr[-2000:]
    steady = rows[2:] or rows
    t = {"ms_per_step": statistics.median(r["time"] for r in steady) * 1e3,
         "data_ms": statistics.median(r["data_time"] for r in steady) * 1e3,
         "first_step_s": rows[0]["time"], "first_data_s": rows[0]["data_time"], "steps": len(rows),
         "peak_gib": summary["peak_memory_gib"], "steady_peak_gib": summary["steady_peak_memory_gib"],
         "wall_s": summary["seconds"], "first": rows[0]}
    log(f"train CLI {label}: config.json {config}; {len(rows)} steps {rows[0]['step']}-{rows[-1]['step']}, every "
        f"loss finite, log keys those of TrainStep's metrics + {sorted(TRAIN_LOG_EXTRA)}, analyze_logs "
        f"cal_train_time: {proc.stdout.strip().splitlines()[0]}; ms/step {t['ms_per_step']:.3f} (median after the "
        f"first 2 steps; min {min(r['time'] for r in steady) * 1e3:.3f}, max "
        f"{max(r['time'] for r in steady) * 1e3:.3f}), data_time {t['data_ms']:.3f} ms; first step "
        f"{t['first_step_s']:.3f} s (its data_time {t['first_data_s']:.3f} s); peak memory {t['peak_gib']:.3f} GiB, "
        f"{t['steady_peak_gib']:.3f} after the first step; "
        f"the run {t['wall_s']:.1f} s in its process; losses of the last step "
        + " ".join(f"{k}={rows[-1][k]:.5g}" for k in ("loss_total", "loss_heatmap", "matched_ious", "grad_norm")))
    return t


def run_train_cli(dev, ckpt: str, measured: dict) -> tuple:
    """Phases 20-22: the data-preparation, train and benchmark CLIs, each
    as ``python -m deepinteraction_tpu_torch.tools.<cli>`` in a process of
    its own. Returns each path's kernel launches (as the CLIs count them),
    and the train pkl and the ``fusion_base`` run from ``--load-from`` for
    phase 23."""
    root = os.path.join(SMOKE_DIR, "train_tree")
    _, wall = run_cli("create_data", "synthetic", "--root", root, "--profile", "realistic",
                           "--num-scenes", str(TRAIN_TREE[0]), "--num-samples", str(TRAIN_TREE[1]),
                           "--gt-database", "--export-2d")
    train_pkl, val_pkl = (os.path.join(root, f"nuscenes_infos_{s}.pkl") for s in ("train", "val"))
    infos = {}
    for split, path in (("train", train_pkl), ("val", val_pkl)):
        with open(path, "rb") as f:
            infos[split] = pickle.load(f)["infos"]
    with open(os.path.join(root, "gt_database_infos.pkl"), "rb") as f:
        db = pickle.load(f)
    n_2d = {}
    for split, path in (("train", train_pkl), ("val", val_pkl)):
        with open(path[: -len(".pkl")] + "_mono3d.coco.json") as f:
            coco = json.load(f)
        assert len(coco["images"]) == 6 * len(infos[split]), split
        n_2d[split] = len(coco["annotations"])
    drawn = sorted({str(n) for i in infos["train"] for n in i["gt_names"]})
    cfg = fusion_base_config()
    steps = len(cbgs_indices(infos["train"], cfg.data.class_names, 0)) // cfg.data.samples_per_device
    log(f"create_data synthetic --profile realistic ({TRAIN_TREE[0]} scenes x {TRAIN_TREE[1]} samples, 6 of the "
        f"scenes val) in its own process: {wall:.1f} s; {len(infos['train'])} train and {len(infos['val'])} val "
        f"samples; GT database entries by class "
        + json.dumps({k: len(v) for k, v in sorted(db.items())})
        + f"; 2D annotations {n_2d}; CBGS gives {steps} train steps an epoch at B={cfg.data.samples_per_device}")
    assert len(infos["val"]) == 6 * TRAIN_TREE[1] and steps >= 8, (len(infos["val"]), steps)
    missing = [n for n in drawn if not db.get(n)]
    assert not missing, f"classes drawn in the train split without GT-database entries: {missing}"
    assert all(n_2d.values()), n_2d

    every_step = ["--cfg-options", "optim.log_interval_steps=1"]
    work = os.path.join(SMOKE_DIR, "train_lidar")
    lidar, _ = run_cli("train", "lidar_only", "--infos", train_pkl, "--work-dir", work, "--profile-steps", "2",
                          *every_step, "optim.total_epochs=1")
    trace = os.path.join(work, "trace", "trace.json")
    assert os.path.getsize(trace) > 0, trace
    lidar_t = read_train_run(work, lidar, measured["lidar_keys"], "lidar_only, 1 epoch")
    log(f"train CLI lidar_only: --profile-steps 2 wrote {trace} ({os.path.getsize(trace)} bytes); "
        f"kernel launches {lidar['launches']}")
    per_step = expect_launches(subm_conv_gemm=42, subm_conv_dgrad=40, subm_conv_wgrad=42,
                               **table_launches(2, train=True))
    assert lidar["launches"] == {k: v * lidar["steps"] for k, v in per_step.items()}, lidar
    assert lidar["steps"] == steps, lidar

    work = os.path.join(SMOKE_DIR, "train_fusion")
    fusion, _ = run_cli("train", "fusion_base", "--infos", train_pkl, "--work-dir", work, "--load-from", ckpt,
                           "--eval-infos", val_pkl, *every_step, "optim.total_epochs=1")
    fusion_t = read_train_run(work, fusion, measured["fusion_keys"], "fusion_base, 1 epoch from --load-from")
    resumed, _ = run_cli("train", "fusion_base", "--infos", train_pkl, "--work-dir", work, "--resume-from",
                            os.path.join(work, "ckpts"), "--eval-infos", val_pkl, *every_step,
                            "optim.total_epochs=2")
    assert (resumed["first_step"], resumed["last_step"]) == (fusion["last_step"], 2 * fusion["last_step"]), resumed
    resumed_t = read_train_run(work, resumed, measured["fusion_keys"], "fusion_base, epoch 1 from --resume-from")
    with open(os.path.join(work, "train_log.jsonl")) as f:
        epochs = [json.loads(line)["epoch"] for line in f]
    with open(os.path.join(work, "eval_log.jsonl")) as f:
        evals = [json.loads(line) for line in f]
    assert epochs == [0] * steps + [1] * steps, epochs
    assert [e["epoch"] for e in evals] == [0, 1] and all(np.isfinite(e["NDS"]) for e in evals), evals
    fusion_step = expect_launches(subm_conv_gemm=42, local_attn_fwd=6, local_attn_bwd=6,
                                  **table_launches(2, train=True))
    batches = -(-len(infos["val"]) // cfg.data.samples_per_device)
    eval_batch = expect_launches(subm_conv_gemm=42, local_attn_fwd=6, **table_launches(2))
    for run in (fusion, resumed):
        assert run["launches"] == {k: v * steps for k, v in fusion_step.items()}, run
        assert run["eval_launches"] == {k: v * batches for k, v in eval_batch.items()}, run
    log(f"train CLI fusion_base: --resume-from continued at step {resumed['first_step']} and wrote epoch 1's "
        f"{steps} lines; eval_log {[{k: round(e[k], 6) for k in ('epoch', 'mAP', 'NDS')} for e in evals]}; "
        f"kernel launches a run: train steps {fusion['launches']}, its evaluation of {len(infos['val'])} val frames "
        f"{fusion['eval_launches']}")

    val_args = ("--infos", val_pkl, "--batch", "1")
    bench = {}
    for label, args in (("eval, synthetic, B=1", ("--synthetic", "--batch", "1")),
                        ("train, synthetic, B=2", ("--synthetic", "--train", "--batch", "2")),
                        ("eval, --infos val, B=1", val_args)):
        rec, wall = run_cli("benchmark", "fusion_base", *args, "--samples", str(REPS), "--warmup", str(WARMUP))
        assert rec["device"] == torch.cuda.get_device_name(dev) and rec["samples"] == REPS, rec
        assert all(np.isfinite(rec[k]) for k in ("ms_per_iter_mean", "ms_per_iter_median", "peak_memory_gib"))
        bench[label] = rec
        log(f"benchmark CLI fusion_base {label} ({wall:.1f} s in its own process): " + json.dumps(rec))
        b = int(args[args.index("--batch") + 1])
        train = "--train" in args
        want = expect_launches(subm_conv_gemm=21 * b, local_attn_fwd=6, local_attn_bwd=6 if train else 0,
                               **table_launches(b, train))
        assert rec["launches"] == {k: v * REPS for k, v in want.items()}, (label, rec["launches"])
    log(f"benchmark CLI beside this process (logged, not asserted; the host moves these 20-40 %): eval B=1 "
        f"{bench['eval, synthetic, B=1']['ms_per_iter_median']:.3f} ms/frame synthetic, "
        f"{bench['eval, --infos val, B=1']['ms_per_iter_median']:.3f} on the realistic val frames, against "
        f"{measured['eval_ms']:.3f} in phase 7; train B=2 {bench['train, synthetic, B=2']['ms_per_iter_median']:.3f} "
        f"ms/step against {measured['fusion_ms']:.3f} in phase 13 and {fusion_t['ms_per_step']:.3f} and "
        f"{resumed_t['ms_per_step']:.3f} in the train CLI over the realistic tree; peak memory "
        + ", ".join(f"{k} {v['peak_memory_gib']:.3f}" for k, v in bench.items())
        + f" GiB (phase 7 {measured['eval_peak_gib']:.3f}, phase 13 {measured['fusion_peak_gib']:.3f})")
    log(f"train CLI summary (H100 runs above): lidar_only {lidar_t['ms_per_step']:.3f} ms/step, data "
        f"{lidar_t['data_ms']:.3f} ms; fusion_base {fusion_t['ms_per_step']:.3f} and {resumed_t['ms_per_step']:.3f} "
        f"ms/step, data {fusion_t['data_ms']:.3f} and {resumed_t['data_ms']:.3f} ms; first steps "
        f"{lidar_t['first_step_s']:.3f}, {fusion_t['first_step_s']:.3f}, {resumed_t['first_step_s']:.3f} s; peaks "
        f"{lidar_t['peak_gib']:.3f}, {fusion_t['peak_gib']:.3f}, {resumed_t['peak_gib']:.3f} GiB, after the first "
        f"step {lidar_t['steady_peak_gib']:.3f}, {fusion_t['steady_peak_gib']:.3f}, "
        f"{resumed_t['steady_peak_gib']:.3f} GiB")
    fusion_label = f"fusion_base train CLI (tools.train), 2 runs of {steps} steps, B=2"
    fusion_run = {"train_pkl": train_pkl, "first": fusion_t["first"], "ms_per_step": fusion_t["ms_per_step"],
                  "launches": fusion["launches"], "steps": steps}
    return fusion_run, {f"lidar_only train CLI (tools.train), {steps} steps, B=2": lidar["launches"],
            fusion_label: {k: fusion["launches"][k] + resumed["launches"][k] for k in fusion_step},
            fusion_label + ", their --eval-infos evaluations": {
                k: fusion["eval_launches"][k] + resumed["eval_launches"][k] for k in fusion_step},
            **{f"fusion_base benchmark CLI (tools.benchmark), {k}, {REPS} timed": v["launches"]
               for k, v in bench.items()}}


def run_dist(paths: dict, fusion_run: dict, eval_launches: dict) -> dict:
    """Phases 23-24: the train and eval CLIs under ``torchrun`` at one rank
    (a NCCL group of one: the BN, normaliser and gradient all-reduces run),
    then the folding, eval-with-folded-weights and ensemble tools. Returns
    the two ``torchrun`` paths' kernel launches."""
    t_start = time.perf_counter()
    # the folding is an offline CPU conversion: it runs beside phase 23
    fused = os.path.join(SMOKE_DIR, "ckpt_fused")
    fold = subprocess.Popen([sys.executable, "-m", "deepinteraction_tpu_torch.tools.misc_tools", "fuse_conv_bn",
                             "fusion_base", "--checkpoint", paths["ckpt"], "--out", fused],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=REPO)
    try:
        work = os.path.join(SMOKE_DIR, "train_dist")
        train, wall = run_cli("train", "fusion_base", "--infos", fusion_run["train_pkl"], "--work-dir", work,
                              "--load-from", paths["ckpt"], "--cfg-options", "optim.log_interval_steps=1",
                              "optim.total_epochs=1", torchrun=True)
        t = read_train_run(work, train, set(fusion_run["first"]) - TRAIN_LOG_EXTRA,
                           "fusion_base under torchrun, 1 rank, 1 epoch from --load-from")
        assert train["ranks"] == 1 and train["steps"] == fusion_run["steps"], train
        assert train["launches"] == fusion_run["launches"], (train["launches"], fusion_run["launches"])
        first, ref = t["first"], fusion_run["first"]
        losses = [k for k in ref if k not in TRAIN_LOG_EXTRA]
        rel = {k: abs(first[k] - ref[k]) / max(abs(ref[k]), 1e-30) for k in losses}
        calls, n_bytes = train["collectives"]["calls"] / train["steps"], train["collectives"]["bytes"] / train["steps"]
        log(f"train CLI under torchrun (1 rank, NCCL, {wall:.1f} s wall): first step against phase 21's "
            f"single-process run on the same seed and checkpoint: max rel err {max(rel.values()):.3e} (tolerance "
            f"{DIST_LOSS_RTOL}; worst {max(rel, key=rel.get)}); ms/step {t['ms_per_step']:.3f} against "
            f"{fusion_run['ms_per_step']:.3f} single-process (the difference is the process group's cost at "
            f"world 1); {calls:.1f} collectives and {n_bytes / 2**20:.3f} MiB all-reduced a step; launches "
            f"{train['launches']}")
        assert all(v <= DIST_LOSS_RTOL for v in rel.values()), rel
        assert calls > 0 and n_bytes > 0, train["collectives"]

        out = os.path.join(SMOKE_DIR, "frames_dist.pkl")
        ev, wall = run_cli("test", "fusion_base", "--infos", paths["val"], "--checkpoint", paths["ckpt"],
                           "--out", out, torchrun=True)
        with open(out, "rb") as f:
            got = pickle.load(f)
        with open(paths["frames"], "rb") as f:
            want = pickle.load(f)
        assert got["tokens"] == want["tokens"], "the torchrun eval evaluated other frames or another order"
        worst = 0.0
        for a, b in zip(got["frames"], want["frames"]):
            assert len(a.boxes) == len(b.boxes) and np.array_equal(a.names, b.names)
            if len(b.boxes):
                worst = max(worst, np.abs(a.boxes - b.boxes).max() / np.abs(b.boxes).max(),
                            np.abs(a.scores - b.scores).max() / np.abs(b.scores).max())
        log(f"eval CLI under torchrun (1 rank, NCCL, {wall:.1f} s wall): {len(got['tokens'])} frames, tokens and "
            f"order those of phase 19's single-process --out, boxes and scores max rel err {worst:.3e} (tolerance "
            f"{DIST_EVAL_TOL} of scale); {ev['timing']['fps']:.3f} fps, {ev['timing']['ms_per_frame_total']:.3f} "
            f"ms/frame; launches {ev['launches']}")
        assert worst <= DIST_EVAL_TOL, worst
        assert ev["launches"] == eval_launches, (ev["launches"], eval_launches)
        fold_log = fold.communicate(timeout=600)[0]
    finally:
        fold.kill()
    assert fold.returncode == 0, fold_log[-4000:]

    # the folded checkpoint through the eval CLI, in this process, against
    # the unfolded one with the unfolded run's sort orders replayed
    argv = ["fusion_base", "--infos", paths["val"], "--num-workers", "0"]
    orders, flips = [], []
    with sort_orders(orders, False, flips):
        plain = test_cli.main(argv + ["--checkpoint", paths["ckpt"]])
    with sort_orders(orders, True, flips):
        folded = test_cli.main(argv + ["--checkpoint", fused])
    errs, same_labels, same_keep = {"boxes": 0.0, "scores": 0.0}, True, 0
    for a, b in zip(folded["detections"], plain["detections"]):
        for k in errs:
            errs[k] = max(errs[k], rel_err(getattr(a, k), getattr(b, k))[1])
        same_labels &= torch.equal(a.labels, b.labels)
        same_keep += int((a.keep != b.keep).sum())
    fp, ff = plain["timing"]["ms_per_frame"], folded["timing"]["ms_per_frame"]
    log(f"misc_tools fuse_conv_bn: {fold_log.strip().splitlines()[-1]}; the eval CLI on the folded checkpoint "
        f"against the unfolded one (in this process, {sum(flips)} of {len(flips)} sorts replayed differed): max "
        f"rel err boxes {errs['boxes']:.3e}, scores {errs['scores']:.3e} (tolerance {FOLD_TOL} of scale), labels "
        f"equal {same_labels}, keep flags differing {same_keep}; ms/frame unfolded {plain['timing']['ms_per_frame_total']:.3f} "
        f"(forward {fp['forward']:.3f}), folded {folded['timing']['ms_per_frame_total']:.3f} (forward "
        f"{ff['forward']:.3f}); the neutralised BNs still run, so no gain is expected")
    assert all(v <= FOLD_TOL for v in errs.values()) and same_labels, (errs, same_labels)
    assert plain["metrics"].keys() == folded["metrics"].keys()

    t0 = time.perf_counter()
    metrics = ensemble.main([paths["frames"], paths["frames_tta"], "--infos", paths["val"],
                             "--out", os.path.join(SMOKE_DIR, "fused.pkl")])
    log(f"tools.ensemble over phase 19's plain and --tta --out ({time.perf_counter() - t0:.1f} s): NDS "
        f"{metrics['NDS']:.6f}, mAP {metrics['mAP']:.6f}")
    assert all(np.isfinite(v) for v in metrics.values()), metrics
    log(f"phases 23-24 took {time.perf_counter() - t_start:.1f} s")
    return {f"fusion_base train CLI under torchrun (1 rank, NCCL), {train['steps']} steps, B=2": train["launches"],
            "fusion_base eval CLI under torchrun (1 rank, NCCL), 9 frames, B=2": ev["launches"]}


def run_host_side(dev, val_pkl: str) -> None:
    """Phase 25: the native sweep reader against its plain version on
    every sample of phase 19's val tree, and the image transforms on one
    sample's six views, card against CPU."""
    t_start = time.perf_counter()
    with open(val_pkl, "rb") as f:
        infos = pickle.load(f)["infos"]
    n_sweeps = fusion_base_config().data.num_sweeps
    worst, ms, rows = 0.0, {"native": [], "plain": []}, []
    for info in infos:
        got = {}
        for kind, fn in (("native", pipeline.load_sweep_points), ("plain", pipeline.load_sweep_points_plain)):
            t0 = time.perf_counter()
            got[kind] = fn(info, n_sweeps, None)
            ms[kind].append((time.perf_counter() - t0) * 1e3)
        assert got["native"].shape == got["plain"].shape, (got["native"].shape, got["plain"].shape)
        worst = max(worst, float(np.abs(got["native"] - got["plain"]).max()))
        rows.append(len(got["native"]))
    log(f"native sweep reader ({native.library_path()}) vs float32 numpy on {len(infos)} val samples "
        f"({min(rows)}-{max(rows)} points, {n_sweeps} sweeps at most): equal counts, max abs diff {worst:.3e} m "
        f"(tolerance {NATIVE_TOL}); ms a sample, median (first): native {statistics.median(ms['native']):.3f} "
        f"({ms['native'][0]:.3f}), plain {statistics.median(ms['plain']):.3f} ({ms['plain'][0]:.3f})")
    assert worst <= NATIVE_TOL, worst

    cams = list(infos[0]["cams"].values())
    pixels = jpeg.decode([np.fromfile(c["data_path"], np.uint8) for c in cams], dev)
    views = torch.stack(pixels).float()  # [6, 900, 1600, 3] on the card
    l2i = np.stack([np.eye(4, dtype=np.float32)] * len(cams))
    boxes = np.array([[100.0, 50.0, 700.0, 400.0], [-20.0, 600.0, 1700.0, 950.0]], np.float32)

    def transforms(x):
        """The six transforms on [V, H, W, 3] ``x``; every output in a list
        (images and host arrays)."""
        out = [xt.photometric_distortion(x, np.random.default_rng(seed)) for seed in (1, 5, 11)]
        scale, _ = xt.random_scale([(1600, 900), (1333, 800)], np.random.default_rng(0), "range")
        out.append(xt.rescale_keep_ratio(x[0], scale)[0])
        imgs, mats, factor, bx = xt.resize_multiview(list(x), l2i, (1333, 800), True, boxes.copy())
        out += imgs + [mats, factor, bx]
        imgs, mats, _ = xt.random_resize(list(x), l2i, np.random.default_rng(3))
        out += imgs + [mats]
        out.append(xt.pad_waymo_view(x[0]))
        return out

    on_card = transforms(views)
    on_cpu = transforms(views.cpu())
    errs = []
    for a, b in zip(on_card, on_cpu):
        if isinstance(a, torch.Tensor):
            assert a.device.type == "cuda" and a.shape == b.shape, (a.device, a.shape, b.shape)
            errs.append((a.cpu() - b).abs().max().item())
        else:
            assert np.array_equal(a, b)
    times = []
    for _ in range(WARMUP + REPS):
        t0 = time.perf_counter()
        transforms(views)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f"image transforms (3 photometric draws, random_scale + rescale_keep_ratio, resize_multiview, "
        f"random_resize, pad_waymo_view) on a sample's {len(cams)} views of {tuple(views.shape[1:3])} decoded by "
        f"nvJPEG: card vs CPU max abs {max(errs):.3e} levels over {len(errs)} images (tolerance {TRANSFORM_TOL}); "
        f"{statistics.median(times[WARMUP:]):.3f} ms a sample on the card (host clock to a synchronize, median of "
        f"{REPS})")
    assert max(errs) <= TRANSFORM_TOL, errs
    log(f"phase 25 took {time.perf_counter() - t_start:.1f} s")


def run_tools() -> None:
    """Phase 26: get_flops, trace_model and analyze_trace, each in a process
    of its own (this process's cached device memory released first)."""
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()

    def flops_of(*args):
        rec, wall = run_cli("get_flops", *args)
        log(f"get_flops {' '.join(args)} ({wall:.1f} s wall, {rec['device']}): params {rec['params']} "
            f"({rec['params'] / 1e6:.2f} M), {rec['flops'] / 1e9:.3f} GFLOPs per {rec['per']}; by operator "
            + json.dumps({k: round(v / 1e9, 3) for k, v in rec["flops_by_op"].items()}))
        return rec

    # the CPU count, and the two train steps one after the other, beside the
    # card's eval counts: two processes on the card at once, each up to ~36
    # GiB in its first iteration (cuDNN's autotuning)
    with ThreadPoolExecutor(2) as pool:
        cpu_tiny = pool.submit(flops_of, "tiny", "--device", "cpu")
        trains = pool.submit(lambda: [flops_of(name, "--train") for name in ("fusion_base", "lidar_only")])
        card_tiny = flops_of("tiny")
        for name in ("fusion_base", "fusion_plusplus"):
            flops_of(name)
        cpu_tiny = cpu_tiny.result()
        trains.result()
    same = {k: cpu_tiny[k] == card_tiny[k] for k in ("params", "flops", "flops_by_op")}
    log(f"get_flops tiny on the CPU and on the card: equal {same}")
    assert all(same.values()), (cpu_tiny, card_tiny)

    outdir = os.path.join(SMOKE_DIR, "trace_fusion_base")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "deepinteraction_tpu_torch.tools.trace_model", "fusion_base",
                           "--iters", "2", "--outdir", outdir], capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lines = proc.stdout.strip().splitlines()
    log(f"trace_model fusion_base --iters 2 ({time.perf_counter() - t0:.1f} s wall): " + "; ".join(lines))
    assert lines[-2] == f"trace written to {outdir}" and lines[-1].startswith("steady-state:"), lines
    res, wall = run_cli("analyze_trace", outdir, "--ops", "--top", "10")
    cats = list(res["by_category_ms_per_run"].items())[:5]
    scopes = list(res["by_scope_ms_per_run"].items())[:8]
    log(f"analyze_trace ({wall:.1f} s wall): {res['lanes']}, {res['runs']} runs: {res['ms_per_run']:.3f} ms of "
        f"device time a run in a {res['window_ms_per_run']:.3f} ms window (busy {100 * res['busy_share']:.1f} %); "
        "top categories " + ", ".join(f"{k} {v:.3f}" for k, v in cats) + "; scopes "
        + ", ".join(f"{k} {v:.3f}" for k, v in scopes) + f"; port launches a run {res['port_launches_per_run']}; "
        "top kernels " + "; ".join(f"{n[:60]} {ms:.3f} ms x{c:g}" for n, ms, c in res["top_ops"][:5]))
    assert res["lanes"] == "device kernels" and res["runs"] == 2, res["lanes"]
    got = {k: res["port_launches_per_run"][k] for k in TRACE_LAUNCHES}
    assert got == TRACE_LAUNCHES, got
    log(f"phase 26 took {time.perf_counter() - t_start:.1f} s")


def views_seen(mb: dict, input_shape) -> tuple:
    """How many views see each pillar (through its valid points) and each
    valid point of the detector's I2P batch ``mb``: ([B, Kp], [B, N]),
    0 for padding."""
    p = mb["pillars"].shape[2]
    _, kmask = mmri_encoder.i2p_geometry(mb["pillars"], mb["pillar_counts"], mb["lidar2img"],
                                         mb["lidar_aug_inv"], input_shape)
    v = mb["lidar2img"].shape[1]
    pillar_views = kmask.reshape(kmask.shape[0], -1, p, v).any(2).sum(-1) * mb["pillar_valid"]
    point_views = []
    for i in range(mb["points"].shape[0]):
        raw = transform_points(mb["lidar_aug_inv"][i], mb["points"][i, :, :3])
        hom = torch.cat([raw, torch.ones_like(raw[:, :1])], -1)
        ok = torch.stack([mmri_encoder._project(hom, m, input_shape)[1] for m in mb["lidar2img"][i]])
        point_views.append(ok.sum(0) * mb["points_mask"][i])
    return pillar_views, torch.stack(point_views)


def distinct_pixels(mb: dict, input_shape, feat_hw) -> torch.Tensor:
    """[B, Kp, 2] distinct nearest feature pixels among each pillar's valid
    keys in each of its top-2 views (the dedupe's count)."""
    gsel, vidx, kmask = mmri_encoder.i2p_geometry(mb["pillars"], mb["pillar_counts"], mb["lidar2img"],
                                                  mb["lidar_aug_inv"], input_shape, 2)
    v = mb["lidar2img"].shape[1]
    ids, inside = nearest_row_ids((v, *feat_hw), gsel, vidx)
    big = v * feat_hw[0] * feat_hw[1]
    sids = torch.sort(torch.where(kmask.reshape(ids.shape) & inside, ids, torch.full_like(ids, big)), -1).values
    first = torch.ones_like(sids, dtype=torch.bool)
    first[..., 1:] = sids[..., 1:] != sids[..., :-1]
    return (first & (sids < big)).sum(-1)


def pillar_cells(mb: dict, bev: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """The rows of a BEV map [B, Hb, Wb, C] at the pillars where ``keep``
    [B, Kp] holds."""
    return torch.cat([bev[i][mb["pillar_coords"][i, keep[i], 1].long(), mb["pillar_coords"][i, keep[i], 2].long()]
                      for i in range(bev.shape[0])])


def frame_ms(model, batch, cfg, p) -> tuple:
    """ms/frame (eval forward + ``get_bboxes``, median of REPS after WARMUP)
    and the peak memory of the timed frames in GiB."""
    def frame():
        get_bboxes(model(batch), cfg.model.pts_bbox_head, cfg.model.bbox_coder, p)

    for _ in range(WARMUP):
        frame()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), torch.cuda.max_memory_allocated() / 2**30


def head_deltas(got: dict, ref: dict) -> str:
    return ", ".join(f"{k} {rel_err(got[k].float(), ref[k].float())[1]:.3e}" for k in sorted(ref)
                     if k not in ("query_labels", "on_image_masks"))


def run_levers(dev, paths: dict, smi: str) -> dict:
    """Phase 27: the port at the JAX package's shipped defaults
    (``levers.py``), with no ``DI_*`` variable set, on phase 19's first
    realistic frame, B=1; the ++ frame at the defaults; the tiny model with
    the other settings on, card against CPU; ``tools.gate_eval`` with
    ``--gates parity default`` on phase 19's tree and checkpoint. Returns
    the kernel launches of the two default frames."""
    t_start = time.perf_counter()
    assert {k: v for k, v in os.environ.items() if k.startswith("DI_")} == FP32_KERNELS, \
        "phase 27 runs with no DI_* variable set but FP32_KERNELS"
    levers = EvalLevers.from_env()
    assert levers == EvalLevers(sparse_impl="gather", locatt_mxu="f32"), levers
    gc.collect()
    torch.cuda.empty_cache()
    cfg = fusion_base_config()
    p = cfg.test_num_proposals
    host = next(DataLoader(NuScenesDataset(cfg, paths["val"], train=False), 1, num_workers=0).epoch(0, shuffle=False))
    host.pop("pad_count"), host.pop("token")
    batch = to_device(host, cfg.data, dev)
    shape = cfg.data.padded_img_shape

    def build(lv, config=cfg):
        return load_weights(paths["ckpt"], DeepInteraction(config.model, config.data.padded_img_shape, p,
                                                           levers=lv).to(dev).eval())

    def with_i2p(model, store: dict):
        """Record layer 0's I2P output and the I2P batch of ``model``."""
        neck = model.imgpts_neck
        return [neck.layer0.i2p.register_forward_hook(lambda m, a, o: store.__setitem__("i2p", o)),
                neck.register_forward_pre_hook(lambda m, a: store.update(img=a[0], mb=a[2]))]

    default = build(levers)
    ref = {}
    hooks = with_i2p(default, ref)
    orders, flips = [], []
    for c in COUNTED:
        c.launches = 0
    with sort_orders(orders, False, flips):
        preds = default(batch)
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    log(f"fusion_base eval at the JAX defaults {levers} on phase 19's first realistic frame, B=1: launches "
        f"{launches}")
    assert launches == expect_launches(subm_conv_gemm=21, local_attn_fwd=6, **table_launches(1)), launches
    for h in hooks:
        h.remove()
    with plain_kernels(), sort_orders(orders, True, flips):
        plain = default(batch)
    torch.cuda.synchronize()
    errs = {k: rel_err(preds[k].float(), plain[k].float())[1] for k in preds if k not in ("query_labels",
                                                                                         "on_image_masks")}
    exact = {k: torch.equal(preds[k], plain[k]) for k in ("query_labels", "on_image_masks")}
    log(f"defaults, kernels vs plain (sort orders replayed; {sum(flips)} of {len(flips)} sorts differed): worst "
        f"head {max(errs, key=errs.get)} {max(errs.values()):.3e} of scale (tolerance {SLICE_TOL}); exact {exact}")
    assert max(errs.values()) <= SLICE_TOL and all(exact.values()), (errs, exact)
    del plain, orders

    mb = ref["mb"]
    pillar_views, point_views = views_seen(mb, shape)
    valid = mb["pillar_valid"]
    n3, p3 = int((pillar_views >= 3).sum()), int((point_views >= 3).sum())
    log(f"views a pillar's points reach: {torch.bincount(pillar_views[valid]).tolist()} pillars with 0, 1, 2, ... "
        f"views of {int(valid.sum())}; points: {torch.bincount(point_views[mb['points_mask']]).tolist()} of "
        f"{int(mb['points_mask'].sum())}; {n3} pillars and {p3} points reach three or more")

    def layer0_i2p(lv):
        store = {}
        model = build(lv)
        hooks = with_i2p(model, store)
        model(batch)
        for h in hooks:
            h.remove()
        return model, store["i2p"]

    _, all_i2p = layer0_i2p(dataclasses.replace(levers, i2p_views=0))
    few = valid & (pillar_views <= 2)
    d = (pillar_cells(mb, all_i2p, few) - pillar_cells(mb, ref["i2p"], few)).abs().max().item()
    scale = ref["i2p"].abs().max().item()
    d3 = (pillar_cells(mb, all_i2p, valid & (pillar_views >= 3)) - pillar_cells(
        mb, ref["i2p"], valid & (pillar_views >= 3))).abs().max().item() if n3 else 0.0
    log(f"I2P layer 0, top-2 views vs all views: max abs diff {d:.3e} over the {int(few.sum())} pillars at most "
        f"two views see ({d / scale:.3e} of scale {scale:.3e}; tolerance {LEVER_TOL}); {d3:.3e} over the {n3} "
        "that three or more see")
    assert d <= LEVER_TOL * scale, (d, scale)

    dedupe, dd_i2p = layer0_i2p(dataclasses.replace(levers, i2p_dedupe=LEVER_DEDUPE))
    distinct = distinct_pixels(mb, shape, ref["img"].shape[2:4])
    small = valid & (distinct <= LEVER_DEDUPE).all(-1)
    d = (pillar_cells(mb, dd_i2p, small) - pillar_cells(mb, ref["i2p"], small)).abs().max().item()
    log(f"I2P layer 0, dedupe {LEVER_DEDUPE} vs nearest top-2: max abs diff {d:.3e} over the {int(small.sum())} "
        f"pillars whose views hold at most {LEVER_DEDUPE} distinct pixels ({d / scale:.3e} of scale; tolerance "
        f"{LEVER_TOL}); {int((valid[..., None] & (distinct > LEVER_DEDUPE)).sum())} pillar-views hold more; "
        f"distinct pixels a pillar-view: mean {distinct[valid].float().mean().item():.2f}, max "
        f"{int(distinct[valid].max())}")
    assert d <= LEVER_TOL * scale, (d, scale)

    parity = build(EvalLevers.parity())
    bf16 = build(dataclasses.replace(levers, dense_bf16=True))
    with torch.no_grad():
        par_preds, dd_preds, bf_preds = parity(batch), dedupe(batch), bf16(batch)
    times = {}
    for name, model in (("defaults", default), ("parity", parity), ("dedupe 8", dedupe), ("dense bf16", bf16)):
        times[name] = frame_ms(model, batch, cfg, p)
    state = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    log(f"card after the timed frames: SM clock, power, temperature {state}; host load average {os.getloadavg()}")
    log(f"fusion_base eval + get_bboxes, realistic frame, B=1 ({smi}): ms/frame and peak GiB "
        + "; ".join(f"{k} {ms:.3f} ({gib:.3f})" for k, (ms, gib) in times.items())
        + f"; heads of the defaults vs parity: {head_deltas(preds, par_preds)}; dedupe 8 vs the defaults: "
        f"{head_deltas(dd_preds, preds)}; dense bf16 vs the defaults: {head_deltas(bf_preds, preds)}")
    del default, parity, dedupe, bf16, preds, par_preds, dd_preds, bf_preds, ref, mb, all_i2p, dd_i2p
    gc.collect()
    torch.cuda.empty_cache()

    pcfg = fusion_plusplus_config()
    host = next(DataLoader(NuScenesDataset(pcfg, paths["val"], train=False), 1, num_workers=0).epoch(0,
                                                                                                   shuffle=False))
    host.pop("pad_count"), host.pop("token")
    pbatch = to_device(host, pcfg.data, dev)
    pp = {}
    for name, lv in (("defaults", levers), ("parity", EvalLevers.parity())):
        model = DeepInteraction(pcfg.model, pcfg.data.padded_img_shape, pcfg.test_num_proposals,
                                levers=lv).to(dev).eval()
        init_weights(model, seed=0)
        for c in COUNTED:
            c.launches = 0
        pp[name] = model(pbatch)
        torch.cuda.synchronize()
        if name == "defaults":
            pp_launches = {c.__name__: c.launches for c in COUNTED}
            assert pp_launches == expect_launches(subm_conv_gemm=21, **table_launches(1)), pp_launches
        pp[name + " ms"] = frame_ms(model, pbatch, pcfg, pcfg.test_num_proposals)
        del model
    log(f"fusion_plusplus eval + get_bboxes at the JAX defaults (joint top-4 MSDA), realistic frame, B=1 ({smi}): "
        f"launches {pp_launches}; ms/frame and peak GiB defaults {pp['defaults ms'][0]:.3f} "
        f"({pp['defaults ms'][1]:.3f}), parity {pp['parity ms'][0]:.3f} ({pp['parity ms'][1]:.3f}); heads of the "
        f"defaults vs parity: {head_deltas(pp['defaults'], pp['parity'])}")
    del pp, pbatch
    gc.collect()
    torch.cuda.empty_cache()

    # the gates in processes of their own, beside the tiny model on the CPU
    workdir = os.path.join(SMOKE_DIR, "gates")
    with ThreadPoolExecutor(1) as pool:
        gates = pool.submit(subprocess.run, [
            sys.executable, "-m", "deepinteraction_tpu_torch.tools.gate_eval", "fusion_base", paths["ckpt"],
            "--infos", paths["val"], "--gates", "parity", "default", "--workdir", workdir,
            "--out", os.path.join(workdir, "gates.json")], capture_output=True, text=True, timeout=600, cwd=REPO)
        tiny = tiny_config()
        tiny = dataclasses.replace(tiny, data=dataclasses.replace(tiny.data, num_views=6))
        check_tiny(dev, tiny, f"tiny_config at 6 views, {LEVER_DEDUPE}-key dedupe and the lite depth fill",
                   levers=dataclasses.replace(levers, i2p_dedupe=LEVER_DEDUPE, depth_fill_lite=True))
        proc = gates.result()
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    with open(os.path.join(workdir, "gates.json")) as f:
        rows = {r["gate"]: r for r in json.load(f)["rows"]}
    assert rows["parity"]["levers"] == dataclasses.asdict(EvalLevers.parity()), rows["parity"]
    assert rows["default"]["levers"] == dataclasses.asdict(EvalLevers()), rows["default"]
    table = [line for line in proc.stdout.splitlines() if line.startswith("|")]
    log(f"tools.gate_eval fusion_base --gates parity default (phase 19's tree and checkpoint, {smi}):\n"
        + "\n".join(table))
    log(f"phase 27 took {time.perf_counter() - t_start:.1f} s")
    return {"fusion_base": launches, "fusion_plusplus": pp_launches}


def host_ms(fn, n: int = 5) -> float:
    """Median host-clock ms of ``n`` calls of ``fn``, each fenced by
    ``torch.cuda.synchronize()``, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


@contextlib.contextmanager
def recorded_matching(calls: list):
    """Record each ``build_targets`` matching: (cost, num_gt, assignment)."""
    real = assign.hungarian_assign

    def record(cost, num_gt, impl="callback"):
        out = real(cost, num_gt, impl=impl)
        calls.append((cost.detach().clone(), num_gt.detach().clone(), out.clone()))
        return out

    assign.hungarian_assign = record
    try:
        yield
    finally:
        assign.hungarian_assign = real


def scipy_gaps(cost: torch.Tensor, num_gt: torch.Tensor, got: torch.Tensor) -> list:
    """Per problem of [..., P, G] costs: (auction objective - scipy's, eps *
    G, whether the assignments are equal), asserting every valid column
    assigned once."""
    c32 = cost.reshape(-1, *cost.shape[-2:]).float().cpu().numpy()
    c = c32.astype(np.float64)
    ng = num_gt.reshape(-1).expand(c.shape[0]).cpu().numpy()
    a = got.reshape(-1, cost.shape[-2]).cpu().numpy()
    ref = hungarian.lap_host(c32, ng)  # the callback path's matching
    out = []
    for ci, ai, ri, n in zip(c, a, ref, ng):
        assert sorted(ai[ai >= 0].tolist()) == list(range(n)), "a valid column unassigned or assigned twice"
        rows, sci = np.nonzero(ai >= 0)[0], np.nonzero(ri >= 0)[0]
        eps = AUCTION_EPS * max(np.abs(ci[:, :n]).max() if n else 0.0, 1e-6)
        out.append((ci[rows, ai[rows]].sum() - ci[sci, ri[sci]].sum(), eps * n, bool((ai == ri).all())))
    return out


def auction_cases(step_cost: torch.Tensor, step_ng: torch.Tensor, dev) -> dict:
    """Phase 28's problems: {name: (cost [n, P, G], num_gt [n] int32)}, the
    ``fusion_base`` train step's matching costs (recorded by
    :func:`recorded_matching`) and a uniform(0, 10) 200 x 200 with 30 GTs."""
    rng = np.random.default_rng(5)
    return {"fusion_base train step costs": (step_cost.reshape(-1, *step_cost.shape[-2:]).contiguous(),
                                             step_ng.reshape(-1).to(torch.int32).contiguous()),
            "uniform(0, 10) 200 x 200, 30 GTs": (
                torch.from_numpy(rng.uniform(0, 10, size=(1, 200, 200)).astype(np.float32)).to(dev),
                torch.tensor([30], dtype=torch.int32, device=dev))}


def run_auction(dev, paths: dict, train_pkl: str, metric_keys: set, smi: str) -> tuple:
    """Phase 28: the auction kernel against its plain version and scipy,
    the ``fusion_base`` train step and the train CLI with
    ``lap_impl=auction``, and a realistic frame with bf16 I2P keys. Returns
    (the kernel's JSON record, {path: launches})."""
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = fusion_base_config()
    b = cfg.data.samples_per_device
    batch = to_torch(make_synthetic_batch(cfg, b=b, seed=0, with_gt=True), dev)
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape).to(dev)
    init_weights(model, seed=0)
    start = copy.deepcopy(model.state_dict())
    callback_step = TrainStep(cfg, model, 1000, device=dev)
    calls = []
    with recorded_matching(calls):
        cb_metrics, cb_targets = callback_step.backward(batch, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    (step_cost, step_ng, _), = calls
    cases = auction_cases(step_cost, step_ng, dev)
    rec = None
    for name, (c, ng) in cases.items():
        got, rounds = hungarian.auction_lap(c, ng)
        again, rounds_again = hungarian.auction_lap(c, ng)
        want, want_rounds = hungarian.auction_assign_plain(c, ng, with_rounds=True)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(rounds, want_rounds), (name, rounds, want_rounds)
        assert torch.equal(again, got) and torch.equal(rounds_again, rounds), name
        gaps = scipy_gaps(c, ng, got)
        assert all(gap <= AUCTION_GAP * bound for gap, bound, _ in gaps), (name, gaps)
        n, p, g = c.shape
        bd = bound(4 * (n * p * g + n + n * p + n), 0, "fp32")
        ms = device_time_ms(lambda: hungarian.auction_lap(c, ng))
        plain_ms = host_ms(lambda: hungarian.auction_assign_plain(c, ng), 3)
        callback_ms = host_ms(lambda: hungarian.hungarian_assign(c, ng, impl="callback"))
        us_round = ms * 1e3 / int(rounds.max())  # the CTAs run side by side: the longest chain sets the time
        log(f"auction_lap, {name} [{n}, {p}, {g}], num_gt {ng.tolist()}: equal to the plain version (assignment "
            f"and rounds) and twice the same bits; rounds a problem {rounds.tolist()}; {sum(e for *_, e in gaps)} "
            f"of {n} equal to scipy's, objective - scipy's "
            + ", ".join(f"{gap:.4g}" for gap, _, _ in gaps) + f" (bound {AUCTION_GAP} eps G: "
            + ", ".join(f"{AUCTION_GAP * bnd:.4g}" for _, bnd, _ in gaps) + f"); kernel_ms={ms:.4f} (CUDA events) "
            f"us_per_round={us_round:.4f} (kernel ms / the largest round count) plain_ms={plain_ms:.3f} "
            f"callback_ms={callback_ms:.3f} (host clock, fenced) bound_ms={bd['bound_ms']:.6f} ({bd['bound_by']}), "
            f"{smi}")
        if rec is None:  # the main path's shape
            rec = {"shape": f"[{b}, {cfg.model.pts_bbox_head.num_mmpi}, {p}, {g}]", "ms": ms, "plain_ms": plain_ms,
                   "callback_ms": callback_ms, **bd, "share": bd["bound_ms"] / ms, "max_abs_err": 0,
                   "rounds": rounds.tolist(), "us_per_round": us_round}

    # three auction steps from the callback step's weights, counted
    acfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, assigner=dataclasses.replace(cfg.model.assigner, lap_impl="auction")))
    model.load_state_dict(start)
    step = TrainStep(acfg, model, 1000, device=dev)
    calls.clear()
    for c in COUNTED:
        c.launches = 0
    with recorded_matching(calls):
        metrics, targets = step.backward(batch, torch.Generator(device=dev).manual_seed(1))
        step.update(metrics["grad_norm"])
        later = [step(batch, torch.Generator(device=dev).manual_seed(2 + i)) for i in range(2)]
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in COUNTED}
    k2n = 3 * cfg.model.imgpts_neck.num_layers
    log(f"fusion_base train step, lap_impl=auction, B={b}, 3 steps: launches {launches}")
    assert launches == expect_launches(subm_conv_gemm=3 * 21 * b, local_attn_fwd=3 * k2n, local_attn_bwd=3 * k2n,
                                       auction_lap=3, **table_launches(3 * b, train=True)), launches
    for m in [metrics] + later:
        assert all(torch.isfinite(v).all() for v in m.values()), m
    assert torch.equal(calls[0][0], step_cost), "the auction step's first cost differs from the callback step's"
    agree = (targets.assign == cb_targets.assign).flatten(2).all(-1).all(0)  # [L]: both samples of a layer
    same = ["loss_heatmap"] + [f"layer_{li}_loss_{t}" for li in range(len(agree)) if agree[li] for t in ("cls", "bbox")]
    if bool(agree.all()):
        same += ["loss_total", "matched_ious"]
    worst = max(rel_err(metrics[k], cb_metrics[k])[1] for k in same)
    for i, (cost, ng, got) in enumerate(calls):
        gaps = scipy_gaps(cost, ng, got)
        assert all(gap <= AUCTION_GAP * bnd for gap, bnd, _ in gaps), (i, gaps)
        log(f"auction step {i + 1}: {sum(not e for *_, e in gaps)} of {len(gaps)} problems differ from scipy's "
            f"matching, objective - scipy's {', '.join(f'{gap:.4g}' for gap, _, _ in gaps)}; losses "
            + " ".join(f"{k}={v.item():.6g}" for k, v in ([metrics] + later)[i].items()))
    log(f"auction step 1 against the callback step on the same weights and batch: layers whose matching agrees "
        f"{agree.tolist()}; {len(same)} loss terms compared, worst rel diff {worst:.3e} (tolerance "
        f"{AUCTION_LOSS_RTOL})")
    assert worst <= AUCTION_LOSS_RTOL, worst
    times = {"callback": [], "auction": []}
    for i in range(3):
        for name, st in (("callback", callback_step), ("auction", step), ("auction", step), ("callback", callback_step)):
            t0 = time.perf_counter()
            m = st(batch, torch.Generator(device=dev).manual_seed(10 + i))
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) * 1e3)
            assert torch.isfinite(m["loss_total"]), (name, m)
    log(f"fusion_base train step B={b}, in turns (callback, auction, auction, callback) x 3 ({smi}): ms/step median "
        + ", ".join(f"{k} {statistics.median(v):.3f} (min {min(v):.3f}, max {max(v):.3f})" for k, v in times.items()))
    rec.update(launches=launches["auction_lap"] // 3, step_ms={k: statistics.median(v) for k, v in times.items()})
    del model, step, callback_step, start, calls, cases, batch
    gc.collect()
    torch.cuda.empty_cache()

    work = os.path.join(SMOKE_DIR, "train_auction")
    shutil.rmtree(work, ignore_errors=True)
    summary, wall = run_cli("train", "fusion_base", "--infos", train_pkl, "--work-dir", work, "--cfg-options",
                            "optim.log_interval_steps=1", "optim.total_epochs=1", "model.assigner.lap_impl=auction")
    steps = summary["steps"]
    assert summary["lap_impl"] == "auction", summary
    assert summary["launches"] == expect_launches(subm_conv_gemm=42 * steps, local_attn_fwd=6 * steps,
                                                  local_attn_bwd=6 * steps, auction_lap=steps,
                                                  **table_launches(2 * steps, train=True)), summary
    cli = read_train_run(work, summary, metric_keys, "fusion_base, 1 epoch, lap_impl=auction")
    log(f"train CLI fusion_base --cfg-options model.assigner.lap_impl=auction ({wall:.1f} s in its own process): "
        f"lap_impl {summary['lap_impl']}, {steps} steps, launches {summary['launches']}, ms/step "
        f"{cli['ms_per_step']:.3f}")

    # one realistic frame with bf16 I2P keys beside the defaults
    p = cfg.test_num_proposals
    host = next(DataLoader(NuScenesDataset(cfg, paths["val"], train=False), 1, num_workers=0).epoch(0, shuffle=False))
    host.pop("pad_count"), host.pop("token")
    frame = to_device(host, cfg.data, dev)
    levers = EvalLevers.from_env()
    models = {name: load_weights(paths["ckpt"], DeepInteraction(cfg.model, cfg.data.padded_img_shape, p,
                                                                levers=lv).to(dev).eval())
              for name, lv in (("float32", levers), ("bfloat16", dataclasses.replace(levers, i2p_dtype="bfloat16")))}
    assert models["bfloat16"].imgpts_neck.layer0.i2p.key_dtype == torch.bfloat16
    for c in COUNTED:
        c.launches = 0
    bf_preds = models["bfloat16"](frame)
    torch.cuda.synchronize()
    bf_launches = {c.__name__: c.launches for c in COUNTED}
    assert bf_launches == expect_launches(subm_conv_gemm=21, local_attn_fwd=6, **table_launches(1)), bf_launches
    preds = models["float32"](frame)
    assert all(torch.isfinite(v.float()).all() for v in bf_preds.values())
    timed = {name: frame_ms(m, frame, cfg, p) for name, m in models.items()}
    log(f"fusion_base eval, realistic frame, B=1, I2P keys fp32 and bf16 ({smi}): launches {bf_launches}; ms/frame "
        "and peak GiB " + "; ".join(f"{k} {ms:.3f} ({gib:.3f})" for k, (ms, gib) in timed.items())
        + f"; heads of bf16 vs fp32: {head_deltas(bf_preds, preds)}")
    del models, preds, bf_preds, frame
    gc.collect()
    torch.cuda.empty_cache()
    log(f"phase 28 took {time.perf_counter() - t_start:.1f} s")
    return rec, {f"fusion_base train step, lap_impl=auction, B={b}, 3 steps": launches,
                 f"fusion_base train CLI (tools.train), lap_impl=auction, {steps} steps, B=2": summary["launches"],
                 "fusion_base eval, DI_I2P_DTYPE=bfloat16, realistic frame, B=1": bf_launches}


def bf16_diff(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    """(max abs err, max rel err of scale, share of elements more than 1e-6
    of scale apart): a bf16 variant against its bf16 plain version."""
    err, rel = rel_err(got, ref)
    scale = ref.abs().max().item()
    return err, rel, ((got - ref).abs() > 1e-6 * scale).float().mean().item()


def realistic_frame(cfg, dev, root: str) -> dict:
    """Sample 0 of a one-scene realistic tree written under ``root`` at
    phase 19's seed (its first val frame's scene), loaded as the eval CLI
    loads it, on ``dev``."""
    write_realistic_nuscenes(root, num_scenes=1, samples_per_scene=1, num_val_scenes=1, seed=0, device=dev)
    _, val = create_nuscenes_infos(root, root, version="v1.0-trainval")
    host = next(DataLoader(NuScenesDataset(cfg, val, train=False), 1, num_workers=0).epoch(0, shuffle=False))
    host.pop("pad_count"), host.pop("token")
    return to_device(host, cfg.data, dev)


def stage_flags(cfg, batch, dev, levers: EvalLevers) -> list:
    """The banded plan's overflow flag of each stage's submanifold table on
    sample 0 of ``batch`` at ``levers``' tile and windows, with the table's
    hits a row: [(flag, hits/row)]."""
    windows = levers.banded_windows()
    stages = [c for c in encoder_tables(cfg, batch, dev, cfg.model.pts_voxel_layer.max_voxels[1], False)
              if c[0].startswith("stage")]
    return [(bool(sc.banded_overflow(nbr, valid, levers.banded_t, windows[min(i, len(windows) - 1)])),
             ((nbr < kin) & valid[:, None]).sum().item() / max(valid.sum().item(), 1))
            for i, (_, nbr, _, valid, kin, _, _, _) in enumerate(stages)]


class _TableCalls:
    """``ops/sparse_conv.py`` as the sparse encoder sees it, each call of a
    table function appended to ``calls`` as (name, args, output)."""
    NAMES = ("subm_neighbor_table", "banded_overflow", "downsample_sites", "strided_neighbor_table", "inverse_table")

    def __init__(self, calls: list):
        self.calls = calls

    def __getattr__(self, name):
        fn = getattr(sc, name)
        if name not in self.NAMES:
            return fn

        def call(*args):
            out = fn(*args)
            self.calls.append((name, args, out))
            return out

        return call


@contextlib.contextmanager
def recorded_tables(calls: list):
    """The sparse encoder's table calls appended to ``calls``, in its order,
    while the block runs."""
    saved = sparse_encoder.sc
    sparse_encoder.sc = _TableCalls(calls)
    try:
        yield
    finally:
        sparse_encoder.sc = saved


def queued_device_ms(fn, n: int = BATCH) -> float:
    """Device time of one call with the host's launch gaps taken out: the
    card sleeps while the host queues ``n`` calls between two events, which
    then time the calls' kernels back to back; the median over REPS
    samples. For calls that never wait for the card."""
    fn()
    times = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        assert not start.query(), "the card woke before the host had queued the calls"
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def replay_tables(calls: list, plain: bool) -> list:
    """Each recorded table call again on its recorded inputs, with the
    kernels or with the plain versions: the outputs, in order."""
    return [getattr(sc, name + "_plain" if plain else name)(*args) for name, args, _ in calls]


def tables_bound_bytes(calls: list) -> int:
    """The least bytes any design moves for the recorded tables: each
    stage's dense map filled once and its valid sites scattered into it
    once (the stage's submanifold and strided tables read the same map),
    its coords and valid read once, each table, inverse and output site
    written once; the overflow flag can be taken in the lookup's pass and
    adds nothing."""
    n = 0
    for name, args, out in calls:
        if name == "subm_neighbor_table":
            st = args[0]
            cells, k = st.shape[0] * st.shape[1] * st.shape[2], st.coords.shape[0]
            n += 4 * cells + 4 * int(st.valid.sum()) + 13 * k + 4 * out.numel()
        elif name == "downsample_sites":
            n += 13 * out[0].shape[0]
        elif name in ("strided_neighbor_table", "inverse_table"):
            n += 4 * out.numel()
    return n


def run_tables(dev, batch, smi: str) -> dict:
    """Phase 30: the neighbour tables of sample 0 of ``batch`` (a realistic
    frame), recorded from the sparse encoder's own forward at the defaults,
    built as the detector builds it: in eval (the overflow flags of K1's
    bf16 variant) and with gradients on as in train (the inverses). The
    launches of each forward; every table against its plain version on the
    same inputs on the card, bit for bit; the device ms of the recorded
    tables (CUDA events around back-to-back replays, and the kernels' own
    time with the host's gaps taken out, ``queued_device_ms``) and their
    wall ms, with the kernels and with the plain versions, beside the
    bound."""
    t_start = time.perf_counter()
    cfg = fusion_base_config()
    vl = cfg.model.pts_voxel_layer
    levers = EvalLevers()
    enc = sparse_encoder.SparseEncoder(cfg.model.pts_middle_encoder, levers.banded_t, levers.banded_windows()).to(dev)
    rec = {"shapes": []}
    for label, train in (("eval", False), ("train", True)):
        vo = voxelize_batched(batch["points"][:1], batch["points_mask"][:1], voxel_size=vl.voxel_size,
                              point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
                              max_voxels=vl.max_voxels[0] if train else vl.max_voxels[1])
        valid = torch.arange(vo.coords.shape[1], device=dev)[None] < vo.num_voxels[:, None]
        bf16 = levers.bf16_kernels(train, True)[0]
        calls = []
        for c in TABLES:
            c.launches = 0
        with torch.set_grad_enabled(train), recorded_tables(calls):
            enc(hard_simple_vfe(vo.voxels, vo.num_points), vo.coords, valid, bf16=bf16)
        torch.cuda.synchronize()
        launches = {c.__name__: c.launches for c in TABLES}
        assert launches == table_launches(1, train, flags=bf16), (label, launches)
        for (name, _, got), want in zip(calls, replay_tables(calls, plain=True)):
            if name == "downsample_sites":  # (coords, valid, out shape)
                assert got[2] == want[2], (label, name)
                got, want = got[:2], want[:2]
            for a, b in zip(tensors(got), tensors(want)):
                assert a.dtype == b.dtype and torch.equal(a, b), f"{label} {name}: the kernels differ from plain"
        ms = device_time_ms(lambda: replay_tables(calls, plain=False))
        # the events above also hold the gaps where the card waits for the
        # host's launches; the kernels' own time is read with the host ahead
        kernel_ms = queued_device_ms(lambda: replay_tables(calls, plain=False))
        plain_ms = device_time_ms(lambda: replay_tables(calls, plain=True))
        walls = {}
        for plain in (False, True, False, True):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            replay_tables(calls, plain=plain)
            torch.cuda.synchronize()
            walls.setdefault(plain, []).append(1e3 * (time.perf_counter() - t0))
        b = {"bound_ms": tables_bound_bytes(calls) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
             "peak": f"HBM {HBM_BYTES_PER_S / 1e12:g} TB/s"}
        shape = {"shape": f"realistic {label} frame, {int(valid.sum())} sites, the tables of 4 stages",
                 "ms": ms, "plain_ms": plain_ms, **b, "share": b["bound_ms"] / ms,
                 "kernel_ms": kernel_ms, "kernel_share": b["bound_ms"] / kernel_ms,
                 "wall_ms": min(walls[False]), "plain_wall_ms": min(walls[True]),
                 "launches": sum(launches.values()), "launches_by_wrapper": launches}
        rec["shapes"].append(shape)
        log(f"{label} tables of realistic frame sample 0 from the encoder's forward ({smi}): equal to the plain "
            f"versions bit for bit; {shape['launches']} launches {launches}; device {ms:.4f} ms by events, share "
            f"{100 * shape['share']:.1f} % (plain on the card {plain_ms:.4f}); the kernels' own {kernel_ms:.4f} ms, "
            f"share {100 * shape['kernel_share']:.1f} %; "
            f"wall {shape['wall_ms']:.3f} ms (plain {shape['plain_wall_ms']:.3f}); bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']})")
        del calls, vo, valid
    log(f"phase 30 took {time.perf_counter() - t_start:.1f} s")
    return rec


def run_bf16(dev, paths: dict, smi: str) -> tuple:
    """Phase 29: the two Pallas kernels' bf16 numerics, the JAX package's
    defaults (``DI_SPARSE_IMPL=banded``, ``DI_LOCATT_MXU=bf16``), with no
    ``DI_*`` variable set (FP32_KERNELS cleared):

    - the banded plan's overflow flag of every (frame, stage) of phase 19's
      realistic val frames;
    - K1's bf16 variant against its bf16 plain version at the submanifold
      convs' shapes of phase 19's first realistic frame (and 9 random hits a
      row), with per-tap rounding and without (``s2d``), K2's at the four
      shapes of phase 5, each with the fp32 kernel's time at the same
      inputs, its bound at the bf16 tensor-core rate and its launches a
      frame; one conv whose plan overflows, through the gated pair;
    - that frame through ``fusion_base`` from phase 19's checkpoint:
      launches (17 bf16, 4 + 17 fp32, 6 bf16 K2) and ``subm_conv.taken``
      against the flags, its 17 submanifold convs against the bf16 plain
      version and timed as they ran, the trunks against the same frame with
      both plain versions (flags and sort orders replayed) within
      BF16_TRUNK_TOL of scale, the heads logged; against the same weights
      with the fp32 kernels (the heads' distance); ms/frame and peak memory
      of each;
    - the same for ``fusion_plusplus`` (random weights, seed 0; K1 only).

    Returns the two kernels' records and the two frames' launches."""
    t_start = time.perf_counter()
    gen = torch.Generator().manual_seed(29)
    cfg = fusion_base_config()
    levers = EvalLevers()
    per_stage = [5, 4, 4, 4]  # submanifold convs a stage: conv_input and stage 0's two blocks, two blocks each

    flags = []
    for i, host in enumerate(DataLoader(NuScenesDataset(cfg, paths["val"], train=False), 1,
                                        num_workers=0).epoch(0, shuffle=False)):
        host.pop("pad_count"), host.pop("token")
        fb = to_device(host, cfg.data, dev)
        flags.append(stage_flags(cfg, fb, dev, levers))
        if i == 0:
            batch = fb
        log(f"banded plan (T={levers.banded_t}, W={levers.banded_w}) of realistic val frame {i}: overflow by stage "
            f"{[f for f, _ in flags[-1]]}, hits/row {[round(h, 2) for _, h in flags[-1]]}")
    n_fp32 = sum(n for n, (f, _) in zip(per_stage, flags[0]) if f)
    log(f"{sum(f for row in flags for f, _ in row)} of {4 * len(flags)} (frame, stage) plans overflow; the first "
        f"frame computes {n_fp32} of its 17 submanifold convs in fp32 at the defaults, as JAX does")

    k1 = {"max_abs_err": 0.0, "shapes": []}
    cases = [c for c in encoder_tables(cfg, batch, dev, cfg.model.pts_voxel_layer.max_voxels[1], False)
             if not c[0].startswith(("down", "conv_out"))]  # the strided convs stay fp32
    _, nbr0, _, valid0, k0, _, _, _ = cases[1]
    dense = torch.randint(0, k0, nbr0.shape, generator=gen, dtype=torch.int32)
    dense[torch.rand(nbr0.shape, generator=gen) >= 1 / 3] = k0
    cases.append(("random9", dense.to(dev), None, valid0, k0, 16, 16, 0))
    for name, nbr, _, valid, kin, cin, cout, n in cases:
        ko, taps = nbr.shape
        hits = ((nbr < kin) & valid[:, None]).sum().item() / max(valid.sum().item(), 1)
        feats = torch.randn(kin, cin, generator=gen).to(dev)
        w = (torch.randn(taps, cin, cout, generator=gen) / (taps * cin) ** 0.5).to(dev)
        err, rel, moved = bf16_diff(smc.subm_conv_gemm_bf16(feats, nbr, w, valid),
                                    smc.gathered_matmul(feats, nbr, w, valid, bf16=True))
        s2d_err, s2d_rel = rel_err(smc.subm_conv_gemm_bf16(feats, nbr, w, valid, per_tap=False),
                                   smc.gathered_matmul(feats, nbr, w, valid, bf16=True, per_tap=False))
        t = timing(lambda: smc.subm_conv_gemm_bf16(feats, nbr, w, valid),
                   lambda: smc.gathered_matmul(feats, nbr, w, valid, bf16=True),
                   k1_bound("fwd", nbr, valid, kin, cin, cout, "bf16"), n)
        t["fp32_ms"] = device_time_ms(lambda: smc.subm_conv_gemm(feats, nbr, w, valid))
        t["s2d_ms"] = device_time_ms(lambda: smc.subm_conv_gemm_bf16(feats, nbr, w, valid, per_tap=False))
        shape = f"realistic {name}, K={kin}->{ko} {cin}->{cout} {taps} taps, {hits:.2f} hits/row"
        log(f"K1 subm_conv_gemm_bf16 {shape}: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tolerance "
            f"{K1_BF16_TOL}), {moved:.2e} of the outputs more than 1e-6 of scale apart (at most "
            f"{BF16_MOVED_SHARE}); {timing_text(t)} fp32_kernel_ms={t['fp32_ms']:.4f}; s2d (per_tap=False) "
            f"max_rel_err={s2d_rel:.3e} (tolerance {K1_TOL}) s2d_ms={t['s2d_ms']:.4f}")
        assert rel <= K1_BF16_TOL and moved <= BF16_MOVED_SHARE, f"K1 bf16 {name}: {rel:.3e}, {moved:.2e}"
        assert s2d_rel <= K1_TOL, f"K1 s2d {name}: {s2d_rel:.3e}"
        k1["max_abs_err"] = max(k1["max_abs_err"], err, s2d_err)
        k1["shapes"].append(dict(t, shape=shape, max_rel_err=rel, s2d_max_rel_err=s2d_rel))
    k1["ms_per_frame"] = sum(t["launch_ms"] for t in k1["shapes"])
    k1["fp32_ms_per_frame"] = sum(t["launches"] * t["fp32_ms"] for t in k1["shapes"])
    log(f"K1 subm_conv_gemm_bf16 per realistic fusion_base frame (17 convs on the bf16 kernel): sum of "
        f"launches*ms = {k1['ms_per_frame']:.4f} ms, the fp32 kernel's at the same convs "
        f"{k1['fp32_ms_per_frame']:.4f} ms ({smi})")

    # one conv whose plan overflows (stage 0's table in 8-row windows): the
    # gated pair launches both kernels and the fp32 one computes it
    ovf = sc.banded_overflow(nbr0, valid0, levers.banded_t, 8)
    feats = torch.randn(k0, 16, generator=gen).to(dev)
    w = (torch.randn(27, 16, 16, generator=gen) / (27 * 16) ** 0.5).to(dev)
    for c in COUNTED:
        c.launches = 0
    smc.taken(dev).zero_()
    out = smc.subm_conv_gemm_bf16(feats, nbr0, w, valid0, ovf=ovf)
    torch.cuda.synchronize()
    launches, taken = {c.__name__: c.launches for c in COUNTED}, smc.taken(dev).tolist()
    same = torch.equal(out, smc.subm_conv_gemm(feats, nbr0, w, valid0))
    log(f"an overflowing conv (stage 0's table, W=8, flag {bool(ovf)}): launches {launches}, taken [fp32, bf16] = "
        f"{taken}, the fp32 kernel's bits: {same}")
    assert bool(ovf) and taken == [1, 0] and same, (bool(ovf), taken, same)
    assert launches == expect_launches(subm_conv_gemm=1, subm_conv_gemm_bf16=1), launches

    k2 = {"max_abs_err": 0.0, "shapes": []}
    for shape, n in (((6, 112, 200, 128), 4), ((1, 180, 180, 128), 2), ((12, 112, 200, 128), 0),
                     ((2, 180, 180, 128), 0)):
        q, k, v = (torch.randn(shape, generator=gen).to(dev) for _ in range(3))
        err, rel, moved = bf16_diff(la.local_attn_fwd_bf16(q, k, v, 9), la.local_attention(q, k, v, 9, bf16=True))
        b, h, w, c = shape
        t = timing(lambda: la.local_attn_fwd_bf16(q, k, v, 9), lambda: la.local_attention(q, k, v, 9, bf16=True),
                   bound(4 * 4 * b * h * w * c, flops.k2_ops(shape, 9), "bf16"), n)
        t["fp32_ms"] = device_time_ms(lambda: la.local_attn_fwd(q, k, v, 9))
        info = la.bf16_kernel_info(9)
        log(f"K2 local_attn_fwd_bf16 {list(shape)} k=9: max_abs_err={err:.3e} max_rel_err={rel:.3e} (tolerance "
            f"{K2_BF16_TOL}), {moved:.2e} of the outputs more than 1e-6 of scale apart (at most "
            f"{BF16_MOVED_SHARE}); {timing_text(t)} "
            f"fp32_kernel_ms={t['fp32_ms']:.4f}; kernel: {info['registers']} registers and {info['spill_bytes']} "
            f"spilled bytes a thread, {info['shared_bytes']} shared bytes and {info['threads']} threads a block, "
            f"{info['blocks_per_sm']} blocks = {info['warps_per_sm']} warps an SM")
        t.update(info)
        assert rel <= K2_BF16_TOL and moved <= BF16_MOVED_SHARE, f"K2 bf16 {list(shape)}: {rel:.3e}, {moved:.2e}"
        k2["max_abs_err"] = max(k2["max_abs_err"], err)
        k2["shapes"].append(dict(t, shape=f"{list(shape)} k=9", max_rel_err=rel))
        del q, k, v
    k2["ms_per_frame"] = sum(t["launch_ms"] for t in k2["shapes"])
    k2["fp32_ms_per_frame"] = sum(t["launches"] * t["fp32_ms"] for t in k2["shapes"])
    log(f"K2 local_attn_fwd_bf16 per fusion_base eval frame: sum of launches*ms = {k2['ms_per_frame']:.4f} ms, "
        f"the fp32 kernel's {k2['fp32_ms_per_frame']:.4f} ms")

    def frames(model, config, fbatch, trunks, want, taken_want, label, convs=None):
        """The frame at the defaults (launches, ``taken``, trunks and heads
        against the plain versions; with ``convs``, each submanifold conv's
        inputs recorded into it), then with the fp32 kernels; ms/frame of
        each."""
        captured = {}
        hooks = [model.get_submodule(n).register_forward_hook(lambda m, a, o, n=n: captured.__setitem__(n, o))
                 for n in trunks]
        kernel = sparse_encoder.subm_conv_gemm

        def record(f, nbr, w, valid, inv=None, bf16=False, per_tap=True, ovf=None):
            if bf16 and convs is not None:
                convs.append((f, nbr, w, valid, per_tap, ovf))
            return kernel(f, nbr, w, valid, inv, bf16=bf16, per_tap=per_tap, ovf=ovf)

        orders, flips = [], []
        sparse_encoder.subm_conv_gemm = record
        try:
            for c in COUNTED:
                c.launches = 0
            smc.taken(dev).zero_()
            with sort_orders(orders, False, flips):
                preds = model(fbatch)
            torch.cuda.synchronize()
        finally:
            sparse_encoder.subm_conv_gemm = kernel
        launches, taken = {c.__name__: c.launches for c in COUNTED}, smc.taken(dev).tolist()
        log(f"{label} at the JAX defaults {model.levers}, realistic frame, B=1: launches {launches}, "
            f"taken [fp32, bf16] = {taken}")
        assert launches == want and taken == taken_want, (launches, taken)
        assert all(torch.isfinite(v.float()).all() for v in preds.values())
        kern = dict(captured)
        with plain_kernels(), sort_orders(orders, True, flips):
            plain = model(fbatch)
        torch.cuda.synchronize()
        for h in hooks:
            h.remove()
        trunk_err = {f"{n}[{i}]": rel_err(a, b)[1] for n in trunks
                     for i, (a, b) in enumerate(zip(tensors(kern[n]), tensors(captured[n])))}
        exact = {k: torch.equal(preds[k], plain[k]) for k in ("query_labels", "on_image_masks")}
        log(f"{label}, bf16 kernels vs bf16 plain versions (sort orders replayed; {sum(flips)} of {len(flips)} sorts "
            f"differed): trunks (max rel err, tolerance {BF16_TRUNK_TOL}) "
            + ", ".join(f"{k} {v:.3e}" for k, v in trunk_err.items())
            + f"; heads {head_deltas(preds, plain)}; exact {exact}")
        assert max(trunk_err.values()) <= BF16_TRUNK_TOL, trunk_err
        bf16_levers = model.levers
        model.levers = dataclasses.replace(bf16_levers, **{ENV[k][0]: v for k, v in FP32_KERNELS.items()})
        fp32 = model(fbatch)
        timed = {"fp32 kernels": frame_ms(model, fbatch, config, config.test_num_proposals)}
        model.levers = bf16_levers
        timed["defaults (bf16 kernels)"] = frame_ms(model, fbatch, config, config.test_num_proposals)
        log(f"{label} + get_bboxes, realistic frame, B=1 ({smi}): ms/frame and peak GiB "
            + "; ".join(f"{k} {ms:.3f} ({gib:.3f})" for k, (ms, gib) in timed.items())
            + f"; heads of the defaults vs the fp32 kernels: {head_deltas(preds, fp32)}")
        return launches, {k: ms for k, (ms, _) in timed.items()}

    with defaults_env():
        assert EvalLevers.from_env() == levers, EvalLevers.from_env()
        model = load_weights(paths["ckpt"], DeepInteraction(cfg.model, cfg.data.padded_img_shape,
                                                            cfg.test_num_proposals).to(dev).eval())
        convs = []
        launches, ms = frames(model, cfg, batch, ("pts_middle_encoder", "imgpts_neck"),
                              expect_launches(subm_conv_gemm=4 + 17, subm_conv_gemm_bf16=17, local_attn_fwd_bf16=6,
                                              **table_launches(1, flags=True)),
                              [n_fp32, 17 - n_fp32], "fusion_base eval", convs)
        # the frame's 17 submanifold convs on their own inputs, gated as they
        # ran: against the plain version, and timed (the frame's K1 time at
        # the defaults) beside the fp32 kernel and the bf16 kernel ungated
        frame = {"convs": len(convs), "ms": 0.0, "fp32_ms": 0.0, "bf16_ms": 0.0, "max_rel_err": 0.0}
        for f, nbr, w, valid, per_tap, ovf in convs:
            _, rel, moved = bf16_diff(smc.subm_conv_gemm_bf16(f, nbr, w, valid, per_tap=per_tap, ovf=ovf),
                                      smc.plain_conv(f, nbr, w, valid, True, per_tap, ovf))
            assert rel <= K1_BF16_TOL and moved <= BF16_MOVED_SHARE, (tuple(f.shape), rel, moved)
            frame["max_rel_err"] = max(frame["max_rel_err"], rel)
            frame["ms"] += device_time_ms(lambda: smc.subm_conv_gemm_bf16(f, nbr, w, valid, per_tap=per_tap, ovf=ovf))
            frame["fp32_ms"] += device_time_ms(lambda: smc.subm_conv_gemm(f, nbr, w, valid))
            frame["bf16_ms"] += device_time_ms(lambda: smc.subm_conv_gemm_bf16(f, nbr, w, valid, per_tap=per_tap))
        log(f"fusion_base eval frame's {frame['convs']} submanifold convs on their own inputs: max rel err "
            f"{frame['max_rel_err']:.3e} against the bf16 plain version (tolerance {K1_BF16_TOL}); K1 at the "
            f"defaults (gated pairs) {frame['ms']:.4f} ms a frame, the bf16 kernel ungated {frame['bf16_ms']:.4f}, "
            f"the fp32 kernel {frame['fp32_ms']:.4f} ({smi})")
        assert frame["convs"] == 17, frame
        k1["frame"] = frame
        del model, batch, convs
        gc.collect()
        torch.cuda.empty_cache()
        pcfg = fusion_plusplus_config()
        host = next(DataLoader(NuScenesDataset(pcfg, paths["val"], train=False), 1, num_workers=0).epoch(
            0, shuffle=False))
        host.pop("pad_count"), host.pop("token")
        pbatch = to_device(host, pcfg.data, dev)
        pp_fp32 = sum(n for n, (f, _) in zip(per_stage, stage_flags(pcfg, pbatch, dev, levers)) if f)
        model = DeepInteraction(pcfg.model, pcfg.data.padded_img_shape, pcfg.test_num_proposals).to(dev).eval()
        init_weights(model, seed=0)
        pp_launches, pp_ms = frames(model, pcfg, pbatch, ("pts_middle_encoder", "img_neck", "imgpts_neck"),
                                    expect_launches(subm_conv_gemm=4 + 17, subm_conv_gemm_bf16=17,
                                                    **table_launches(1, flags=True)),
                                    [pp_fp32, 17 - pp_fp32], "fusion_plusplus eval")
    del model, pbatch
    gc.collect()
    torch.cuda.empty_cache()
    k1.update(frame_ms=ms, pp_frame_ms=pp_ms, overflow_flags=[[f for f, _ in row] for row in flags])
    log(f"phase 29 took {time.perf_counter() - t_start:.1f} s")
    return k1, k2, {"fusion_base eval at the JAX defaults (bf16 kernels), realistic frame, B=1": launches,
                    "fusion_plusplus eval at the JAX defaults (bf16 kernels), realistic frame, B=1": pp_launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} CUDA {torch.version.cuda} python {sys.version.split()[0]}")
    nvcc = subprocess.run([cuda_lib._nvcc(), "--version"], capture_output=True, text=True, check=True)
    log(nvcc.stdout.strip().splitlines()[-1])

    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:  # the nvJPEG binding and the sweep reader build beside the kernels
        jpeg_lib = pool.submit(jpeg.build)
        points_lib = pool.submit(native.build)
        lib = cuda_lib.build()
        log(f"built {lib}, {jpeg_lib.result()} and {points_lib.result()} in {time.perf_counter() - t0:.1f} s")
    cuda_lib.library()
    jpeg.library()
    native.library()

    cuda_lib.fp32_numerics()
    os.environ.update(FP32_KERNELS)  # phases 4-28; phase 29 clears them

    gen = torch.Generator().manual_seed(0)
    k1_eval, k2, eval_launches, slice_t = run_slice(dev, gen)
    k1, train_launches, lidar_t = run_lidar(dev, gen)
    k2b, fusion_launches, fusion_t = run_fusion_train(dev, gen)
    pp_launches = run_pp(dev)
    pp_train_launches = run_pp_train(dev)
    try:
        cli_launches, _, k1_real, paths = run_eval_cli(dev, gen)
        measured = {"eval_ms": slice_t["ms"], "eval_peak_gib": slice_t["peak_gib"], "fusion_ms": fusion_t["ms"],
                    "fusion_peak_gib": fusion_t["peak_gib"], "lidar_keys": lidar_t["metric_keys"],
                    "fusion_keys": fusion_t["metric_keys"]}
        fusion_run, cli_paths = run_train_cli(dev, paths["ckpt"], measured)
        cli_paths.update(run_dist(paths, fusion_run, cli_launches))
        run_host_side(dev, paths["val"])
        run_tools()
        lever_launches = run_levers(dev, paths, smi)
        auction, auction_paths = run_auction(dev, paths, fusion_run["train_pkl"], measured["fusion_keys"], smi)
        k1_bf16, k2_bf16, bf16_paths = run_bf16(dev, paths, smi)
        host = next(DataLoader(NuScenesDataset(fusion_base_config(), paths["val"], train=False), 1,
                               num_workers=0).epoch(0, shuffle=False))
        host.pop("pad_count"), host.pop("token")
        tables = run_tables(dev, to_device(host, fusion_base_config().data, dev), smi)
    finally:
        shutil.rmtree(SMOKE_DIR, ignore_errors=True)

    src = "deepinteraction_tpu_torch/csrc/subm_conv.cu"
    eval_path, train_path = "fusion_base eval, B=1", "lidar_only train step, B=2"
    fusion_path, pp_path = "fusion_base train step, B=2", "fusion_plusplus eval, B=1"
    pp_train_path = "fusion_plusplus train step, B=2"
    bf16_path = next(iter(bf16_paths))  # the fusion_base frame at the JAX defaults
    cli_path = "fusion_base eval CLI (tools.test), 9 frames, B=2"
    lever_paths = {"fusion_base": "fusion_base eval at the JAX defaults, realistic frame, B=1",
                   "fusion_plusplus": "fusion_plusplus eval at the JAX defaults, realistic frame, B=1"}

    def by_path(name, eval_n=0):
        # "sparse_tables": the six table wrappers together
        n = tables_total if name == "sparse_tables" else (lambda counts: counts[name])
        return {eval_path: eval_n, train_path: n(train_launches), fusion_path: n(fusion_launches),
                pp_path: n(pp_launches), pp_train_path: n(pp_train_launches), cli_path: n(cli_launches),
                **{path: n(counts) for path, counts in cli_paths.items()},
                **{lever_paths[k]: n(counts) for k, counts in lever_launches.items()},
                **{path: n(counts) for path, counts in auction_paths.items()},
                **{path: n(counts) for path, counts in bf16_paths.items()}}

    fwd = dict(k1["fwd"], shapes=k1_eval["shapes"] + k1["fwd"]["shapes"] + k1_real["shapes"],
               ms_per_frame=k1_eval["ms_per_frame"], ms_per_realistic_frame=k1_real["ms_per_frame"],
               max_abs_err=max(k1_eval["max_abs_err"], k1["fwd"]["max_abs_err"], k1_real["max_abs_err"]))
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
        {"name": "subm_conv_gemm_bf16", "route": "cuda", "source": "deepinteraction_tpu_torch/csrc/subm_conv_bf16.cu",
         "replaces": "deepinteraction_tpu/ops/sparse_conv_banded.py:98", **headline(k1_bf16, "realistic stage3"),
         "launches": bf16_paths[bf16_path]["subm_conv_gemm_bf16"], "path": bf16_path,
         "launches_by_path": by_path("subm_conv_gemm_bf16"), "library_ms": None},
        {"name": "local_attn_fwd_bf16", "route": "cuda",
         "source": "deepinteraction_tpu_torch/csrc/local_attention_bf16.cu",
         "replaces": "deepinteraction_tpu/ops/local_attention_pallas.py:58", **headline(k2_bf16, "[6, 112, 200, 128]"),
         "launches": bf16_paths[bf16_path]["local_attn_fwd_bf16"], "path": bf16_path,
         "launches_by_path": by_path("local_attn_fwd_bf16"), "library_ms": None},
        {"name": "auction_lap", "route": "cuda", "source": "deepinteraction_tpu_torch/csrc/auction_lap.cu",
         "replaces": "deepinteraction_tpu/ops/hungarian.py:82", **auction,
         "path": "fusion_base train step, lap_impl=auction, B=2", "launches_by_path": by_path("auction_lap"),
         "library_ms": None},
        {"name": "sparse_tables", "route": "cuda", "source": "deepinteraction_tpu_torch/csrc/sparse_tables.cu",
         "replaces": None, **headline(tables, "realistic eval"),
         **{k: tables["shapes"][0][k] for k in ("kernel_ms", "kernel_share")},
         "launches": tables_total(bf16_paths[bf16_path]), "path": bf16_path,
         "launches_by_path": by_path("sparse_tables", tables_total(eval_launches)), "library_ms": None},
    ]
    log(f"chip_smoke.py took {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
