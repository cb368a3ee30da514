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
4. K1 (``subm_conv_gemm``) against its plain version at the stage-0 and
   stage-3 shapes of the synthetic batch's sparse tables;
5. K2 (``local_attn_fwd``) against its plain version at [6,112,200,128]
   and [1,180,180,128], k=9;
6. the tiny config on the card against the port's CPU path (which the CPU
   tests hold to the JAX package);
7. the full slice through the kernels, with the launch counters set to 0
   just before and read just after; then once with every kernel swapped
   for its plain version, comparing the sparse encoder's BEV map and the
   MMRI outputs; then ms/frame and peak memory.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. Usage: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time

import torch

from deepinteraction_tpu.configs import fusion_base_config, tiny_config
from deepinteraction_tpu_torch.inference import get_bboxes
from deepinteraction_tpu_torch.models import mmri_encoder, sparse_encoder
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops import cuda_lib
from deepinteraction_tpu_torch.ops import local_attention as la
from deepinteraction_tpu_torch.ops import sparse_conv as sc
from deepinteraction_tpu_torch.ops import subm_conv as smc
from deepinteraction_tpu_torch.ops.voxelize import voxelize
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch

# K1 and K2 compute in fp32 like their plain versions; only the summation
# order differs
K1_TOL = 1e-4  # max|kernel - plain| / max|plain|
K2_TOL = 2e-5  # absolute and relative, as torch.testing.assert_close
SLICE_TOL = 1e-3  # max|d| / max|plain| for the BEV map and MMRI outputs
TINY_RTOL, TINY_ATOL = 2e-3, 5e-4  # the golden fixtures' tolerance
REPS, WARMUP = 10, 3


def log(*a):
    print(*a, flush=True)


def device_time_ms(fn) -> float:
    """Median CUDA-event time of one call, over REPS after WARMUP calls."""
    for _ in range(WARMUP):
        fn()
    times = []
    for _ in range(REPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> tuple:
    err = (got - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


@contextlib.contextmanager
def plain_kernels():
    """Swap K1 and K2 for their plain versions where the model calls them
    (the reference run of phase 7); restored on exit."""
    saved = (sparse_encoder.subm_conv_gemm, mmri_encoder.local_attn_fwd)
    sparse_encoder.subm_conv_gemm = smc.gathered_matmul
    mmri_encoder.local_attn_fwd = la.local_attention
    try:
        yield
    finally:
        sparse_encoder.subm_conv_gemm, mmri_encoder.local_attn_fwd = saved


def stage_tables(cfg, batch, dev):
    """Sparse tables of the synthetic batch: (K, nbr) of stage 0 and 3."""
    vl = cfg.model.pts_voxel_layer
    enc = cfg.model.pts_middle_encoder
    vo = voxelize(batch["points"][0], batch["points_mask"][0], voxel_size=vl.voxel_size,
                  point_cloud_range=vl.point_cloud_range, max_num_points=vl.max_num_points,
                  max_voxels=vl.max_voxels[1])
    coords = vo.coords
    valid = torch.arange(coords.shape[0], device=dev) < vo.num_voxels
    shape = tuple(enc.sparse_shape)
    tables = {0: (valid, sc.subm_neighbor_table(sc.SparseTensor(None, coords, valid, shape)))}
    for i, pad in enumerate(sparse_encoder.SparseEncoder.STRIDED_PADS):
        coords, valid, shape = sc.downsample_sites(
            coords, valid, shape, (3, 3, 3), (2, 2, 2), pad, enc.stage_capacities[i + 1]
        )
    tables[3] = (valid, sc.subm_neighbor_table(sc.SparseTensor(None, coords, valid, shape)))
    return tables


def check_k1(cfg, batch, dev, gen):
    tables = stage_tables(cfg, batch, dev)
    rec = {"max_abs_err": 0.0}
    for stage, cin, cout in ((0, 16, 16), (3, 128, 128)):
        valid, nbr = tables[stage]
        k = nbr.shape[0]
        hits = (nbr < k).float().mean().item() * 27
        feats = torch.randn(k, cin, generator=gen).to(dev)
        w = (torch.randn(27, cin, cout, generator=gen) / (27 * cin) ** 0.5).to(dev)
        out = smc.subm_conv_gemm(feats, nbr, w, valid)
        ref = smc.gathered_matmul(feats, nbr, w, valid)
        err, rel = rel_err(out, ref)
        assert rel <= K1_TOL, f"K1 stage {stage}: max rel err {rel:.3e} > {K1_TOL}"
        ms = device_time_ms(lambda: smc.subm_conv_gemm(feats, nbr, w, valid))
        plain_ms = device_time_ms(lambda: smc.gathered_matmul(feats, nbr, w, valid))
        log(f"K1 subm_conv_gemm stage{stage} K={k} {cin}->{cout} taps hit/row={hits:.2f}: "
            f"max_abs_err={err:.3e} max_rel_err={rel:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if stage == 0:
            rec.update(ms=ms, plain_ms=plain_ms, shape=f"K={k} {cin}->{cout} 27 taps")
    # the synthetic cloud is uniform, so its stage-0 table is nearly empty
    # beyond the centre tap; time a table with 9 random hits per row too
    valid, nbr = tables[0]
    k = nbr.shape[0]
    dense = torch.randint(0, k, nbr.shape, generator=gen, dtype=torch.int32)
    dense[torch.rand(nbr.shape, generator=gen) >= 1 / 3] = k
    dense = dense.to(dev)
    feats = torch.randn(k, 16, generator=gen).to(dev)
    w = (torch.randn(27, 16, 16, generator=gen) / (27 * 16) ** 0.5).to(dev)
    err, rel = rel_err(smc.subm_conv_gemm(feats, dense, w, valid), smc.gathered_matmul(feats, dense, w, valid))
    assert rel <= K1_TOL, f"K1 random table: max rel err {rel:.3e} > {K1_TOL}"
    ms = device_time_ms(lambda: smc.subm_conv_gemm(feats, dense, w, valid))
    plain_ms = device_time_ms(lambda: smc.gathered_matmul(feats, dense, w, valid))
    log(f"K1 subm_conv_gemm random table K={k} 16->16 taps hit/row=9: "
        f"max_abs_err={err:.3e} max_rel_err={rel:.3e} kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)
    return rec


def check_k2(dev, gen):
    rec = {"max_abs_err": 0.0}
    for shape in ((6, 112, 200, 128), (1, 180, 180, 128)):
        q, k, v = (torch.randn(shape, generator=gen).to(dev) for _ in range(3))
        out = la.local_attn_fwd(q, k, v, 9)
        ref = la.local_attention(q, k, v, 9)
        torch.testing.assert_close(out, ref, atol=K2_TOL, rtol=K2_TOL)
        err, rel = rel_err(out, ref)
        ms = device_time_ms(lambda: la.local_attn_fwd(q, k, v, 9))
        plain_ms = device_time_ms(lambda: la.local_attention(q, k, v, 9))
        log(f"K2 local_attn_fwd {list(shape)} k=9: max_abs_err={err:.3e} max_rel_err={rel:.3e} "
            f"kernel_ms={ms:.4f} plain_ms={plain_ms:.4f}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if shape[0] == 6:
            rec.update(ms=ms, plain_ms=plain_ms, shape=f"{list(shape)} k=9")
    return rec


def check_tiny(dev):
    """The tiny config on the card (kernels) vs the port's CPU path."""
    cfg = tiny_config()
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
    log(f"tiny_config slice on the card == CPU path on {len(ref)} heads "
        f"(rtol {TINY_RTOL}, atol {TINY_ATOL}; labels and masks exact)")


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
    check_tiny(dev)

    smc.subm_conv_gemm.launches = 0
    la.local_attn_fwd.launches = 0
    preds = model(batch)
    torch.cuda.synchronize()
    launches = {"subm_conv_gemm": smc.subm_conv_gemm.launches, "local_attn_fwd": la.local_attn_fwd.launches}
    log(f"main path launches per frame: {launches}")
    assert launches["subm_conv_gemm"] >= 17, launches
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
    k1, k2, launches = run_slice(dev, gen)

    kernels = [
        {"name": "subm_conv_gemm", "route": "cuda",
         "source": "deepinteraction_tpu_torch/csrc/subm_conv.cu",
         "replaces": "deepinteraction_tpu/ops/sparse_conv_banded.py:98",
         "launches": launches["subm_conv_gemm"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"], "shape": k1["shape"]},
        {"name": "local_attn_fwd", "route": "cuda",
         "source": "deepinteraction_tpu_torch/csrc/local_attention.cu",
         "replaces": "deepinteraction_tpu/ops/local_attention_pallas.py:58",
         "launches": launches["local_attn_fwd"], "max_abs_err": k2["max_abs_err"],
         "ms": k2["ms"], "plain_ms": k2["plain_ms"], "shape": k2["shape"]},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
