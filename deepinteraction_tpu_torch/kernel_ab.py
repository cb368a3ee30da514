"""Time the port's kernels against another build of their C interface, in turns.

A kernel redesign is judged on one card in one process: two calls can land
on cards with other power limits. This builds the tree's kernels
(``ops/cuda_lib.py``) and every ``*.cu`` in another directory (an earlier
commit's ``csrc``, or a variant of it) with the same nvcc flags, then, at the
main-path shapes:

- K2 ``local_attn_fwd`` at [6,112,200,128] and [1,180,180,128], k = 9, and
  its bf16 variant ``local_attn_fwd_bf16`` at the same shapes;
- K2's backward ``local_attn_bwd`` at [12,112,200,128] and [2,180,180,128],
  k = 9 (the ``fusion_base`` train step's shapes), each of dq, dk, dv held
  to 1e-4 of its scale; its two scratch buffers are allocated at
  B*H*W*k^2 floats, the most any build of its C interface takes (builds up
  to commit 8b7bc36 keep P and dS there; later ones B*H*W floats each);
- K1 ``subm_conv_gemm`` at the nine conv shapes of one ``fusion_base`` eval
  frame, and K1 as d/dfeat over the ``lidar_only`` train tables
  (``chip_smoke.encoder_tables`` and ``chip_smoke.train_tables``);
- K1's bf16 variant ``subm_conv_gemm_bf16`` at the five submanifold conv
  shapes of a realistic ``fusion_base`` frame (``chip_smoke.
  realistic_frame``, a one-scene tree of the realistic writer under
  ``work_dirs/``), with per-tap rounding and, where both builds have it,
  without (``s2d``), and as d/dfeat over the same tables, with the sum of
  launches x time over the frame's 17 convs: the tree's path with its casts
  (the wrapper's ``bf16_operand`` of feat and w, then ``di_subm_conv_bf16``)
  against an earlier build's ``di_subm_conv_gemm_bf16`` (fp32 operands,
  rounded in registers) or its path with casts;
- K1's d/dW ``subm_conv_wgrad`` over the same train tables, with the sum of
  launches x time of each build over one ``lidar_only`` step (B=2);

checks both builds against the plain versions at the tolerances of
``chip_smoke.py`` (the bf16 variants against their bf16 plain versions, and
only where both builds have them), says whether the two builds give the
same bits (``equal=``), and times them in the order other, tree, tree, other
(CUDA-event medians of ``chip_smoke.device_time_ms``). ``--mma-peak`` first
times ``mma.sync`` m16n8k8 TF32 alone, on registers, across the card: the
ceiling of the split-TF32 products. Run from the root of a checkout, here
against the fp32 CUDA-core d/dW of commit f0040e7::

    mkdir -p work_dirs/old_csrc
    for f in subm_conv.cu local_attention.cu tf32_mma.cuh; do
        git show f0040e7:deepinteraction_tpu_torch/csrc/$f > work_dirs/old_csrc/$f
    done
    python -m deepinteraction_tpu_torch.kernel_ab work_dirs/old_csrc

K1's bf16 path against its build before the bf16 kernel's redesign
(commit e20e1a6, which still read fp32 operands)::

    mkdir -p work_dirs/bf16_csrc
    git archive e20e1a6 deepinteraction_tpu_torch/csrc | tar -x -C work_dirs/bf16_csrc --strip-components=2
    python -m deepinteraction_tpu_torch.kernel_ab work_dirs/bf16_csrc --match bf16

and K2's three kernels against the build before the bf16 forward's
redesign (commit b27c4af, where it shared the fp32 kernel's tiles): the
bf16 forward's times, and ``equal=True`` on the fp32 forward and backward
cases, which kept their code::

    mkdir -p work_dirs/k2bf16_csrc
    git archive b27c4af deepinteraction_tpu_torch/csrc | tar -x -C work_dirs/k2bf16_csrc --strip-components=2
    python -m deepinteraction_tpu_torch.kernel_ab work_dirs/k2bf16_csrc --match local_attn

The auction LAP (``auction_lap``) on phase 28's two problems (the
``fusion_base`` B=2 train step's matching costs, recorded from one callback
step of ``chip_smoke.py``'s seeded weights and batch, and a uniform(0, 10)
200 x 200 cost with 30 GTs), both builds held to the plain version exactly
in assignment and rounds, with the largest round count, microseconds a
round, and a floor on a round's latency: an empty round (the kernel's
block, its bitset count and its two barriers, no scans). It prints the
kernel's ``-Xptxas -v`` lines first. Against the build before its
redesign (commit 8c28268)::

    mkdir -p work_dirs/auction_csrc
    git archive 8c28268 deepinteraction_tpu_torch/csrc | tar -x -C work_dirs/auction_csrc --strip-components=2
    python -m deepinteraction_tpu_torch.kernel_ab work_dirs/auction_csrc --match auction [--auction-sweep]

``--auction-sweep`` also times the tree's kernel built at other block
sizes and solo thresholds (``DI_AUCTION_THREADS``,
``DI_AUCTION_SOLO_BELOW``) against the tree's build, in turns.

``--match`` selects the cases whose label holds its text (a text that
starts with ``auction`` selects the auction's cases alone); the realistic
frame is written only where a bf16 K1 label can match. Fails without a
CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import glob
import math
import os
import re
import shutil
import subprocess
import tempfile

import torch

import chip_smoke as cs

from .configs import fusion_base_config, lidar_only_config
from .models.detector import DeepInteraction
from .ops import cuda_lib, hungarian
from .ops import local_attention as la
from .ops import sparse_conv as sc
from .ops import subm_conv as smc
from .train.step import TrainStep
from .utils.synthetic import init_weights, make_synthetic_batch, to_torch

_MMA_PEAK = r"""
#include "tf32_mma.cuh"
__global__ void mma_peak_kernel(float* out, int iters) {
  float d[8][4] = {};
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = di::tf32_rna(threadIdx.x * 1e-3f + i);
  for (int i = 0; i < 2; ++i) b[i] = di::tf32_rna(threadIdx.x * 2e-3f + i);
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int j = 0; j < 8; ++j) di::mma_tf32(d[j], a, b);
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int mma_peak(void* out, int blocks, int iters, void* stream) {
  mma_peak_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<float*>(out), iters);
  return static_cast<int>(cudaGetLastError());
}
"""


# A floor on one auction round's latency: the kernel's block, its count
# of the open-column bitset (a load, popc, redux.sync) and its two block
# barriers with a shared atomicMax and a write between them, no scans.
_EMPTY_ROUNDS = r"""
#include <stdint.h>
__global__ void empty_rounds_kernel(int* out, int rounds, int words) {
  __shared__ uint32_t open[64];
  __shared__ unsigned long long key[32];
  const int lane = threadIdx.x & 31;
  for (int q = threadIdx.x; q < 64; q += blockDim.x) open[q] = 0x55555555u;
  if (threadIdx.x < 32) key[threadIdx.x] = 0ull;
  __syncthreads();
  int acc = 0;
  for (int r = 0; r < rounds; ++r) {
    int n = 0;
    for (int q = lane; q < words; q += 32) n += __popc(open[q]);
    n = __reduce_add_sync(0xffffffffu, n);
    if (lane == 0) atomicMax(key + (r & 31), (unsigned long long)(n + r));
    __syncthreads();
    if (threadIdx.x == 0) open[r % words] ^= 1u;
    __syncthreads();
    acc += n;
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}
extern "C" int empty_rounds(void* out, int blocks, int threads, int rounds, int words, void* stream) {
  empty_rounds_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<int*>(out), rounds,
                                                                               words);
  return static_cast<int>(cudaGetLastError());
}
"""


def build_other(src_dir: str, out_dir: str) -> ctypes.CDLL:
    """Every ``*.cu`` of ``src_dir`` (headers from there, then the tree's
    ``csrc``) into one library bound like the tree's."""
    nvcc = cuda_lib._nvcc()
    sources = sorted(glob.glob(os.path.join(src_dir, "*.cu")))
    objs = [os.path.join(out_dir, os.path.basename(s) + ".o") for s in sources]
    inc = ["-I", src_dir, "-I", cuda_lib.CSRC_DIR]
    cuda_lib._run([subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, *inc, "-c", "-o", o, s],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                   for s, o in zip(sources, objs)])
    so = os.path.join(out_dir, "libother.so")
    cuda_lib._run([subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", so, *objs],
                                    stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
    lib = ctypes.CDLL(so)
    for name, (argtypes, restype) in {**cuda_lib._SIGNATURES, "di_subm_conv_gemm_bf16": _OLD_BF16}.items():
        if hasattr(lib, name):  # an earlier build may lack an entry (the bf16 variants)
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib


def mma_peak(out_dir: str) -> None:
    """TFLOP/s of mma.sync m16n8k8 TF32 with 8 independent accumulators a
    warp, 4 and 8 blocks of 4 warps an SM."""
    src = os.path.join(out_dir, "mma_peak.cu")
    with open(src, "w") as f:
        f.write(_MMA_PEAK)
    so = os.path.join(out_dir, "libmma_peak.so")
    cuda_lib._run([subprocess.Popen([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-I", cuda_lib.CSRC_DIR, "-shared",
                                     "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)])
    lib = ctypes.CDLL(so)
    lib.mma_peak.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for per_sm in (4, 8):
        blocks = per_sm * sms
        out = torch.empty(blocks * 128, device="cuda")
        ms = cs.device_time_ms(lambda: lib.mma_peak(out.data_ptr(), blocks, iters, cuda_lib.stream_ptr(out.device)))
        flops = blocks * 4 * iters * 8 * 2 * 16 * 8 * 8
        print(f"mma.sync m16n8k8 tf32, {per_sm} blocks of 4 warps an SM: {ms:.4f} ms, "
              f"{flops / ms / 1e9:.1f} TFLOP/s", flush=True)


def auction_settings() -> tuple:
    """The tree's auction block size and solo threshold
    (``DI_AUCTION_THREADS``, ``DI_AUCTION_SOLO_BELOW`` in its source)."""
    with open(os.path.join(cuda_lib.CSRC_DIR, "auction_lap.cu")) as f:
        src = f.read()
    return tuple(int(re.search(rf"#define {name} (\d+)", src).group(1))
                 for name in ("DI_AUCTION_THREADS", "DI_AUCTION_SOLO_BELOW"))


def build_auction(out_dir: str, variants: list) -> dict:
    """The tree's ``auction_lap.cu`` alone, once with ``-Xptxas -v`` (its
    lines printed) and once per (threads, solo threshold) of ``variants``,
    and the empty-round kernel; returns {(threads, solo): lib, "empty": lib}."""
    nvcc, src = cuda_lib._nvcc(), os.path.join(cuda_lib.CSRC_DIR, "auction_lap.cu")
    empty_src = os.path.join(out_dir, "empty_rounds.cu")
    with open(empty_src, "w") as f:
        f.write(_EMPTY_ROUNDS)
    libs = {v: os.path.join(out_dir, f"libauction_{v[0]}_{v[1]}.so") for v in variants}
    libs["empty"] = os.path.join(out_dir, "libempty_rounds.so")
    procs = [subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o",
                               os.path.join(out_dir, "auction_ptxas.o"), src],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)]
    for (threads, solo), so in ((k, v) for k, v in libs.items() if k != "empty"):
        procs.append(subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, f"-DDI_AUCTION_THREADS={threads}",
                                       f"-DDI_AUCTION_SOLO_BELOW={solo}", "-shared", "-o", so, src],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    procs.append(subprocess.Popen([nvcc, *cuda_lib.NVCC_FLAGS, "-shared", "-o", libs["empty"], empty_src],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    log = cuda_lib._run(procs[:1])
    cuda_lib._run(procs[1:])
    lines = [ln for ln in log.splitlines() if "ptxas" in ln or "spill" in ln]
    print("auction_lap.cu -Xptxas -v:\n" + "\n".join(lines), flush=True)
    out = {}
    for key, so in libs.items():
        lib = ctypes.CDLL(so)
        if key == "empty":
            lib.empty_rounds.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        else:
            lib.di_auction_lap.argtypes, lib.di_auction_lap.restype = cuda_lib._SIGNATURES["di_auction_lap"]
        out[key] = lib
    return out


def lap(lib, cost, num_gt, eps_phases=(1e-3,), cap=4096):
    """The auction through ``lib``'s C interface, as ``hungarian.auction_lap``."""
    n, p, g = cost.shape
    eps = (ctypes.c_float * len(eps_phases))(*eps_phases)
    out = torch.empty(n, p, dtype=torch.int32, device=cost.device)
    rounds = torch.empty(n, dtype=torch.int32, device=cost.device)
    cuda_lib.check(lib.di_auction_lap(cost.data_ptr(), num_gt.data_ptr(), eps, out.data_ptr(), rounds.data_ptr(),
                                      n, p, g, len(eps_phases), cap, cuda_lib.stream_ptr(cost.device)),
                   "auction_lap")
    return out, rounds


def step_costs(dev) -> tuple:
    """The matching costs and ``num_gt`` of one ``fusion_base`` B=2 callback
    train step, as ``chip_smoke.py`` phase 28 records them."""
    cfg = fusion_base_config()
    batch = to_torch(make_synthetic_batch(cfg, b=cfg.data.samples_per_device, seed=0, with_gt=True), dev)
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape).to(dev)
    init_weights(model, seed=0)
    calls = []
    with cs.recorded_matching(calls):
        TrainStep(cfg, model, 1000, device=dev).backward(batch, torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    (cost, ng, _), = calls
    return cost, ng


def auction(libs: dict, dev, out_dir: str, match: str, sweep: bool) -> None:
    """The auction cases (see the module's note)."""
    tree_v = auction_settings()
    threads = tree_v[0]
    variants = [(t, s) for t in (128, 256, 512, 1024) for s in (0, 1, 2, 4)] if sweep else []
    built = build_auction(out_dir, [v for v in variants if v != tree_v])
    exact = lambda got, ref: torch.equal(got, ref)
    for name, (c, ng) in cs.auction_cases(*step_costs(dev), dev).items():
        label = f"auction_lap {name} {list(c.shape)}"
        if match not in label:
            continue
        want = hungarian.auction_assign_plain(c, ng, with_rounds=True)
        rounds = int(want[1].max())
        other, tree = in_turns(label, lambda lib: lap(lib, c, ng), libs, want, exact, match)
        empty = torch.empty(c.shape[0], dtype=torch.int32, device=dev)
        words = -(-c.shape[1] // 32)
        floor = cs.device_time_ms(lambda: built["empty"].empty_rounds(
            empty.data_ptr(), c.shape[0], threads, rounds, words, cuda_lib.stream_ptr(dev)))
        print(f"{label}: largest round count {rounds}, rounds {want[1].tolist()}; us a round: other "
              f"{other * 1e3 / rounds:.4f}, tree {tree * 1e3 / rounds:.4f}, empty round ({threads} threads) "
              f"{floor * 1e3 / rounds:.4f}", flush=True)
        # where the rounds' time goes: the tree's kernel stopped after `cap`
        # rounds (cap 0: the staging, the scale and the output, or the
        # host's rate of calls where that is slower)
        caps = sorted({k for k in (0, 1, 2, 4, 8, 16, 32, 64, 128, 256) if k < rounds} | {rounds})
        curve = [cs.device_time_ms(lambda: lap(libs["tree"], c, ng, cap=k)) for k in caps]
        print(f"{label}: tree ms by round cap: " + ", ".join(f"{k}: {t:.4f}" for k, t in zip(caps, curve)),
              flush=True)
        # the open costed columns (each a warp's scan) at the start of each
        # round of the problem with the most rounds, from its assignment
        # after that many rounds, averaged over the curve's spans
        worst = int(want[1].argmax())
        n_gt = int(ng[worst])
        opens = [n_gt - int((lap(libs["tree"], c[worst:worst + 1], ng[worst:worst + 1], cap=k)[0] >= 0).sum())
                 for k in range(rounds)]
        spans = list(zip(caps, caps[1:]))
        print(f"{label}: problem {worst} ({n_gt} GTs), open costed columns a round, mean over rounds: "
              + ", ".join(f"{a + 1}-{b}: {sum(opens[a:b]) / (b - a):.2f}" for a, b in spans), flush=True)
        for v in variants:
            lib = libs["tree"] if v == tree_v else built[v]
            _, t = in_turns(f"{label} threads={v[0]} solo_below={v[1]}", lambda lb: lap(lb, c, ng),
                            {"other": libs["tree"], "tree": lib}, want, exact)
            print(f"  threads={v[0]} solo_below={v[1]}: {t * 1e3 / rounds:.4f} us a round", flush=True)


# the bf16 entry of the builds before the bf16 kernel's redesign: fp32
# operands, the same arguments as di_subm_conv_gemm
_OLD_BF16 = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p], ctypes.c_int)


def gemm(lib, feat, nbr, w, valid, bf16=False, per_tap=True):
    """K1's forward through ``lib``: fp32, or with ``bf16`` the bf16 path as
    that build runs it (casts included where it takes bf16 operands)."""
    ko, taps = nbr.shape
    (kin, cin), cout = feat.shape, w.shape[-1]
    out = torch.empty(ko, cout, device=feat.device)
    stream = cuda_lib.stream_ptr(feat.device)
    if bf16 and hasattr(lib, "di_subm_conv_bf16"):
        cin_p = -(-cin // 16) * 16
        xb, wb = smc.bf16_operand(feat, cin_p), smc.bf16_operand(w.transpose(1, 2), cin_p)
        code = lib.di_subm_conv_bf16(xb.data_ptr(), nbr.data_ptr(), wb.data_ptr(), valid.data_ptr(), out.data_ptr(),
                                     kin, ko, taps, cin_p, cout, int(per_tap), None, None, stream)
    else:
        entry = lib.di_subm_conv_gemm_bf16 if bf16 else lib.di_subm_conv_gemm
        code = entry(feat.data_ptr(), nbr.data_ptr(), w.data_ptr(), valid.data_ptr(), out.data_ptr(),
                     kin, ko, taps, cin, cout, stream)
    cuda_lib.check(code, "subm_conv_gemm")
    return out


def wgrad(lib, feat, nbr, dy):
    """d/dW through ``lib``'s C interface, with the partial buffer of
    ``ops/subm_conv.py::subm_conv_wgrad``."""
    (ko, taps), (kin, cin), cout = nbr.shape, feat.shape, dy.shape[1]
    chunks = -(-ko // smc.WGRAD_ROWS_PER_BLOCK)
    partial = feat.new_empty(max(chunks, 1), taps, cin, cout)
    out = feat.new_empty(taps, cin, cout)
    cuda_lib.check(lib.di_subm_conv_wgrad(feat.data_ptr(), nbr.data_ptr(), dy.data_ptr(), partial.data_ptr(),
                                          out.data_ptr(), kin, ko, taps, cin, cout, chunks,
                                          cuda_lib.stream_ptr(feat.device)), "subm_conv_wgrad")
    return out


def attn(lib, q, k, v, kernel, bf16=False):
    b, h, w, c = q.shape
    out = torch.empty_like(q)
    entry = lib.di_local_attn_fwd_bf16 if bf16 else lib.di_local_attn_fwd
    cuda_lib.check(entry(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, h, w, c, kernel,
                         1.0 / math.sqrt(c), cuda_lib.stream_ptr(q.device)), "local_attn_fwd")
    return out


def attn_bwd(lib, q, k, v, dout, kernel):
    b, h, w, c = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    lse, dsum = (q.new_empty(b, h, w, kernel * kernel) for _ in range(2))  # the most a build takes
    cuda_lib.check(lib.di_local_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(), dq.data_ptr(),
                                         dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), dsum.data_ptr(), b, h, w, c,
                                         kernel, 1.0 / math.sqrt(c), cuda_lib.stream_ptr(q.device)),
                   "local_attn_bwd")
    return dq, dk, dv


def bf16_frame(libs, dev, gen, k1_tol, bf16_tol, both_s2d: bool, match: str) -> None:
    """K1's bf16 path at the five submanifold conv shapes of a realistic
    ``fusion_base`` frame (forward, ``s2d`` where both builds have it, and
    d/dfeat over the mirror table), with the sum of launches x time of each
    build over the frame's 17 convs."""
    cfg = fusion_base_config()
    root = os.path.join(cuda_lib.PKG_DIR, os.pardir, "work_dirs", "kernel_ab_tree")
    batch = cs.realistic_frame(cfg, dev, root)
    per_frame = {"other": 0.0, "tree": 0.0}
    for name, nbr, _, valid, kin, cin, cout, n in cs.encoder_tables(
            cfg, batch, dev, cfg.model.pts_voxel_layer.max_voxels[1], False):
        if name.startswith(("down", "conv_out")):
            continue
        hits = ((nbr < kin) & valid[:, None]).sum().item() / max(valid.sum().item(), 1)
        f = torch.randn(kin, cin, generator=gen).to(dev)
        w = (torch.randn(nbr.shape[1], cin, cout, generator=gen) / (nbr.shape[1] * cin) ** 0.5).to(dev)
        label = f"{name} {cin}->{cout} x{n}, {hits:.2f} hits/row"
        ms = in_turns(f"K1 fwd_bf16 realistic {label}", lambda lib: gemm(lib, f, nbr, w, valid, True), libs,
                      smc.gathered_matmul(f, nbr, w, valid, bf16=True), bf16_tol, match)
        for key, t in zip(("other", "tree"), ms):
            per_frame[key] += n * t
        if both_s2d:
            in_turns(f"K1 fwd_bf16 s2d realistic {label}", lambda lib: gemm(lib, f, nbr, w, valid, True, False),
                     libs, smc.gathered_matmul(f, nbr, w, valid, bf16=True, per_tap=False), k1_tol, match)
        if name != "conv_input":  # the voxel features take no gradient
            inv, every = sc.mirror_table(nbr), torch.ones(kin, dtype=torch.bool, device=dev)
            dy = torch.where(valid[:, None], torch.randn(kin, cout, generator=gen).to(dev), 0.0)
            wt = w.transpose(1, 2).contiguous()
            in_turns(f"K1 dgrad_bf16 realistic {label}", lambda lib: gemm(lib, dy, inv, wt, every, True), libs,
                     smc.gathered_matmul(dy, inv, wt, every, bf16=True), bf16_tol, match)
    shutil.rmtree(root, ignore_errors=True)
    if per_frame["other"]:
        print(f"K1 fwd_bf16 per realistic fusion_base frame (17 convs), sum of launches*ms: other "
              f"{per_frame['other']:.4f} ms, tree {per_frame['tree']:.4f} ms, "
              f"tree/other={per_frame['tree'] / per_frame['other']:.3f}", flush=True)


def in_turns(label: str, run, libs: dict, ref, tol, match: str = "") -> tuple:
    """Both builds against the plain result (each output of a tuple), then
    timed other, tree, tree, other; returns the mean ms of other and tree
    (nothing is run, and 0.0 returned, where ``match`` is not in ``label``).
    The line also says whether the two builds give the same bits
    (``torch.equal`` of every output)."""
    if match not in label:
        return 0.0, 0.0
    outs = {}
    for name, lib in libs.items():
        got = run(lib)
        outs[name] = got if isinstance(ref, tuple) else (got,)
        for a, r in zip(outs[name], ref if isinstance(ref, tuple) else (ref,)):
            err = (a - r).abs().max().item()
            assert tol(a, r), f"{label}: {name} build max abs err {err:.3e} out of tolerance"
    equal = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["tree"]))
    del outs
    t = {name: [] for name in libs}
    for name in ("other", "tree", "tree", "other"):
        t[name].append(cs.device_time_ms(lambda: run(libs[name])))
    other, tree = (sum(t[n]) / 2 for n in ("other", "tree"))
    print(f"{label}: other_ms={t['other'][0]:.4f},{t['other'][1]:.4f} tree_ms={t['tree'][0]:.4f},{t['tree'][1]:.4f} "
          f"tree/other={tree / other:.3f} equal={equal}", flush=True)
    return other, tree


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", help="directory of .cu sources with the same C interface")
    p.add_argument("--mma-peak", action="store_true", help="time mma.sync TF32 alone first")
    p.add_argument("--match", default="", help="run only the cases whose label holds this text, e.g. wgrad")
    p.add_argument("--auction-sweep", action="store_true",
                   help="with the auction cases, time other block sizes and solo thresholds too")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    cuda_lib.fp32_numerics()
    os.makedirs(cuda_lib.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=cuda_lib.BUILD_DIR) as tmp:
        if args.mma_peak:
            mma_peak(tmp)
        libs = {"other": build_other(args.other, tmp), "tree": cuda_lib.library()}
        dev = torch.device("cuda", 0)
        gen = torch.Generator().manual_seed(0)
        k1_tol = lambda got, ref: (got - ref).abs().max().item() <= cs.K1_TOL * ref.abs().max().item()
        k2_tol = lambda got, ref: torch.allclose(got, ref, atol=cs.K2_TOL, rtol=cs.K2_TOL)
        k2b_tol = lambda got, ref: (got - ref).abs().max().item() <= cs.K2_BWD_TOL * ref.abs().max().item()

        def bf16_tol(tol):
            def close(got, ref):
                _, rel, moved = cs.bf16_diff(got, ref)
                return rel <= tol and moved <= cs.BF16_MOVED_SHARE
            return close

        auction_only = args.match.startswith("auction")
        if auction_only or not args.match:
            auction(libs, dev, tmp, args.match, args.auction_sweep)
            if auction_only:
                return
        both_bf16 = all(hasattr(lib, "di_local_attn_fwd_bf16") for lib in libs.values())
        k1_bf16 = all(hasattr(lib, "di_subm_conv_bf16") or hasattr(lib, "di_subm_conv_gemm_bf16")
                      for lib in libs.values())
        both_s2d = all(hasattr(lib, "di_subm_conv_bf16") for lib in libs.values())
        for shape in ((6, 112, 200, 128), (1, 180, 180, 128)):
            q, k, v = (torch.randn(shape, generator=gen).to(dev) for _ in range(3))
            in_turns(f"K2 local_attn_fwd {list(shape)} k=9", lambda lib: attn(lib, q, k, v, 9), libs,
                     la.local_attention(q, k, v, 9), k2_tol, args.match)
            if both_bf16:
                in_turns(f"K2 local_attn_fwd_bf16 {list(shape)} k=9", lambda lib: attn(lib, q, k, v, 9, True), libs,
                         la.local_attention(q, k, v, 9, bf16=True), bf16_tol(cs.K2_BF16_TOL), args.match)
        for shape in ((12, 112, 200, 128), (2, 180, 180, 128)):
            q, k, v, dout = (torch.randn(shape, generator=gen).to(dev) for _ in range(4))
            in_turns(f"K2 local_attn_bwd {list(shape)} k=9", lambda lib: attn_bwd(lib, q, k, v, dout, 9), libs,
                     tuple(la.local_attention_bwd(q, k, v, dout, 9)), k2b_tol, args.match)
            del q, k, v, dout
        cfg = fusion_base_config()
        batch = to_torch(make_synthetic_batch(cfg, b=1, seed=0), dev)
        for name, nbr, _, valid, kin, cin, cout, n in cs.encoder_tables(
                cfg, batch, dev, cfg.model.pts_voxel_layer.max_voxels[1], False):
            f = torch.randn(kin, cin, generator=gen).to(dev)
            w = (torch.randn(nbr.shape[1], cin, cout, generator=gen) / (nbr.shape[1] * cin) ** 0.5).to(dev)
            in_turns(f"K1 fwd eval {name} {cin}->{cout} x{n}", lambda lib: gemm(lib, f, nbr, w, valid), libs,
                     smc.gathered_matmul(f, nbr, w, valid), k1_tol, args.match)
        if k1_bf16 and any(args.match in p for p in ("K1 fwd_bf16 s2d realistic", "K1 dgrad_bf16 realistic")):
            bf16_frame(libs, dev, gen, k1_tol, bf16_tol(cs.K1_BF16_TOL), both_s2d, args.match)
        lcfg = lidar_only_config()
        lbatch = to_torch(make_synthetic_batch(lcfg, b=2, seed=0, with_gt=True), dev)
        b = lcfg.data.samples_per_device
        per_step = {"other": 0.0, "tree": 0.0}
        for name, nbr, inv, valid, kin, cin, cout, n in cs.train_tables(lcfg, lbatch, dev, gen):
            dy = torch.where(valid[:, None], torch.randn(nbr.shape[0], cout, generator=gen).to(dev), 0.0)
            wt = (torch.randn(nbr.shape[1], cout, cin, generator=gen) / (nbr.shape[1] * cout) ** 0.5).to(dev)
            every = torch.ones(kin, dtype=torch.bool, device=dev)
            in_turns(f"K1 dgrad train {name} {cout}->{cin} x{n}", lambda lib: gemm(lib, dy, inv, wt, every), libs,
                     smc.gathered_matmul(dy, inv, wt, every), k1_tol, args.match)
            f = torch.randn(kin, cin, generator=gen).to(dev)
            ms = in_turns(f"K1 wgrad train {name} {cin}->{cout} x{n}", lambda lib: wgrad(lib, f, nbr, dy), libs,
                          smc.gathered_wgrad(f, nbr, dy), k1_tol, args.match)
            for key, t in zip(("other", "tree"), ms):
                per_step[key] += n * b * t
        if per_step["other"]:
            print(f"K1 wgrad per lidar_only train step (B={b}), sum of launches*ms: other "
                  f"{per_step['other']:.4f} ms, tree {per_step['tree']:.4f} ms, "
                  f"tree/other={per_step['tree'] / per_step['other']:.3f}", flush=True)


if __name__ == "__main__":
    main()
