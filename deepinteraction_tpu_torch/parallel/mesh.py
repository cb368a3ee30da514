"""The process group: the port's counterpart of
``deepinteraction_tpu/parallel/mesh.py`` (``make_mesh``, ``replicate``).

JAX's data parallelism is one GSPMD program over a ``data`` mesh: the
sharded program computes what the single-device program computes at the
**global** batch. The port runs one process per card (``torchrun``) and keeps
that program with three all-reduces, all through :func:`all_reduce` here:

- every train-mode BatchNorm takes its statistics over the global batch
  (``models/layers.py``), and its backward sums their gradients over ranks;
- every loss normaliser is summed over ranks before it divides
  (``targets/assign.py``): the heatmap's positives, each layer's ``npos``
  and ``matched_ious``' count, so each rank's loss is its share of the
  global loss;
- the gradients of the trainable parameters and the logged metrics are
  summed over ranks in one flat buffer before the clip and the update
  (``train/step.py``).

So N ranks at batch B take the step one process takes at batch N x B. A
plain ``DistributedDataParallel`` would take each rank's own BN statistics
and normalisers and average the gradients: another step.

``shard_batch`` and ``globalize_batch`` have no counterpart: a rank keeps
its own local batch (its loader shard, ``parallel/input.py``), and the
global coupling lives in the all-reduces above.

The group starts from the launcher protocol that ``torchrun`` sets
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``); without ``RANK`` there is no group and every helper here
is the one-process identity. With a group of one rank (``torchrun
--nproc-per-node 1``) the collectives still run.

:func:`all_reduce`, :func:`replicate` and ``input.gather_results`` count
their collectives and payload bytes in ``all_reduce.calls`` and
``all_reduce.bytes`` (as the kernel wrappers count their launches).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world_size() -> int:
    return dist.get_world_size() if is_distributed() else 1


def rank_seed(seed: int) -> int:
    """This rank's seed from ``seed``: ``seed`` itself on rank 0 (so one
    rank draws what one process draws), a 32-bit seed drawn from (``seed``,
    rank) on every other rank (the CPU generator keeps only a seed's low 32
    bits). JAX draws one mask over the global batch from one key, which no
    torch generator reproduces; each rank draws its own."""
    r = rank()
    return seed if r == 0 else int(np.random.SeedSequence([seed, r]).generate_state(1)[0])


def init_distributed(device) -> torch.device:
    """Join the process group that ``torchrun`` describes (``RANK`` set):
    NCCL on ``cuda``, after ``torch.cuda.set_device(LOCAL_RANK)``, gloo on
    ``cpu``. Returns this rank's device (``device`` itself without a
    launcher). NCCL cannot hold two ranks on one GPU."""
    device = torch.device(device)
    if "RANK" not in os.environ:
        return device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to run the ranks on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
    if not is_distributed():
        if device.type == "cuda":
            dist.init_process_group("nccl", device_id=device)
        else:
            dist.init_process_group("gloo")
    return device


def destroy_distributed() -> None:
    if is_distributed():
        dist.destroy_process_group()


def _count(t: torch.Tensor) -> None:
    all_reduce.calls += 1
    all_reduce.bytes += t.numel() * t.element_size()


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks whose backward sums the incoming gradient over ranks:
    every rank's loss reads the same sum, so the global loss's gradient with
    respect to one rank's term is the sum of every rank's."""

    @staticmethod
    def forward(ctx, t):
        out = t.contiguous().clone()
        _count(out)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad):
        g = grad.contiguous().clone()
        _count(g)
        dist.all_reduce(g)
        return g


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks (a new tensor whose backward sums the
    gradient over the ranks too); ``t`` itself without a group."""
    if not is_distributed():
        return t
    return _AllReduceSum.apply(t)


all_reduce.calls = 0
all_reduce.bytes = 0


@torch.no_grad()
def replicate(module: torch.nn.Module) -> torch.nn.Module:
    """Rank 0's parameters and buffers on every rank (a broadcast of each,
    as ``DistributedDataParallel`` does when it wraps a module)."""
    if is_distributed():
        for t in list(module.parameters()) + list(module.buffers()):
            _count(t)
            dist.broadcast(t.data, src=0)
    return module
