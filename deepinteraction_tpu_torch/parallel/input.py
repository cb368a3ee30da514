"""Per-rank input and result gathering: the port's counterpart of
``deepinteraction_tpu/parallel/input.py``.

- Train: every rank sees the same globally shuffled index list (the
  dataset seeds it by epoch, not by rank) and takes its stride slice,
  trimmed so that every rank runs the same number of steps
  (:func:`process_shard_indices`); the loader (``data/loader.py``) does it.
- Eval: each rank takes its stride slice of the val split, pads its own
  last batch, runs its forward with no collective, and
  :func:`gather_results` brings the results to rank 0, the rank shards
  concatenated in rank order (JAX's order).

This module imports no torch at import time: the loader's spawned workers
import it.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence


def process_shard_indices(
    ids: Sequence[int],
    local_batch: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
    drop_last: bool = True,
) -> List[int]:
    """This rank's slice of a globally shuffled index list.

    Stride slicing keeps every rank's shard length within 1 of each
    other; ``drop_last`` then trims all shards to the shortest shard's
    whole-batch count so every rank runs the same number of steps (unequal
    step counts would leave the gradient all-reduce waiting). The rank and
    the rank count default to the process group's."""
    from .mesh import rank, world_size

    pid = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    mine = list(ids[pid::pc])
    if drop_last:
        min_len = len(ids) // pc  # the shortest shard
        n_batches = min_len // local_batch
        mine = mine[: n_batches * local_batch]
    return mine


def gather_results(items: List[Any]) -> Optional[List[Any]]:
    """Every rank's ``items`` on rank 0, concatenated in rank order; every
    other rank gets ``None``. One process returns ``items`` unchanged.

    The items are pickled through ``all_gather_object`` (on NCCL onto the
    rank's current device, which ``mesh.init_distributed`` sets); no file
    system is involved, so no stale part file from an earlier run can be
    merged."""
    import pickle

    import torch.distributed as dist

    from .mesh import all_reduce, is_distributed, rank, world_size

    if not is_distributed():
        return items
    payload = pickle.dumps(items)
    parts: List[Any] = [None] * world_size()
    all_reduce.calls += 1
    all_reduce.bytes += len(payload)
    dist.all_gather_object(parts, payload)
    if rank() != 0:
        return None
    return [x for part in parts for x in pickle.loads(part)]
