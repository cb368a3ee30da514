"""Checkpoints of a :class:`~.step.TrainStep` (the port's counterpart of
``deepinteraction_tpu/train/checkpoint.py``), with the reference's two
restore modes:

- ``resume_from`` (:func:`restore_checkpoint`): parameters, buffers (the BN
  running statistics), the optimizer state and the step count;
- ``load_from`` (:func:`load_params`): parameters and buffers only, with a
  fresh optimizer at step 0 (a warm start).

:func:`publish` strips the optimizer state for release, as the reference's
``publish_model.py`` does: a flat ``.npz`` of every parameter and buffer
under its ``state_dict`` name. One checkpoint is one ``torch.save`` file,
``<directory>/step_<n>.pt``; the newest ``max_to_keep`` are kept.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from .step import TrainStep

_NAME = re.compile(r"step_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def _path(directory: str, step: Optional[int]) -> str:
    steps = _steps(directory)
    if step is None:
        if not steps:
            raise FileNotFoundError(f"no checkpoint found under {directory}")
        step = steps[-1]
    return os.path.join(directory, f"step_{step}.pt")


def save_checkpoint(directory: str, step: TrainStep, max_to_keep: int = 3) -> str:
    """Write the step's model, optimizer and step count; returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step.step_count}.pt")
    tmp = path + ".tmp"
    torch.save({"model": step.model.state_dict(), "optimizer": step.opt.state_dict(),
                "step": step.step_count}, tmp)
    os.replace(tmp, path)  # a reader never sees half a file
    for old in _steps(directory)[:-max_to_keep]:
        os.remove(os.path.join(directory, f"step_{old}.pt"))
    return path


def _load(directory: str, at: Optional[int], device) -> dict:
    return torch.load(_path(directory, at), map_location=device, weights_only=True)


def restore_checkpoint(directory: str, step: TrainStep, at: Optional[int] = None) -> TrainStep:
    """``resume_from``: model, optimizer state and step count of the
    checkpoint at step ``at`` (default: the newest) into ``step``."""
    state = _load(directory, at, step.device)
    step.model.load_state_dict(state["model"], strict=True)
    step.opt.load_state_dict(state["optimizer"])
    step.step_count = state["step"]
    return step


def load_params(directory: str, step: TrainStep, at: Optional[int] = None) -> TrainStep:
    """``load_from``: parameters and buffers only; the optimizer starts
    afresh at step 0."""
    step.model.load_state_dict(_load(directory, at, step.device)["model"], strict=True)
    step.opt.state.clear()
    step.step_count = 0
    return step


def publish(directory: str, out_path: str, at: Optional[int] = None) -> str:
    """Every parameter and buffer of a checkpoint as a flat ``.npz``."""
    model = _load(directory, at, "cpu")["model"]
    np.savez(out_path, **{k: v.numpy() for k, v in model.items()})
    return out_path
