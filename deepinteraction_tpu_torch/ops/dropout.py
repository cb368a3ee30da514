"""Inverted dropout drawn from the caller's generator, shared by the port's
attention, FFN and Swin modules."""

from __future__ import annotations

import torch


def apply_dropout(x: torch.Tensor, rate: float, train: bool, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout at ``rate`` with the caller's generator (train only)."""
    if not train or rate == 0.0:
        return x
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return x * keep / (1.0 - rate)
