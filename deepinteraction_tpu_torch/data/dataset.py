"""Dataset over info pkls + CBGS class-balanced resampling (port of
``deepinteraction_tpu/data/dataset.py``, numpy only).

Rebuild of the reference's CustomNuScenesDataset + mmdet3d CBGSDataset wrap
(config Fusion_0075_refactor.py:96-99). CBGS (Zhu et al., 2019) duplicates
sample indices so every class appears in ~1/num_classes of the drawn
samples; mmdet3d implements it as per-class index pools resampled to the
max pool size — replicated here.
"""

from __future__ import annotations

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..configs import Config
from .gt_database import ObjectSampler
from .pipeline import build_sample


def load_infos(path: str) -> List[dict]:
    with open(path, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    return sorted(infos, key=lambda i: i["timestamp"])


def cbgs_indices(
    infos: Sequence[dict], class_names: Sequence[str], seed: int = 0
) -> np.ndarray:
    """Class-balanced index list (mmdet3d CBGSDataset._get_sample_indices).

    Every sample joins the pool of each class it contains; each class pool
    is then resampled (with replacement) to ``ratio * total`` where
    ratio = 1/num_classes, and pools are concatenated.
    """
    rng = np.random.default_rng(seed)
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    class_pools: Dict[int, List[int]] = {i: [] for i in range(len(class_names))}
    for idx, info in enumerate(infos):
        names = set(np.asarray(info.get("gt_names", ())).tolist())
        for n in names:
            ci = name_to_idx.get(n)
            if ci is not None:
                class_pools[ci].append(idx)
    duplicated = sum(len(v) for v in class_pools.values())
    if duplicated == 0:
        return np.arange(len(infos))
    frac = 1.0 / len(class_names)
    out: List[int] = []
    for pool in class_pools.values():
        if not pool:
            continue
        n_target = max(int(frac * duplicated), 1)
        out.extend(rng.choice(pool, n_target, replace=True).tolist())
    return np.asarray(out, np.int64)


class NuScenesDataset:
    """Indexable dataset: infos + online pipeline -> static-shape samples.
    With ``gt_database`` (an index pkl of ``gt_database.create_gt_database``)
    a train sample gets GT paste by ``sample_groups`` (class -> count)."""

    def __init__(
        self,
        cfg: Config,
        info_path: str,
        train: bool,
        use_cbgs: Optional[bool] = None,
        seed: int = 0,
        gt_database: Optional[str] = None,
        sample_groups: Optional[Dict[str, int]] = None,
    ):
        self.cfg = cfg
        self.train = train
        self.infos = load_infos(info_path)
        self.seed = seed
        self.epoch = 0  # loader sets this; drives the Fading hook
        use_cbgs = train if use_cbgs is None else use_cbgs
        if use_cbgs:
            self.indices = cbgs_indices(self.infos, cfg.data.class_names, seed)
        else:
            self.indices = np.arange(len(self.infos))
        self.sampler = None
        if train and gt_database:
            self.sampler = ObjectSampler(gt_database, os.path.dirname(gt_database), sample_groups or {})

    def __len__(self) -> int:
        return len(self.indices)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        info = self.infos[int(self.indices[i])]
        rng = np.random.default_rng((self.seed, self.epoch, i)) if self.train else None
        return build_sample(info, self.cfg, self.train, rng, sampler=self.sampler, epoch=self.epoch)

    def epoch_indices(self, epoch: int, shuffle: bool = True) -> np.ndarray:
        idx = np.arange(len(self))
        if shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(idx)
        return idx
