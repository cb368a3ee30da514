"""Offline data preparation CLI: info pkls, the GT-paste database and the
2D annotations (the port's counterpart of ``tools/create_data.py``)::

    python -m deepinteraction_tpu_torch.tools.create_data nuscenes --root data/nuscenes \\
        --out data/nuscenes --version v1.0-trainval --max-sweeps 10
    python -m deepinteraction_tpu_torch.tools.create_data synthetic --root work_dirs/nusc \\
        --profile realistic --num-scenes 24 --gt-database --export-2d

``synthetic`` first writes a synthetic raw tree (``utils/
synthetic_nuscenes.py``: ``tiny`` or ``realistic``), whose camera JPEGs
are rendered and encoded on the card unless given ``--device cpu``; without
a card that mode raises. Everything else is numpy on the host: the
converter (``data/nuscenes_converter.py``), ``--export-2d``
(``data/anno_2d.py``, one ``*_mono3d.coco.json`` per info pkl) and
``--gt-database`` (``data/gt_database.py``, from the train pkl).
"""

from __future__ import annotations

import argparse
from typing import List, Optional

from ..data.anno_2d import export_2d_annotation
from ..data.dataset import load_infos
from ..data.gt_database import create_gt_database
from ..data.nuscenes_converter import create_nuscenes_infos


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Generate dataset info pkls")
    p.add_argument("dataset", choices=["nuscenes", "synthetic"])
    p.add_argument("--root", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--max-sweeps", type=int, default=10)
    p.add_argument("--num-samples", type=int, default=4, help="synthetic only: samples to write")
    p.add_argument("--profile", choices=["tiny", "realistic"], default="tiny",
                   help="synthetic only: 'realistic' writes a full-scale multi-scene set (~45k-pt lidar spins, "
                   "40 objects/scene, 1600x900 6-cam)")
    p.add_argument("--num-scenes", type=int, default=24, help="realistic only")
    p.add_argument("--num-objects", type=int, default=40, help="realistic only")
    p.add_argument("--gt-database", action="store_true",
                   help="also build the GT-paste database (reference create_gt_database)")
    p.add_argument("--export-2d", action="store_true",
                   help="also export COCO-style 2D (+mono3d) annotations per camera "
                   "(reference export_2d_annotation, create_data.py:71-79)")
    p.add_argument("--device", default="cuda", help="synthetic only: where the writer renders and encodes the "
                   "camera JPEGs, cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> List[str]:
    """Run the preparation; returns the paths written (info pkls, then the
    2D annotations, then the GT database's index)."""
    args = parse_args(argv)
    out = args.out or args.root

    if args.dataset == "synthetic":
        import torch

        from ..ops import cuda_lib
        from ..utils.synthetic_nuscenes import write_realistic_nuscenes, write_synthetic_nuscenes

        device = torch.device(args.device)
        if device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: pass --device cpu to write the synthetic tree on the CPU")
            cuda_lib.fp32_numerics()
        if args.profile == "realistic":
            write_realistic_nuscenes(args.root, num_scenes=args.num_scenes, samples_per_scene=args.num_samples,
                                     num_objects=args.num_objects, device=device)
            args.version = "v1.0-trainval"
        else:
            write_synthetic_nuscenes(args.root, num_samples=args.num_samples, device=device)
            args.version = "v1.0-mini"

    paths = create_nuscenes_infos(args.root, out, version=args.version, max_sweeps=args.max_sweeps)
    for path in paths:
        print("wrote", path)
    written = list(paths)

    if args.export_2d:
        for path in paths:
            written.append(export_2d_annotation(args.root, path, args.version))
            print("wrote", written[-1])

    if args.gt_database:
        written.append(create_gt_database(load_infos(paths[0]), out, num_sweeps=args.max_sweeps))
        print("wrote", written[-1])
    return written


if __name__ == "__main__":
    main()
