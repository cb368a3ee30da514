"""Parameter and FLOP counter (the port's counterpart of
``tools/get_flops.py``, the reference's tools/analysis_tools/get_flops.py)::

    python -m deepinteraction_tpu_torch.tools.get_flops tiny --device cpu
    python -m deepinteraction_tpu_torch.tools.get_flops fusion_base [--train]

Builds the detector with random weights from ``cfg.seed``
(``tools/benchmark.py::build_model``) and one synthetic batch of one sample
(``make_synthetic_batch(cfg, b=1, with_gt=train)``), and counts:

- params: the elements of ``model.parameters()``, which are the JAX
  package's ``params`` leaves (BN running statistics are buffers here, as
  Flax keeps them in ``batch_stats``);
- flops: ``torch.utils.flop_counter.FlopCounterMode`` around one eval
  forward + ``get_bboxes`` at the test-time proposal count, or with
  ``--train`` around one ``TrainStep`` (forward, matching, loss, backward,
  clip, AdamW). It counts matmuls, convolutions and attention, and each of
  the port's kernels by its useful operations (``ops/flops.py``: K1
  2 * Cin * Cout a hit of its table, K2 4 k^2 C a pixel, its backward
  10 k^2 C), the same on the card and on the CPU. Elementwise work is not
  counted, so the figure is not comparable with the JAX tool's, which
  printed XLA's cost model (fused elementwise work included).

It prints ``params: ... M`` and ``flops: ... GFLOPs per forward|step`` as
the JAX tool does, then one JSON line with the exact counts and the
operations by operator. XLA's ``bytes accessed`` and ``transcendentals``
have no counterpart in ``FlopCounterMode`` and are not printed. It runs on
the card unless given ``--device cpu``; without a card it raises.
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, List, Optional

from .test import CONFIGS


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(
        description="Count the parameters and FLOPs of DeepInteraction (PyTorch port). FlopCounterMode "
                    "has no counterpart of XLA's 'bytes accessed' and 'transcendentals', which the JAX "
                    "tool printed: neither is printed.")
    p.add_argument("config", choices=sorted(CONFIGS))
    p.add_argument("--train", action="store_true", help="count the training step")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Count; returns the JSON line's record."""
    import torch

    from ..ops import cuda_lib
    from ..ops.flops import count_flops
    from .benchmark import build_model, make_run, synthetic_batches

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass --device cpu to count on the CPU")
        cuda_lib.fp32_numerics()
    cfg = CONFIGS[args.config]()

    model = build_model(cfg, args.train, device)
    n_params = sum(p.numel() for p in model.parameters())
    run = make_run(cfg, model, synthetic_batches(cfg, 1, 1, args.train, device), args.train, device)
    out, flops, by_op = count_flops(run, 0)
    if not bool(torch.isfinite(out).all()):
        raise FloatingPointError("the counted iteration's output is not finite")
    per = "step" if args.train else "forward"
    print(f"params: {n_params / 1e6:.2f} M")
    print(f"flops:  {flops / 1e9:.2f} GFLOPs per {per}")
    record = {"config": args.config, "per": per, "params": n_params, "flops": flops,
              "flops_by_op": dict(sorted(by_op.items(), key=lambda kv: -kv[1])),
              "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(record))
    return record


if __name__ == "__main__":
    main()
