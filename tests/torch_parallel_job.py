"""One rank of the two-rank gloo job of ``tests/test_torch_port_parallel.py``,
and the train step that job and the test's one-process reference share.

A rank (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT`` set, as ``torchrun`` sets them) runs, in this order, so that
both ranks issue the same collectives:

1. ``gather_results`` of a rank-dependent list;
2. one ``tiny_lidar_config`` train step in float64 on its sample of the
   B=2 synthetic batch (seed 3), then the update;
3. the same for ``tiny_config`` (the fusion step);
4. a ``tiny_config`` eval forward with every ``torch.distributed``
   collective counted;
5. a dropout mask from the train CLI's per-rank generator;
6. the eval CLI (``tools.test.main``) on the val pkl it is given, with
   ``--out``.

and saves what it saw to ``<out>/rank<r>.pt``::

    python tests/torch_parallel_job.py OUT_DIR VAL_PKL
"""

import os
import sys

import torch

from deepinteraction_tpu_torch import configs as tcfg
from deepinteraction_tpu_torch.models.detector import DeepInteraction
from deepinteraction_tpu_torch.ops.dropout import apply_dropout
from deepinteraction_tpu_torch.parallel import mesh
from deepinteraction_tpu_torch.parallel.input import gather_results
from deepinteraction_tpu_torch.train.step import TrainStep
from deepinteraction_tpu_torch.utils.synthetic import init_weights, make_synthetic_batch, to_torch

TOTAL_STEPS = 10
SEED = 3
EVAL_OPTIONS = ["--cfg-options", "data.num_views=6"]
COLLECTIVES = ("all_reduce", "broadcast", "all_gather", "all_gather_object", "gather", "reduce",
               "reduce_scatter", "all_to_all", "barrier", "send", "recv")


def batch_f64(cfg, samples=slice(None)):
    """Samples ``samples`` of the B=2 synthetic batch (seed 3), floats in
    float64."""
    np_batch = make_synthetic_batch(cfg, b=2, with_gt=True, seed=SEED)
    batch = {k: v[samples] for k, v in to_torch(np_batch, "cpu").items()}
    return {k: v.to(torch.float64) if v.is_floating_point() else v for k, v in batch.items()}


def train_step(cfg, samples=slice(None)) -> dict:
    """One float64 step from ``init_weights(seed=3)``: the metrics, the
    matching, the gradients, then the parameters and buffers after the
    update, and the collectives the step issued."""
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape)
    init_weights(model, seed=SEED)
    model = mesh.replicate(model.to(torch.float64))
    step = TrainStep(cfg, model, TOTAL_STEPS, device="cpu")
    calls, n_bytes = mesh.all_reduce.calls, mesh.all_reduce.bytes
    metrics, targets = step.backward(batch_f64(cfg, samples), torch.Generator().manual_seed(0))
    grads = {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
             for n, p in model.named_parameters() if p.requires_grad}
    step.update(metrics["grad_norm"])
    return {"metrics": {k: v.item() for k, v in metrics.items()}, "assign": targets.assign,
            "grads": grads, "state": {k: v.clone() for k, v in model.state_dict().items()},
            "collectives": mesh.all_reduce.calls - calls, "bytes": mesh.all_reduce.bytes - n_bytes}


def count_collectives(fn):
    """``fn()``, with every ``torch.distributed`` collective counted;
    returns (its result, the count)."""
    import torch.distributed as dist

    seen = []
    saved = {name: getattr(dist, name) for name in COLLECTIVES}

    def counting(name):
        def call(*a, **k):
            seen.append(name)
            return saved[name](*a, **k)
        return call

    calls = mesh.all_reduce.calls
    for name in COLLECTIVES:
        setattr(dist, name, counting(name))
    try:
        out = fn()
    finally:
        for name, f in saved.items():
            setattr(dist, name, f)
    return out, len(seen) + mesh.all_reduce.calls - calls


def main(out_dir: str, val_pkl: str) -> None:
    from deepinteraction_tpu_torch.tools import test as test_cli

    torch.set_num_threads(1)
    mesh.init_distributed("cpu")
    r = mesh.rank()
    report = {"rank": r, "world": mesh.world_size()}
    report["gather"] = gather_results([f"p{r}_{i}" for i in range(r + 2)])
    report["lidar"] = train_step(tcfg.tiny_lidar_config(), slice(r, r + 1))
    report["fusion"] = train_step(tcfg.tiny_config(), slice(r, r + 1))

    cfg = tcfg.tiny_config()
    model = DeepInteraction(cfg.model, cfg.data.padded_img_shape, cfg.test_num_proposals).eval()
    init_weights(model, seed=SEED)
    batch = to_torch(make_synthetic_batch(cfg, b=1, seed=SEED), "cpu")
    preds, report["eval_collectives"] = count_collectives(lambda: model(batch))
    report["eval_heatmap"] = preds["heatmap"]

    gen = torch.Generator().manual_seed(mesh.rank_seed(0))
    report["dropout_mask"] = apply_dropout(torch.ones(256), 0.5, True, gen) > 0

    out = os.path.join(out_dir, f"dets{r}.pkl")
    res = test_cli.main(["tiny", "--infos", val_pkl, "--device", "cpu", "--num-workers", "0", "--out", out,
                         *EVAL_OPTIONS])
    report["eval_cli"] = None if res is None else {"metrics": res["metrics"], "out": out}
    torch.save(report, os.path.join(out_dir, f"rank{r}.pt"))
    mesh.destroy_distributed()


if __name__ == "__main__":
    main(*sys.argv[1:])
