"""Training-log analysis (the port's counterpart of
``tools/analyze_logs.py``; reference ``tools/analysis_tools/
analyze_logs.py``) over the ``train_log.jsonl`` that ``tools/train.py``
writes::

    python -m deepinteraction_tpu_torch.tools.analyze_logs cal_train_time work_dirs/base/train_log.jsonl
    python -m deepinteraction_tpu_torch.tools.analyze_logs plot_curve work_dirs/base/train_log.jsonl \\
        --keys loss_total loss_heatmap --out curves.png

``plot_curve`` needs matplotlib (imported when it runs).
"""

from __future__ import annotations

import argparse
import json
from typing import List, Optional

import numpy as np


def load(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def cal_train_time(rows):
    times = np.asarray([r["time"] for r in rows if "time" in r])
    data_times = np.asarray([r["data_time"] for r in rows if "data_time" in r])
    if not len(times):
        print("no timing entries")
        return
    print(f"iter time: mean {times.mean():.4f}s  std {times.std():.4f}  "
          f"fastest {times.min():.4f}  slowest {times.max():.4f}")
    if len(data_times):
        print(f"data time: mean {data_times.mean():.4f}s")


def plot_curve(rows, keys, out):
    try:
        import matplotlib
    except ImportError as e:
        raise RuntimeError("plot_curve needs matplotlib, which is not installed") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    steps = [r["step"] for r in rows]
    for k in keys:
        ax.plot(steps, [r.get(k, float("nan")) for r in rows], label=k)
    ax.set_xlabel("step")
    ax.legend()
    fig.savefig(out, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print("wrote", out)


def main(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Training-log analysis (PyTorch port)")
    p.add_argument("task", choices=["cal_train_time", "plot_curve"])
    p.add_argument("log")
    p.add_argument("--keys", nargs="*", default=["loss_total"])
    p.add_argument("--out", default="curves.png")
    args = p.parse_args(argv)
    rows = load(args.log)
    if args.task == "cal_train_time":
        cal_train_time(rows)
    else:
        plot_curve(rows, args.keys, args.out)


if __name__ == "__main__":
    main()
