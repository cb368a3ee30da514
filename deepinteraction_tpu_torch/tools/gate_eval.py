"""Quality gates of the JAX package's eval-time settings (the port's
counterpart of ``tools/gate_eval.py``).

Each setting in ``levers.py`` (nearest I2P sampling, top-2 views for I2P
and the BEVWarp scatter, the I2P key dedupe, MSDA's joint and per-level
top-k, the lite depth fill, dense bf16) departs from the reference's math.
This tool evaluates a checkpoint once per gate, each gate the parity set
plus one setting (so a delta belongs to it), or the shipped defaults, and
compares the metrics and the detections against the parity run::

    python -m deepinteraction_tpu_torch.tools.gate_eval fusion_base work_dirs/ckpt \\
        --infos data/nuscenes/nuscenes_infos_val.pkl --out work_dirs/gates.json \\
        [--gates parity default nearest_i2p ...] [--device cpu]

Each gate is a fresh ``python -m deepinteraction_tpu_torch.tools.test``
process with its ``DI_*`` variables set (the model reads them when it is
built), on the card unless ``--device cpu``. Every setting is first
cleared, so a gate's environment is its table entry whatever the caller's
holds. ``banded_sparse_conv`` (``DI_SPARSE_IMPL``) chooses among the TPU's
sparse-conv implementations; the port has one (K1), so that gate runs the
parity program and its row says so. The report is a JSON file and
markdown tables on stdout.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pickle
import subprocess
import sys
from typing import Dict, List, Optional

import numpy as np

from ..levers import ENV

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# strict reference math: every deviation off
PARITY = {
    "DI_MSDA_JOINT_POINTS": "0",
    "DI_MSDA_EVAL_POINTS": "0",
    "DI_I2P_SAMPLE": "bilinear",
    "DI_I2P_VIEWS": "0",
    "DI_WARP_VIEWS": "0",
    "DI_SPARSE_IMPL": "gather",
    "DI_DEPTH_FILL_LITE": "0",
    "DI_DENSE_BF16": "0",
}

# each gate = parity + ONE deviation (so deltas are attributable), plus the
# production default set as shipped
GATES = {
    "parity": {},
    "default": None,  # None -> clear all knobs, use shipped defaults
    "nearest_i2p": {"DI_I2P_SAMPLE": "nearest"},
    "joint_top4_msda": {"DI_MSDA_JOINT_POINTS": "4"},
    "plevel_top2_msda": {"DI_MSDA_EVAL_POINTS": "2"},
    "i2p_top2_views": {"DI_I2P_VIEWS": "2"},
    "warp_top2_views": {"DI_WARP_VIEWS": "2"},
    "banded_sparse_conv": {"DI_SPARSE_IMPL": "banded"},
    "depth_fill_lite": {"DI_DEPTH_FILL_LITE": "1"},
    "dense_bf16": {"DI_DENSE_BF16": "1"},
    # dedupe needs nearest + the hoisted top-k-view path; read its delta
    # against the nearest_top2_views control row
    "nearest_top2_views": {"DI_I2P_SAMPLE": "nearest", "DI_I2P_VIEWS": "2"},
    "i2p_dedupe8": {
        "DI_I2P_SAMPLE": "nearest",
        "DI_I2P_VIEWS": "2",
        "DI_I2P_DEDUPE": "8",
    },
}

# gates whose setting the port has no counterpart of: they run the parity
# program
TPU_ONLY = {"banded_sparse_conv": "TPU sparse-conv choice: runs parity"}

METRIC_KEYS = ("NDS", "mAP", "mATE", "mASE", "mAOE", "mAVE", "mAAE")


def gate_env(name: str, environ: Optional[Dict[str, str]] = None) -> Dict[str, str]:
    """The environment gate ``name`` runs in: ``environ`` (``os.environ``
    by default) without any setting, then the parity set and the gate's
    own; the ``default`` gate keeps none (the shipped defaults)."""
    env = dict(os.environ if environ is None else environ)
    for k in set(PARITY) | set(ENV):
        env.pop(k, None)
    overrides = GATES[name]
    if overrides is not None:
        env.update(PARITY)
        env.update(overrides)
    return env


def run_gate(cfg: str, ckpt: str, infos: str, name: str, workdir: str, device: str = "cuda",
             num_workers: int = 2, cfg_options: List[str] = ()) -> dict:
    """Evaluate ``ckpt`` under gate ``name`` in a fresh eval CLI process;
    its detections go to ``workdir/dets_<name>.pkl``. Returns the metrics,
    the settings the model resolved, the gate and the exit code."""
    env = gate_env(name)
    env["PYTHONPATH"] = os.pathsep.join(p for p in (_ROOT, env.get("PYTHONPATH")) if p)
    out_pkl = os.path.join(workdir, f"dets_{name}.pkl")
    cmd = [sys.executable, "-m", "deepinteraction_tpu_torch.tools.test", cfg, "--infos", infos, "--checkpoint",
           ckpt, "--num-workers", str(num_workers), "--out", out_pkl, "--device", device]
    if cfg_options:
        cmd += ["--cfg-options", *cfg_options]
    print(f"[gate {name}] {' '.join(cmd)}", flush=True)
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True)
    if proc.returncode != 0:
        sys.stderr.write(proc.stdout[-2000:] + proc.stderr[-3000:])
        return {"gate": name, "rc": proc.returncode}
    try:
        summary = json.loads(proc.stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        sys.stderr.write(proc.stdout[-2000:])
        return {"gate": name, "rc": 0, "error": "unparseable summary"}
    keep = {k: summary["metrics"][k] for k in METRIC_KEYS if k in summary["metrics"]}
    keep.update({"gate": name, "rc": 0, "levers": summary["levers"]})
    print(f"[gate {name}] {json.dumps(keep, sort_keys=True)}", flush=True)
    return keep


def diff_dets(parity_pkl: str, gate_pkl: str, top_k: int = 50) -> dict:
    """Detection-level perturbation stats of one gate vs strict parity.

    mAP deltas need a well-trained checkpoint to be resolvable; matched-box
    score/center deltas do not — they measure the numeric perturbation the
    deviation injects into the SAME program/weights directly, with
    24 scenes x top-50 boxes ~= 1200 pairs of statistical power regardless
    of detector quality. Matching: per sample, each of parity's top-k boxes
    (by score) pairs greedily with the nearest unused deviation box.
    """
    with open(parity_pkl, "rb") as f:
        pa = pickle.load(f)
    with open(gate_pkl, "rb") as f:
        ga = pickle.load(f)
    assert pa["tokens"] == ga["tokens"], "sample order mismatch"
    d_score, d_center, label_ok, n_pairs = [], [], 0, 0
    for fp, fg in zip(pa["frames"], ga["frames"]):
        order = np.argsort(-fp.scores)[:top_k]
        used = np.zeros(len(fg.boxes), dtype=bool)
        for i in order:
            dist = np.linalg.norm(fg.boxes[:, :3] - fp.boxes[i, :3], axis=1)
            dist = np.where(used, np.inf, dist)
            j = int(np.argmin(dist))
            used[j] = True
            n_pairs += 1
            d_score.append(abs(float(fp.scores[i]) - float(fg.scores[j])))
            d_center.append(float(dist[j]))
            label_ok += int(fp.names[i] == fg.names[j])
    d_score, d_center = np.asarray(d_score), np.asarray(d_center)
    return {
        "pairs": n_pairs,
        "score_mean": float(d_score.mean()),
        "score_p99": float(np.percentile(d_score, 99)),
        "score_max": float(d_score.max()),
        "center_m_mean": float(d_center.mean()),
        "center_m_p99": float(np.percentile(d_center, 99)),
        "center_m_max": float(d_center.max()),
        "label_match": label_ok / max(n_pairs, 1),
    }


def _label(name: str) -> str:
    return f"{name} ({TPU_ONLY[name]})" if name in TPU_ONLY else name


def print_diff_table(workdir: str, out: str | None = None) -> dict:
    """The detection-level table of every ``dets_<gate>.pkl`` in
    ``workdir`` against ``dets_parity.pkl``; written to ``out`` as JSON if
    given. Returns the rows."""
    parity = os.path.join(workdir, "dets_parity.pkl")
    if not os.path.exists(parity):
        print("no dets_parity.pkl in workdir; skipping detection-level diff")
        return {}
    rows = {}
    print(
        "\n| gate vs parity | pairs | d-score mean / p99 / max "
        "| d-center m mean / p99 / max | label match |"
    )
    print("|---|---|---|---|---|")
    for pkl in sorted(glob.glob(os.path.join(workdir, "dets_*.pkl"))):
        name = os.path.basename(pkl)[len("dets_"):-len(".pkl")]
        if name == "parity":
            continue
        s = diff_dets(parity, pkl)
        rows[name] = s
        print(
            f"| {_label(name)} | {s['pairs']} "
            f"| {s['score_mean']:.2e} / {s['score_p99']:.2e} / {s['score_max']:.2e} "
            f"| {s['center_m_mean']:.3f} / {s['center_m_p99']:.3f} / {s['center_m_max']:.3f} "
            f"| {s['label_match']:.4f} |"
        )
    if out:
        with open(out, "w") as f:
            json.dump(rows, f, indent=1, sort_keys=True)
    return rows


def parse_args(argv: Optional[List[str]] = None):
    p = argparse.ArgumentParser(description="Quality gates of the eval-time settings (PyTorch port)")
    p.add_argument("config")
    p.add_argument("checkpoint", help="port checkpoint directory")
    p.add_argument("--infos", required=True)
    p.add_argument("--out", default=None)
    p.add_argument("--workdir", default=os.path.join("work_dirs", "gate_eval"))
    p.add_argument("--gates", nargs="*", default=list(GATES), choices=list(GATES))
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    p.add_argument("--num-workers", type=int, default=2)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument(
        "--diff-only",
        action="store_true",
        help="skip eval runs; just diff existing dets_*.pkl in workdir",
    )
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> dict:
    """Run the gates; returns the report (``rows``) and the detection
    table (``dets``)."""
    args = parse_args(argv)
    os.makedirs(args.workdir, exist_ok=True)
    report = {"config": args.config, "checkpoint": args.checkpoint, "rows": []}
    if not args.diff_only:
        rows = [
            run_gate(args.config, args.checkpoint, args.infos, g, args.workdir, args.device, args.num_workers,
                     args.cfg_options)
            for g in args.gates
        ]
        report["rows"] = rows
        if args.out:
            with open(args.out, "w") as f:
                json.dump(report, f, indent=1)

        base = next(
            (r for r in rows if r["gate"] == "parity" and "mAP" in r), None
        )
        print("\n| gate | mAP | dmAP | NDS | dNDS |")
        print("|---|---|---|---|---|")
        for r in rows:
            if "mAP" not in r:
                print(f"| {_label(r['gate'])} | FAILED rc={r.get('rc')} | | | |")
                continue
            dm = r["mAP"] - base["mAP"] if base else float("nan")
            dn = r["NDS"] - base["NDS"] if base else float("nan")
            print(
                f"| {_label(r['gate'])} | {r['mAP']:.4f} | {dm:+.4f} "
                f"| {r['NDS']:.4f} | {dn:+.4f} |"
            )
    report["dets"] = print_diff_table(
        args.workdir,
        out=(args.out or "").replace(".json", "_dets.json") or None,
    )
    if any(r.get("rc") for r in report["rows"]):
        raise SystemExit(1)
    return report


if __name__ == "__main__":
    main()
