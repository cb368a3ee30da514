"""The Slurm launchers (``tools/slurm_train.sh``, ``tools/slurm_test.sh``),
with fake ``srun``, ``scontrol`` and ``python3`` on ``PATH``: ``srun``
records its options and runs its command as node 1 of a two-node job,
``scontrol show hostnames`` lists the job's hosts, ``python3`` records its
arguments. Each script hands ``torch.distributed.run`` the job's node count
and rank, ``GPUS`` ranks a node, the first host as the rendezvous, and the
CLI with the config and the user's arguments; both scripts parse with
``bash -n``, and a missing ``PARTITION`` stops the launch."""

import os
import stat
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "deepinteraction_tpu_torch", "tools")

FAKES = {
    "srun": """#!/usr/bin/env bash
echo "$@" > "$LOG_DIR/srun.args"
while [ $# -gt 0 ]; do
  case "$1" in
    -p) shift 2 ;;
    -*) shift ;;
    *) break ;;
  esac
done
export SLURM_NNODES=2 SLURM_NODEID=1 SLURM_JOB_NODELIST="node[07-08]"
exec "$@"
""",
    "scontrol": """#!/usr/bin/env bash
[ "$1 $2 $3" = "show hostnames node[07-08]" ] || exit 3
printf 'node07\\nnode08\\n'
""",
    "python3": """#!/usr/bin/env bash
printf '%s\\n' "$@" > "$LOG_DIR/python3.args"
""",
}


@pytest.fixture()
def fake_path(tmp_path):
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, body in FAKES.items():
        path = bin_dir / name
        path.write_text(body)
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return tmp_path, f"{bin_dir}:{os.environ['PATH']}"


@pytest.mark.parametrize("kind", ["train", "test"])
def test_slurm_launcher_command_line(fake_path, kind):
    logs, path = fake_path
    env = dict(os.environ, PATH=path, LOG_DIR=str(logs), PARTITION="gpu", NODES="2", GPUS="4")
    env.pop("MASTER_PORT", None)
    proc = subprocess.run(["bash", os.path.join(TOOLS, f"slurm_{kind}.sh"), "fusion_base", "--infos", "a b.pkl",
                           "--cfg-options", "data.num_views=6"], env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    srun = (logs / "srun.args").read_text().split()
    assert srun[:5] == ["-p", "gpu", "--nodes=2", "--ntasks-per-node=1", "--kill-on-bad-exit=1"]
    args = (logs / "python3.args").read_text().splitlines()
    assert args == ["-m", "torch.distributed.run", "--nnodes", "2", "--node-rank", "1", "--nproc-per-node", "4",
                    "--master-addr", "node07", "--master-port", "29500", "-m",
                    f"deepinteraction_tpu_torch.tools.{kind}", "fusion_base", "--infos", "a b.pkl",
                    "--cfg-options", "data.num_views=6"]


@pytest.mark.parametrize("kind", ["train", "test"])
def test_slurm_launcher_parses_and_needs_a_partition(fake_path, kind):
    script = os.path.join(TOOLS, f"slurm_{kind}.sh")
    assert subprocess.run(["bash", "-n", script], timeout=60).returncode == 0
    logs, path = fake_path
    env = dict(os.environ, PATH=path, LOG_DIR=str(logs))
    env.pop("PARTITION", None)
    proc = subprocess.run(["bash", script, "fusion_base"], env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode != 0 and "PARTITION" in proc.stderr
    assert not (logs / "srun.args").exists()
