#!/usr/bin/env bash
# Data-parallel training under Slurm (the port's counterpart of
# tools/slurm_train.sh): one task a node, each running python3 -m torch.distributed.run with GPUS
# ranks, one a GPU; the job's first host is the rendezvous (MASTER_PORT, default 29500).
#   PARTITION=gpu NODES=2 GPUS=8 bash deepinteraction_tpu_torch/tools/slurm_train.sh fusion_base --infos ... [args]
set -e
PARTITION=${PARTITION:?set PARTITION}
NODES=${NODES:-1}
: "${1:?usage: slurm_train.sh CONFIG [args]}"
export GPUS=${GPUS:-1} MASTER_PORT=${MASTER_PORT:-29500}
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
srun -p "$PARTITION" --nodes="$NODES" --ntasks-per-node=1 --kill-on-bad-exit=1 \
  bash -c 'exec python3 -m torch.distributed.run --nnodes "$SLURM_NNODES" --node-rank "$SLURM_NODEID" \
    --nproc-per-node "$GPUS" --master-addr "$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)" \
    --master-port "$MASTER_PORT" -m deepinteraction_tpu_torch.tools.train "$@"' bash "$@"
