#!/usr/bin/env bash
# Data-parallel training with torchrun (python3 -m torch.distributed.run), one rank a GPU (the port's
# counterpart of tools/dist_train.sh). On every node of the job:
#   NNODES=2 NODE_RANK=$i MASTER_ADDR=node0 GPUS=8 \
#     bash deepinteraction_tpu_torch/tools/dist_train.sh fusion_base --infos ... [args]
# One node with all its GPUs needs only GPUS. NCCL holds one rank a GPU.
set -e
CONFIG=$1
shift
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m torch.distributed.run --nnodes "${NNODES:-1}" --node-rank "${NODE_RANK:-0}" --nproc-per-node "${GPUS:-1}" \
    --master-addr "${MASTER_ADDR:-127.0.0.1}" --master-port "${MASTER_PORT:-29500}" \
    -m deepinteraction_tpu_torch.tools.train "$CONFIG" "$@"
