#!/usr/bin/env bash
# Data-parallel evaluation with torchrun (python3 -m torch.distributed.run), one rank a GPU (the port's
# counterpart of tools/dist_test.sh): each rank evaluates its shard of the
# val split and rank 0 gathers, scores and writes --out.
#   GPUS=8 bash deepinteraction_tpu_torch/tools/dist_test.sh fusion_base --infos ... [args]
set -e
CONFIG=$1
shift
export PYTHONPATH="$(cd "$(dirname "$0")/../.." && pwd)${PYTHONPATH:+:$PYTHONPATH}"
exec python3 -m torch.distributed.run --nnodes "${NNODES:-1}" --node-rank "${NODE_RANK:-0}" --nproc-per-node "${GPUS:-1}" \
    --master-addr "${MASTER_ADDR:-127.0.0.1}" --master-port "${MASTER_PORT:-29500}" \
    -m deepinteraction_tpu_torch.tools.test "$CONFIG" "$@"
