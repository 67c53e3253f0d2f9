#!/usr/bin/env bash
# Evaluate on GPUS cards of this host, one process a card (NCCL; one rank
# a GPU), each with its share of the sequences; rank 0 writes --out-csv:
#   GPUS=4 codd_torch/tools/inference_dist.sh CONFIG [CHECKPOINT] --eval [...]
# Options after the config go to python -m codd_torch.tools.inference; several
# hosts pass torchrun's own first, e.g.
#   GPUS=4 codd_torch/tools/inference_dist.sh --nnodes=2 --node_rank=0 \
#       --master_addr=HOST --master_port=29500 CONFIG
set -euo pipefail
GPUS=${GPUS:-1}
TORCHRUN_ARGS=()
while [[ $# -gt 0 && $1 == --* ]]; do TORCHRUN_ARGS+=("$1"); shift; done
if [[ ${#TORCHRUN_ARGS[@]} -eq 0 ]]; then TORCHRUN_ARGS=(--standalone); fi
exec python -m torch.distributed.run "${TORCHRUN_ARGS[@]}" \
    --nproc_per_node="${GPUS}" -m codd_torch.tools.inference "$@"
