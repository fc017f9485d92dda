#!/usr/bin/env bash
# Multi-node training launcher for the PyTorch port under SLURM (the
# counterpart of tools/pod_train.sh:21-34). One SLURM task a node: each runs
# torch.distributed.run, which starts one rank a GPU of its node and meets
# the other nodes at the first host of the job.
#
#   SLURM (one task a node):
#     srun --nodes=$NNODES --ntasks-per-node=1 \
#       bash rsprompter_tpu_torch/tools/slurm_train.sh CONFIG [tools.train args...]
#
#   Without SLURM (run on every node):
#     MASTER_ADDR=host0 NNODES=2 NODE_RANK=$i \
#       bash rsprompter_tpu_torch/tools/slurm_train.sh CONFIG [args...]
#
# Nodes: NNODES, else SLURM_NNODES, else SLURM_NTASKS, else 1. This node:
# NODE_RANK, else SLURM_NODEID, else SLURM_PROCID, else 0. The rendezvous:
# MASTER_ADDR, else the first host of SLURM_JOB_NODELIST (scontrol show
# hostnames), else 127.0.0.1 on one node; MASTER_PORT, default 29500. Ranks
# a node: GPUS_PER_NODE, else the node's GPU count (count_gpus below).
# TRAIN_MODULE (default rsprompter_tpu_torch.tools.train) is the module each
# rank runs.
#
# A rendezvous or a rank that fails fails the run: torch.distributed.run
# exits non-zero and so does this script (no silent single-node training,
# as parallel/distributed.py's policy has it).
set -euo pipefail

if [ $# -lt 1 ]; then
    echo "usage: slurm_train.sh CONFIG [tools.train args...]" >&2
    exit 2
fi
CONFIG=$1
shift

NNODES=${NNODES:-${SLURM_NNODES:-${SLURM_NTASKS:-1}}}
NODE_RANK=${NODE_RANK:-${SLURM_NODEID:-${SLURM_PROCID:-0}}}
if [ -z "${MASTER_ADDR:-}" ]; then
    if [ -n "${SLURM_JOB_NODELIST:-}" ]; then
        MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | sed -n 1p)
    elif [ "$NNODES" -eq 1 ]; then
        MASTER_ADDR=127.0.0.1
    else
        echo "slurm_train.sh: $NNODES nodes need MASTER_ADDR or SLURM_JOB_NODELIST" >&2
        exit 2
    fi
fi
if [ -z "$MASTER_ADDR" ]; then
    echo "slurm_train.sh: no host in SLURM_JOB_NODELIST=${SLURM_JOB_NODELIST:-}" >&2
    exit 2
fi
MASTER_PORT=${MASTER_PORT:-29500}

# the cards this node's ranks may use, as CUDA counts them: the entries of
# CUDA_VISIBLE_DEVICES where SLURM or the user set it, else nvidia-smi's list
# (no Python start-up), else torch's count
count_gpus() {
    if [ -n "${CUDA_VISIBLE_DEVICES+x}" ]; then
        local ids=${CUDA_VISIBLE_DEVICES//,/ }
        set -- $ids
        echo $#
    elif command -v nvidia-smi >/dev/null 2>&1; then
        nvidia-smi -L | grep -c '^GPU ' || true
    else
        python -c 'import torch; print(torch.cuda.device_count())'
    fi
}
if [ -z "${GPUS_PER_NODE:-}" ]; then
    GPUS_PER_NODE=$(count_gpus)
    if [ "${GPUS_PER_NODE:-0}" -lt 1 ]; then
        echo "slurm_train.sh: no GPU on $(hostname); set GPUS_PER_NODE (with --device cpu)" >&2
        exit 2
    fi
fi

REPO=$(cd "$(dirname "${BASH_SOURCE[0]}")/../.." && pwd)
export PYTHONPATH="$REPO${PYTHONPATH:+:$PYTHONPATH}"
echo "slurm_train.sh: node $NODE_RANK of $NNODES, $GPUS_PER_NODE rank(s), rendezvous at" \
     "$MASTER_ADDR:$MASTER_PORT" >&2
exec python -m torch.distributed.run --nnodes "$NNODES" --node_rank "$NODE_RANK" \
    --nproc_per_node "$GPUS_PER_NODE" --master_addr "$MASTER_ADDR" \
    --master_port "$MASTER_PORT" -m "${TRAIN_MODULE:-rsprompter_tpu_torch.tools.train}" \
    "$CONFIG" "$@"
