#!/usr/bin/env bash
# Shared sweep machinery of the port's experiment launchers: the port's copy
# of apps/vit/scripts/sweep_lib.sh. Each launcher queues its commands into
# per-experiment tmux sessions.
#
# Freeze configurations, indexed 0..6: the comp_<i> suffix of the run names
# is this index, which vitef_tpu_torch/apps/plots reads.
FREEZE_CONFIGS=(
  'components=[]'
  'components=["attn_norm","mha","ffn_norm","ffn_fc1","ffn_fc2"]'
  'components=["emb","mha","ffn_norm","ffn_fc1","ffn_fc2"]'
  'components=["emb","attn_norm","ffn_norm","ffn_fc1","ffn_fc2"]'
  'components=["emb","attn_norm","mha","ffn_fc1","ffn_fc2"]'
  'components=["emb","attn_norm","mha","ffn_norm","ffn_fc2"]'
  'components=["emb","attn_norm","mha","ffn_norm","ffn_fc1"]'
)

SEEDS=(0 42 3407)

# Per-dataset learning-rate sweeps (reference apps/plots/finetuning.py:49-61;
# domainnet uses a shifted grid)
lrs_for() {
  case "$1" in
    domainnet-*) echo "3e-3 1e-2 3e-2 6e-2" ;;
    *) echo "1e-3 3e-3 1e-2 3e-2" ;;
  esac
}

# config yaml name for a dataset name
config_for() {
  case "$1" in
    cifar10_c-*) echo "cifar10_c" ;;
    domainnet-*) echo "domainnet" ;;
    *) echo "$1" ;;
  esac
}

# queue_cmd SESSION CMD — create the tmux session on first use, queue the command
queue_cmd() {
  local session="$1"; shift
  if ! tmux has-session -t "${session}" 2>/dev/null; then
    tmux new-session -d -s "${session}"
  fi
  echo "Queueing in ${session}: $*"
  tmux send-keys -t "${session}" "$*" C-m
}
