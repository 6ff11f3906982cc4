#!/usr/bin/env bash
# Evaluate the AdamW-ablation checkpoints on the port
# (apps/vit/scripts/ablation/eval_adam.sh's commands).
set -u
source "$(dirname "$0")/../sweep_lib.sh"

DATASETS=(
  cifar100
  cifar10_c-corruption-motion_blur-severity-5
  domainnet-clipart
  domainnet-sketch
)
ABLATION_SEEDS=(0)
COMP_INDICES=(0 2 3 4 5 6)

rescale_lr() { LC_ALL=C awk "BEGIN{printf \"%.2e\", $1/100}"; }

for dataset_name in "${DATASETS[@]}"; do
  ds_key="${dataset_name//-corruption-/_}"
  ds_key="${ds_key//-severity-/_}"
  ds_key="${ds_key//-/_}"
  session="eval_adam_${ds_key}"
  for seed in "${ABLATION_SEEDS[@]}"; do
    for base_lr in $(lrs_for "${dataset_name}"); do
      lr="$(rescale_lr "${base_lr}")"
      for i in "${COMP_INDICES[@]}"; do
        log_dir="vit_${ds_key}_adamw_seed_${seed}_lr_${lr}_comp_${i}"
        queue_cmd "${session}" \
          "python -m vitef_tpu_torch.apps.vit.eval config=apps/vit/configs/eval.yaml" \
          "log_dir=${log_dir} dataset_name=${dataset_name}"
      done
    done
  done
done
