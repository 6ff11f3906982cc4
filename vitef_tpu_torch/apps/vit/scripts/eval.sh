#!/usr/bin/env bash
# Evaluate every finetuning run's best checkpoint on its test split, on the
# port (apps/vit/scripts/eval.sh's commands; writes metrics/eval.jsonl).
set -u
source "$(dirname "$0")/sweep_lib.sh"

DATASETS=(
  cifar10 cifar100
  cifar10_c-corruption-contrast-severity-5
  cifar10_c-corruption-gaussian_noise-severity-5
  cifar10_c-corruption-motion_blur-severity-5
  cifar10_c-corruption-snow-severity-5
  cifar10_c-corruption-speckle_noise-severity-5
  domainnet-clipart domainnet-sketch flowers102 pet
)

for dataset_name in "${DATASETS[@]}"; do
  ds_key="${dataset_name//-corruption-/_}"
  ds_key="${ds_key//-severity-/_}"
  ds_key="${ds_key//-/_}"
  session="eval_${ds_key}"
  for seed in "${SEEDS[@]}"; do
    for lr in $(lrs_for "${dataset_name}"); do
      for i in "${!FREEZE_CONFIGS[@]}"; do
        log_dir="vit_${ds_key}_seed_${seed}_lr_${lr}_comp_${i}"
        queue_cmd "${session}" \
          "python -m vitef_tpu_torch.apps.vit.eval config=apps/vit/configs/eval.yaml" \
          "log_dir=${log_dir} dataset_name=${dataset_name}"
      done
    done
  done
done
