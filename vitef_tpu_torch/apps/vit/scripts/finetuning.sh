#!/usr/bin/env bash
# The full finetuning sweep on the port: 7 freeze configs x seeds {0,42,3407}
# x 4 lrs x 11 datasets, queued into one tmux session per dataset. The
# commands and run names (vit_<dataset>_seed_<s>_lr_<lr>_comp_<i>, read by
# vitef_tpu_torch/apps/plots/finetuning.py) are apps/vit/scripts/finetuning.sh's,
# with the port's modules.
#
# Usage (from the repository root):  bash vitef_tpu_torch/apps/vit/scripts/finetuning.sh
set -u
source "$(dirname "$0")/sweep_lib.sh"

DATASETS=(
  cifar10
  cifar100
  cifar10_c-corruption-contrast-severity-5
  cifar10_c-corruption-gaussian_noise-severity-5
  cifar10_c-corruption-motion_blur-severity-5
  cifar10_c-corruption-snow-severity-5
  cifar10_c-corruption-speckle_noise-severity-5
  domainnet-clipart
  domainnet-sketch
  flowers102
  pet
)

for dataset_name in "${DATASETS[@]}"; do
  # plots-layer dataset key: encoded names flattened with underscores
  ds_key="${dataset_name//-corruption-/_}"
  ds_key="${ds_key//-severity-/_}"
  ds_key="${ds_key//-/_}"
  session="fin_${ds_key}"
  cfg="$(config_for "${dataset_name}")"
  for seed in "${SEEDS[@]}"; do
    for lr in $(lrs_for "${dataset_name}"); do
      for i in "${!FREEZE_CONFIGS[@]}"; do
        log_dir="vit_${ds_key}_seed_${seed}_lr_${lr}_comp_${i}"
        queue_cmd "${session}" \
          "python -m vitef_tpu_torch.apps.vit.train config=apps/vit/configs/${cfg}.yaml" \
          "dataset_name=${dataset_name} log_dir=${log_dir} seed=${seed}" \
          "lr=${lr} '${FREEZE_CONFIGS[$i]}'"
      done
    done
  done
done
