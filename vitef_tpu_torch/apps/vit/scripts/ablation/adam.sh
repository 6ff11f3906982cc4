#!/usr/bin/env bash
# AdamW ablation on the port: finetuning.sh's sweep on a dataset subset with
# optimizer=adamw and the lr grid over 100 (apps/vit/scripts/ablation/adam.sh's
# commands; run names vit_<dataset>_adamw_seed_<s>_lr_<lr>_comp_<i>, read by
# vitef_tpu_torch/apps/plots/ablation.py).
set -u
source "$(dirname "$0")/../sweep_lib.sh"

DATASETS=(
  cifar100
  cifar10_c-corruption-motion_blur-severity-5
  domainnet-clipart
  domainnet-sketch
)
ABLATION_SEEDS=(0)

# AdamW uses the 'all' + 5 single-component configs (no 'emb'-only config)
COMP_INDICES=(0 2 3 4 5 6)

rescale_lr() {  # lr / 100, formatted like %.2e (matches ADAM_LR_VALUES)
  LC_ALL=C awk "BEGIN{printf \"%.2e\", $1/100}"
}

for dataset_name in "${DATASETS[@]}"; do
  ds_key="${dataset_name//-corruption-/_}"
  ds_key="${ds_key//-severity-/_}"
  ds_key="${ds_key//-/_}"
  session="adam_${ds_key}"
  cfg="$(config_for "${dataset_name}")"
  for seed in "${ABLATION_SEEDS[@]}"; do
    for base_lr in $(lrs_for "${dataset_name}"); do
      lr="$(rescale_lr "${base_lr}")"
      for i in "${COMP_INDICES[@]}"; do
        log_dir="vit_${ds_key}_adamw_seed_${seed}_lr_${lr}_comp_${i}"
        queue_cmd "${session}" \
          "python -m vitef_tpu_torch.apps.vit.train config=apps/vit/configs/${cfg}.yaml" \
          "dataset_name=${dataset_name} log_dir=${log_dir} seed=${seed}" \
          "optimizer=adamw lr=${lr} '${FREEZE_CONFIGS[$i]}'"
      done
    done
  done
done
