#!/usr/bin/env bash
# Linear-probe the pretrained backbone on every dataset, on the port
# (apps/vit/scripts/linear_probing.sh's commands; writes
# savings/probes/vit_<dataset>_seed_0_pretrained/linear_probing.json).
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

session="linear_probing"
for dataset_name in "${DATASETS[@]}"; do
  ds_key="${dataset_name//-corruption-/_}"
  ds_key="${ds_key//-severity-/_}"
  ds_key="${ds_key//-/_}"
  # probe against an existing run dir for the config.json (comp_0, seed 0,
  # the dataset's FIRST sweep lr — domainnet's grid starts at 3e-3)
  first_lr="$(lrs_for "${dataset_name}" | cut -d' ' -f1)"
  log_dir="vit_${ds_key}_seed_0_lr_${first_lr}_comp_0"
  queue_cmd "${session}" \
    "python -m vitef_tpu_torch.apps.vit.linear_probing config=apps/vit/configs/linear_probing.yaml" \
    "log_dir=${log_dir} dataset_name=${dataset_name} finetuned=false"
done
