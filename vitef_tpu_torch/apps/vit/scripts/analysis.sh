#!/usr/bin/env bash
# Plasticity analysis for base/large/huge on all datasets, on the port
# (apps/vit/scripts/analysis.sh's commands; writes
# savings/analysis/analysis_vit-<size>-...-in21k_pretrained_True_<dataset>/distances.pkl).
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

session="analysis"
for model_name in base large huge; do
  patch_size=16
  if [ "${model_name}" = "huge" ]; then patch_size=14; fi
  for dataset_name in "${DATASETS[@]}"; do
    queue_cmd "${session}" \
      "python -m vitef_tpu_torch.apps.vit.analysis run --model_name ${model_name}" \
      "--patch_size ${patch_size} --dataset_name ${dataset_name}"
  done
done
