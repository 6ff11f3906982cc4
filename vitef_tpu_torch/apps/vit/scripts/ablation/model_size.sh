#!/usr/bin/env bash
# Model-size ablation on the port: ViT-Large / ViT-Huge finetuning with
# gradient accumulation to keep the effective batch at 512
# (apps/vit/scripts/ablation/model_size.sh's commands).
set -u
source "$(dirname "$0")/../sweep_lib.sh"

DATASETS=(cifar10 cifar100)

for model_name in large huge; do
  patch_size=16
  if [ "${model_name}" = "huge" ]; then patch_size=14; fi
  # halve the per-step batch, double the accumulation
  batch=256
  acc=2
  for dataset_name in "${DATASETS[@]}"; do
    session="size_${model_name}_${dataset_name}"
    for seed in "${SEEDS[@]}"; do
      for lr in $(lrs_for "${dataset_name}"); do
        for i in "${!FREEZE_CONFIGS[@]}"; do
          log_dir="vit_${model_name}_${dataset_name}_seed_${seed}_lr_${lr}_comp_${i}"
          queue_cmd "${session}" \
            "python -m vitef_tpu_torch.apps.vit.train config=apps/vit/configs/${dataset_name}.yaml" \
            "dataset_name=${dataset_name} model_name=${model_name}" \
            "patch_size=${patch_size} batch_size=${batch} grad_acc_steps=${acc}" \
            "log_dir=${log_dir} seed=${seed} lr=${lr} '${FREEZE_CONFIGS[$i]}'"
        done
      done
    done
  done
done
