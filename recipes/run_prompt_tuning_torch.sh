#!/usr/bin/env bash
# Prompt tuning through the PyTorch port (s2st_tpu_torch) on a CUDA card:
# the lines of recipes/run_prompt_tuning.sh with s2st_tpu. ->
# s2st_tpu_torch (tests/test_torch_paper_recipes.py holds them equal). As
# written it fails in both packages: a checkpoint without speaker tables
# cannot warm-start a speaker model strictly, and --speaker-embed-dim 512
# is not the decoder's frame width (4 x 80) (ROADMAP.md, faults of the
# reference).
set -euo pipefail

FEATURE_MANIFEST_ROOT=${FEATURE_MANIFEST_ROOT:?}
SAVE_DIR=${SAVE_DIR:-checkpoints/s2st_prompt}
pretrained=${pretrained:?path to pretrained s2st checkpoint_*.npz}

# kaldi-style CLI overrides: --stage 5 --stop-stage 7 ... (parse_options.sh)
. "$(dirname "$0")/parse_options.sh"

python -m s2st_tpu_torch.cli.train "${FEATURE_MANIFEST_ROOT}" \
  --save-dir "${SAVE_DIR}" \
  --config-yaml config.yaml --train-subset train --valid-subset dev \
  --task s2s_translation --criterion s2st_loss --arch s2st_transformer \
  --load-pretrained-encoder-from "${pretrained}" \
  --load-pretrained-decoder-from "${pretrained}" \
  --speaker-to-id "${speaker_to_id:-{\"fisher_spanish\":0}}" \
  --speaker-embed-dim 512 \
  --n-frames-per-step 4 --bce-pos-weight 5.0 \
  --encoder-normalize-before --decoder-normalize-before \
  --optimizer adam --lr "${lr:-5e-4}" --lr-scheduler inverse_sqrt \
  --warmup-updates 4000 --clip-norm 1.0 --label-smoothing 0.1 \
  --asr-ce-weight 1.0 --st-ce-weight 1.0 --ctc-weight 1.0 \
  --middle-layers 6,8 --report-accuracy --fp16 --seed 1 \
  --max-tokens "${max_tokens:-40000}" --max-update "${updates:-100000}" \
  --eval-inference --best-checkpoint-metric mcd_loss
