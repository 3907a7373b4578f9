#!/usr/bin/env bash
# Text-loss-only pretraining then full fine-tuning, through the PyTorch
# port (s2st_tpu_torch) on a CUDA card: the lines of
# recipes/run_pretraining.sh with s2st_tpu. -> s2st_tpu_torch.
# (tests/test_torch_paper_recipes.py holds them equal).
set -euo pipefail

FEATURE_MANIFEST_ROOT=${FEATURE_MANIFEST_ROOT:?}
SAVE_DIR=${SAVE_DIR:-checkpoints/s2st_pretrain}

# kaldi-style CLI overrides: --stage 5 --stop-stage 7 ... (parse_options.sh)
. "$(dirname "$0")/parse_options.sh"
common=(
  --config-yaml config.yaml --train-subset train --valid-subset dev
  --task s2s_translation --criterion s2st_loss --arch s2st_transformer
  --n-frames-per-step 4 --bce-pos-weight 5.0
  --encoder-normalize-before --decoder-normalize-before
  --optimizer adam --lr "${lr:-1e-3}" --lr-scheduler inverse_sqrt
  --warmup-updates "${warmup_updates:-10000}" --clip-norm 1.0
  --label-smoothing 0.1 --asr-ce-weight 1.0 --st-ce-weight 1.0
  --ctc-weight 1.0 --middle-layers "${middle_layers:-6,8}"
  --report-accuracy --seed 1 --fp16 --log-format json
  --max-tokens "${max_tokens:-40000}"
)

# stage 1: text losses only (--l1/mse/eos/attn-loss-weight 0)
python -m s2st_tpu_torch.cli.train "${FEATURE_MANIFEST_ROOT}" \
  --save-dir "${SAVE_DIR}/stage1" "${common[@]}" \
  --l1-loss-weight 0 --mse-loss-weight 0 --eos-loss-weight 0 \
  --attn-loss-weight 0 \
  --max-update "${pretrain_updates:-100000}"

# stage 2: full fine-tune from the pretrained encoder+aux decoders
python -m s2st_tpu_torch.cli.train "${FEATURE_MANIFEST_ROOT}" \
  --save-dir "${SAVE_DIR}/stage2" "${common[@]}" \
  --load-pretrained-encoder-from "${SAVE_DIR}/stage1/checkpoint_last.npz" \
  --max-update "${finetune_updates:-400000}" \
  --eval-inference --best-checkpoint-metric mcd_loss \
  --keep-best-checkpoints 50 --keep-last-epochs 50
