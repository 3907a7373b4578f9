#!/usr/bin/env bash
# ST pretrain (s2t_loss + s2t_transformer_hubert) then mixed-corpus S2ST
# fine-tune, through the PyTorch port (s2st_tpu_torch) on a CUDA card: the
# lines of recipes/run_mix_tuning.sh with s2st_tpu. -> s2st_tpu_torch.
# (tests/test_torch_paper_recipes.py holds them equal). As written, the
# second stage fails in both packages: the S2T checkpoint's encoder has
# neither the aux norms nor the speaker table of this model (a strict
# warm start), and one --speaker-embed-dim (64) cannot size both speaker
# tables at these widths (ROADMAP.md, faults of the reference).
set -euo pipefail

FEATURE_MANIFEST_ROOT=${FEATURE_MANIFEST_ROOT:?}
SAVE_DIR=${SAVE_DIR:-checkpoints/s2st_mix}
hubert_path=${hubert_path:?path to hubert_base_ls960.pt}

# kaldi-style CLI overrides: --stage 5 --stop-stage 7 ... (parse_options.sh)
. "$(dirname "$0")/parse_options.sh"

# stage 1: ST pretraining with the HuBERT frontend
python -m s2st_tpu_torch.cli.train "${FEATURE_MANIFEST_ROOT}" \
  --save-dir "${SAVE_DIR}/st_pretrain" \
  --config-yaml config.yaml --train-subset train --valid-subset dev \
  --task s2s_translation --criterion s2t_loss \
  --arch s2t_transformer_hubert --test-type st \
  --use-hubert True --load-pretrained-hubert-from "${hubert_path}" \
  --label-smoothing 0.1 --optimizer adam --lr "${st_lr:-2e-3}" \
  --lr-scheduler inverse_sqrt --warmup-updates 10000 --clip-norm 10.0 \
  --max-tokens "${max_tokens:-40000}" --max-update "${st_updates:-100000}" \
  --encoder-normalize-before --decoder-normalize-before --fp16 --seed 1

# stage 2: mixed-corpus S2ST fine-tune, corpus-id speaker embeddings
python -m s2st_tpu_torch.cli.train "${FEATURE_MANIFEST_ROOT}" \
  --save-dir "${SAVE_DIR}/finetune" \
  --config-yaml config.yaml \
  --train-subset train_fisher,train_mls --valid-subset dev_fisher \
  --task s2s_translation --criterion s2st_loss --arch s2st_transformer \
  --use-hubert True --load-pretrained-hubert-from "${hubert_path}" \
  --load-pretrained-encoder-from "${SAVE_DIR}/st_pretrain/checkpoint_last.npz" \
  --speaker-to-id '{"fisher_spanish":0,"mls_spanish":1}' \
  --n-frames-per-step 4 --bce-pos-weight 5.0 \
  --encoder-normalize-before --decoder-normalize-before \
  --optimizer adam --lr "${lr:-1e-3}" --lr-scheduler inverse_sqrt \
  --warmup-updates 10000 --clip-norm 1.0 --label-smoothing 0.1 \
  --asr-ce-weight 1.0 --st-ce-weight 1.0 --ctc-weight 1.0 \
  --middle-layers 6,8 --report-accuracy --fp16 --seed 1 \
  --max-tokens "${max_tokens:-40000}" --max-update "${updates:-400000}" \
  --eval-inference --best-checkpoint-metric mcd_loss \
  --keep-best-checkpoints 50 --keep-last-epochs 50
