#!/usr/bin/env bash
# Periodic validation while training runs (parity:
# examples/s2s_trans/valide_during_train.sh — average the last N epoch
# checkpoints, then decode/evaluate the averaged model on a held-out split;
# the reference's convert_pt_to512 dim hack is unnecessary here: the .npz
# checkpoints carry the true dims).
#
# Usage (env-var overridable, kaldi-style):
#   SAVE_DIR=checkpoints/s2st FEATURE_MANIFEST_ROOT=... \
#   AUDIO_MANIFEST_ROOT=... SPLIT=dev bash recipes/valide_during_train.sh
set -euo pipefail

SAVE_DIR=${SAVE_DIR:?checkpoint dir of the running training}
FEATURE_MANIFEST_ROOT=${FEATURE_MANIFEST_ROOT:?feature manifest root}
AUDIO_MANIFEST_ROOT=${AUDIO_MANIFEST_ROOT:-}
SPLIT=${SPLIT:-dev}
num_epoch_checkpoints=${num_epoch_checkpoints:-15}
middle_layers=${middle_layers:-6,8}
asr_ce_weight=${asr_ce_weight:-1.0}
st_ce_weight=${st_ce_weight:-1.0}
ctc_weight=${ctc_weight:-1.0}
asr_model_path=${asr_model_path:-}

# kaldi-style CLI overrides: --stage 5 --stop-stage 7 ... (parse_options.sh)
. "$(dirname "$0")/parse_options.sh"

CKPT=${SAVE_DIR}/checkpoint_last_avg${num_epoch_checkpoints}.npz
DUMP=${SAVE_DIR}/dump_wav_${SPLIT}_valid

python -m s2st_tpu_torch.cli.average_checkpoints \
  --inputs "${SAVE_DIR}" \
  --num-epoch-checkpoints "${num_epoch_checkpoints}" \
  --output "${CKPT}"

python -m s2st_tpu_torch.cli.generate_waveform "${FEATURE_MANIFEST_ROOT}" \
  --config-yaml config.yaml --gen-subset "${SPLIT}" \
  --task s2s_translation --path "${CKPT}" \
  --max-tokens 100000 --spec-bwd-max-iter 64 --n-frames-per-step 4 \
  --middle-layers "${middle_layers}" \
  --asr-ce-weight "${asr_ce_weight}" --st-ce-weight "${st_ce_weight}" \
  --ctc-weight "${ctc_weight}" --encoder-normalize-before \
  --decoder-normalize-before --fp16 \
  --dump-waveforms --results-path "${DUMP}"

if [ -n "${AUDIO_MANIFEST_ROOT}" ]; then
  python -m s2st_tpu_torch.cli.evaluate_s2s_bleu \
    --audio-manifest-file "${AUDIO_MANIFEST_ROOT}/${SPLIT}.audio_phone.tsv" \
    --decode-save-path "${DUMP}" \
    --out-result-file "${DUMP}/decode.txt" \
    --scoring sacrebleu \
    ${asr_model_path:+--asr-model-path "${asr_model_path}"}
fi
