#!/usr/bin/env bash
# Fisher Es->En direct S2ST baseline recipe, stages 1-11, through the
# PyTorch port (s2st_tpu_torch) on a CUDA card: the lines of
# recipes/run_baseline.sh with s2st_tpu. -> s2st_tpu_torch.
# (tests/test_torch_recipe.py holds them equal).
#
# Stages:
#   1  audio manifests from metadata TSVs
#   2  split -> parallel g2p phonemization -> concat
#   3  feature/manifest preprocessing (fbank80 src, logmel80 tgt, computed
#      on the card; zips, gcmvn, vocabs, config.yaml)
#   5  train s2st_transformer (aux ASR/ST decoders + CTC)
#   6  average last 15 epoch checkpoints
#   7  dump waveforms on the test split
#   8  ASR-BLEU of dumped waveforms (the port's own wav2vec2 CTC ASR from a
#      local HF model directory, asr_model_path)
#   9  multi-reference BLEU
#   10 aux ASR WER   (beam decode from aux_asr_decoder)
#   11 aux ST BLEU   (beam decode from aux_st_decoder)
set -euo pipefail

stage=${stage:-3}
stop_stage=${stop_stage:-11}

AUDIO_MANIFEST_ROOT=${AUDIO_MANIFEST_ROOT:?path to <split>.audio_phone.tsv}
FEATURE_MANIFEST_ROOT=${FEATURE_MANIFEST_ROOT:?output feature root}
SAVE_DIR=${SAVE_DIR:-checkpoints/s2st_baseline}
SPLIT=${SPLIT:-tst}

# ---- reference stage-5 operating point (run_baseline.sh:20-47) ----
max_tokens=${max_tokens:-60000}
max_update=${max_update:-100000}
lr=${lr:-1.5e-3}
warmup_updates=${warmup_updates:-4000}
clip_norm=${clip_norm:-1.0}
dropout=${dropout:-0.1}
middle_layers=${middle_layers:-4,9}
ctc_weight=${ctc_weight:-0.0}
asr_ce_weight=${asr_ce_weight:-0.3}
st_ce_weight=${st_ce_weight:-0.3}
update_freq=${update_freq:-1}
num_workers=${num_workers:-4}
prenet_dim=${prenet_dim:-32}          # "follow the google's paper setting"
max_source_positions=${max_source_positions:-3000}
aux_asr_decoder=${aux_asr_decoder:-1}  # aux decoder LAYERS (ref :42-43)
aux_st_decoder=${aux_st_decoder:-1}
asr_decoder_embed_dim=${asr_decoder_embed_dim:-64}
st_decoder_embed_dim=${st_decoder_embed_dim:-64}
encoder_attention_heads=${encoder_attention_heads:-4}
decoder_attention_heads=${decoder_attention_heads:-4}
decoder_ffn_embed_dim=${decoder_ffn_embed_dim:-2048}
use_hubert=${use_hubert:-False}
hubert_path=${hubert_path:-}
log_path=${log_path:-${SAVE_DIR}/log.txt}
tensorboard_path=${tensorboard_path:-${SAVE_DIR}/tensorboard}

# ---- stage 1-2 inputs ----
METADATA_TSVS=${METADATA_TSVS:-}       # stage 1: raw metadata TSVs
AUDIO_DATA_ROOT=${AUDIO_DATA_ROOT:-.}  # stage 1: audio file root
g2p_nj=${g2p_nj:-8}                    # stage 2: parallel g2p jobs

asr_model_path=${asr_model_path:-}     # stage 8: local HF wav2vec2 dir
multi_ref_dir=${multi_ref_dir:-.}      # stage 9: en.N.norm.lc.rm files

# kaldi-style CLI overrides: --stage 5 --stop-stage 7 ... (parse_options.sh)
. "$(dirname "$0")/parse_options.sh"

if [ "${stage}" -le 1 ] && [ "${stop_stage}" -ge 1 ]; then
  # reference stage 1 (run_baseline.sh:55-60): build <split>.audio.tsv
  # manifests (id, src_audio, tgt_audio, n_frames, texts, speaker)
  [ -n "${METADATA_TSVS}" ] || {
    echo "stage 1 needs METADATA_TSVS (space-separated metadata files)"; exit 1; }
  python -m s2st_tpu_torch.preprocessing.audio_manifest \
    --metadata ${METADATA_TSVS} \
    --audio-root "${AUDIO_DATA_ROOT}" \
    --output-root "${AUDIO_MANIFEST_ROOT}"
fi

if [ "${stage}" -le 2 ] && [ "${stop_stage}" -ge 2 ]; then
  # reference stage 2 (run_baseline.sh:62-81): split each manifest into nj
  # parts, phonemize in parallel, concatenate back
  for x in "${SPLIT}" dev train; do
    [ -f "${AUDIO_MANIFEST_ROOT}/${x}.audio.tsv" ] || continue
    splitdir=${AUDIO_MANIFEST_ROOT}/split_${g2p_nj}/${x}
    mkdir -p "${splitdir}/log"
    python -m s2st_tpu_torch.preprocessing.split_file \
      --type split --n "${g2p_nj}" \
      --input-file "${AUDIO_MANIFEST_ROOT}/${x}.audio.tsv" \
      --output-path "${splitdir}"
    pids=()
    for j in $(seq 1 "${g2p_nj}"); do
      part=${splitdir}/${x}.audio.${j}.tsv
      [ -f "${part}" ] || continue
      python -m s2st_tpu_torch.preprocessing.g2p \
        --input-file "${part}" \
        --output-file "${splitdir}/${x}.audio_phone.${j}.tsv" \
        > "${splitdir}/log/log.${j}" 2>&1 &
      pids+=($!)
    done
    for pid in "${pids[@]}"; do wait "${pid}"; done
    python -m s2st_tpu_torch.preprocessing.split_file \
      --type contat \
      --file-part "${splitdir}/${x}.audio_phone."*.tsv \
      --output-path "${AUDIO_MANIFEST_ROOT}"
  done
fi

if [ "${stage}" -le 3 ] && [ "${stop_stage}" -ge 3 ]; then
  python -m s2st_tpu_torch.cli.get_feature_manifest \
    --audio-manifest-root "${AUDIO_MANIFEST_ROOT}" \
    --output-root "${FEATURE_MANIFEST_ROOT}" \
    --splits train dev "${SPLIT}" --ipa-vocab --use-g2p
fi

if [ "${stage}" -le 5 ] && [ "${stop_stage}" -ge 5 ]; then
  mkdir -p "${SAVE_DIR}"
  python -m s2st_tpu_torch.cli.train "${FEATURE_MANIFEST_ROOT}" \
    --save-dir "${SAVE_DIR}" \
    --config-yaml config.yaml --train-subset train --valid-subset dev \
    --num-workers "${num_workers}" \
    --max-tokens "${max_tokens}" --max-update "${max_update}" \
    --task s2s_translation --criterion s2st_loss --arch s2st_transformer \
    --clip-norm "${clip_norm}" --n-frames-per-step 4 --bce-pos-weight 5.0 \
    --dropout "${dropout}" --attention-dropout 0.1 --activation-dropout 0.01 \
    --encoder-normalize-before --decoder-normalize-before \
    --optimizer adam --lr "${lr}" --lr-scheduler inverse_sqrt \
    --warmup-updates "${warmup_updates}" \
    --seed 1 --update-freq "${update_freq}" \
    --eval-inference --best-checkpoint-metric mcd_loss \
    --use-hubert "${use_hubert}" \
    ${hubert_path:+--load-pretrained-hubert-from "${hubert_path}"} \
    --label-smoothing 0.1 --asr-ce-weight "${asr_ce_weight}" \
    --st-ce-weight "${st_ce_weight}" --report-accuracy \
    --skip-invalid-size-inputs-valid-test --ctc-weight "${ctc_weight}" \
    --middle-layers "${middle_layers}" \
    --log-file "${log_path}" --log-format json \
    --tensorboard-logdir "${tensorboard_path}" \
    --asr-decoder-layers "${aux_asr_decoder}" \
    --st-decoder-layers "${aux_st_decoder}" \
    --asr-decoder-embed-dim "${asr_decoder_embed_dim}" \
    --st-decoder-embed-dim "${st_decoder_embed_dim}" \
    --prenet-dim "${prenet_dim}" \
    --max-source-positions "${max_source_positions}" \
    --fp16 \
    --validate-after-updates 300000 \
    --disable-validation \
    --keep-best-checkpoints 50 \
    --keep-last-epochs 50 \
    --encoder-attention-heads "${encoder_attention_heads}" \
    --decoder-attention-heads "${decoder_attention_heads}" \
    --decoder-ffn-embed-dim "${decoder_ffn_embed_dim}"
fi

if [ "${stage}" -le 6 ] && [ "${stop_stage}" -ge 6 ]; then
  python -m s2st_tpu_torch.cli.average_checkpoints \
    --inputs "${SAVE_DIR}" --num-epoch-checkpoints 15 \
    --output "${SAVE_DIR}/checkpoint_last_avg15.npz"
fi

CKPT=${SAVE_DIR}/checkpoint_last_avg15.npz
DUMP=${SAVE_DIR}/dump_wav_${SPLIT}

if [ "${stage}" -le 7 ] && [ "${stop_stage}" -ge 7 ]; then
  python -m s2st_tpu_torch.cli.generate_waveform "${FEATURE_MANIFEST_ROOT}" \
    --config-yaml config.yaml --gen-subset "${SPLIT}" \
    --task s2s_translation --path "${CKPT}" \
    --max-tokens 100000 --spec-bwd-max-iter 64 --n-frames-per-step 4 \
    --middle-layers "${middle_layers}" \
    --asr-ce-weight "${asr_ce_weight}" --st-ce-weight "${st_ce_weight}" \
    --ctc-weight "${ctc_weight}" --encoder-normalize-before \
    --decoder-normalize-before --fp16 \
    --asr-decoder-layers "${aux_asr_decoder}" \
    --st-decoder-layers "${aux_st_decoder}" \
    --asr-decoder-embed-dim "${asr_decoder_embed_dim}" \
    --st-decoder-embed-dim "${st_decoder_embed_dim}" \
    --prenet-dim "${prenet_dim}" \
    --dump-waveforms --dump-attentions --dump-features --dump-plots \
    --dump-target --results-path "${DUMP}"
fi

if [ "${stage}" -le 8 ] && [ "${stop_stage}" -ge 8 ]; then
  # ASR-BLEU of the dumped waveforms (reference stage 8): transcribe the
  # *_pred.wav with the wav2vec2 CTC ASR, sacrebleu vs the manifest
  # transcripts. Offline image: put the HF checkpoint on disk and point
  # asr_model_path at it.
  python -m s2st_tpu_torch.cli.evaluate_s2s_bleu \
    --audio-manifest-file "${AUDIO_MANIFEST_ROOT}/${SPLIT}.audio_phone.tsv" \
    --decode-save-path "${DUMP}" \
    --out-result-file "${DUMP}/decode.txt" \
    --scoring sacrebleu \
    ${asr_model_path:+--asr-model-path "${asr_model_path}"}
fi

if [ "${stage}" -le 9 ] && [ "${stop_stage}" -ge 9 ]; then
  # multi-reference BLEU (reference stage 9): cut the prediction stream out
  # of decode.txt and score against the N Fisher reference files
  # (en.0.norm.lc.rm .. en.3.norm.lc.rm) placed under ${multi_ref_dir}
  echo "Evaluate multi-references BLEU"
  cut -f1 "${DUMP}/decode.txt" > "${DUMP}/decode.txt.prediction"
  refs=()
  for r in "${multi_ref_dir}"/en.*.norm.lc.rm; do
    [ -f "$r" ] && refs+=("$r")
  done
  if [ "${#refs[@]}" -eq 0 ]; then
    echo "stage 9: no ${multi_ref_dir}/en.*.norm.lc.rm reference files" \
         "found — set multi_ref_dir; skipping multi-reference BLEU" >&2
  else
    python -m s2st_tpu_torch.cli.score --scoring sacrebleu --ignore-case \
      --sys "${DUMP}/decode.txt.prediction" --ref "${refs[@]}"
  fi
fi

if [ "${stage}" -le 10 ] && [ "${stop_stage}" -ge 10 ]; then
  python -m s2st_tpu_torch.cli.generate_for_s2st "${FEATURE_MANIFEST_ROOT}" \
    --config-yaml config.yaml --gen-subset "${SPLIT}" \
    --task s2s_translation --path "${CKPT}" \
    --max-tokens 50000 --beam 5 --middle-layers "${middle_layers}" \
    --asr-ce-weight "${asr_ce_weight}" --st-ce-weight "${st_ce_weight}" \
    --encoder-normalize-before --decoder-normalize-before --fp16 \
    --asr-decoder-layers "${aux_asr_decoder}" \
    --st-decoder-layers "${aux_st_decoder}" \
    --asr-decoder-embed-dim "${asr_decoder_embed_dim}" \
    --st-decoder-embed-dim "${st_decoder_embed_dim}" \
    --prenet-dim "${prenet_dim}" \
    --scoring wer --wer-lowercase --wer-remove-punct
fi

if [ "${stage}" -le 11 ] && [ "${stop_stage}" -ge 11 ]; then
  python -m s2st_tpu_torch.cli.generate_for_s2st "${FEATURE_MANIFEST_ROOT}" \
    --config-yaml config.yaml --gen-subset "${SPLIT}" \
    --task s2s_translation --path "${CKPT}" \
    --max-tokens 50000 --beam 5 --middle-layers "${middle_layers}" \
    --asr-ce-weight "${asr_ce_weight}" --st-ce-weight "${st_ce_weight}" \
    --encoder-normalize-before --decoder-normalize-before --fp16 \
    --asr-decoder-layers "${aux_asr_decoder}" \
    --st-decoder-layers "${aux_st_decoder}" \
    --asr-decoder-embed-dim "${asr_decoder_embed_dim}" \
    --st-decoder-embed-dim "${st_decoder_embed_dim}" \
    --prenet-dim "${prenet_dim}" \
    --scoring sacrebleu
fi
