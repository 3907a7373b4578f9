"""Stage 8: ASR-BLEU (or ASR-WER) of the waveforms stage 7 dumped.

Counterpart of ``s2st_tpu/cli/evaluate_s2s_bleu.py`` (:30-130): each
``<id>_pred.wav`` under ``--decode-save-path``/wav is transcribed by a
wav2vec2 CTC model, the transcript and the manifest's reference are
normalised (punctuation other than ``'`` to spaces, lowercase, one space
between words), ``hyp\\tref\\tid`` lines go to ``--out-result-file`` in the
manifest's row order (a missing WAV gives an empty hypothesis, so stage 9's
streams stay aligned), and the score line is printed:

    python -m s2st_tpu_torch.cli.evaluate_s2s_bleu \\
        --audio-manifest-file test.audio_phone.tsv \\
        --decode-save-path dump --out-result-file dump/decode.txt \\
        --scoring sacrebleu --asr-model-path /path/to/wav2vec2-dir

The transcriber is the port's own ``Wav2Vec2ForCTC``
(``models/wav2vec2_ctc.py``), one utterance at a time in fp32, on CUDA
unless ``--device`` names another device. ``--asr-model-path`` is an HF
model directory or a hub id in the local hub cache; nothing is
downloaded, and a model that cannot be loaded exits 2.
"""

from __future__ import annotations

import argparse
import csv
import logging
import re
import string
import sys
from pathlib import Path

from ..data.audio_utils import read_wav
from ..nn.core import disable_tf32, resolve_device
from ..scoring import BleuScorer, WerScorer

logger = logging.getLogger("s2st_tpu_torch.evaluate_s2s_bleu")

PUNC = string.punctuation.replace("'", "")


def normalize_text(s: str) -> str:
    s = re.sub(f"[{re.escape(PUNC)}]", " ", s)
    return " ".join(s.lower().split())


def evaluate(transcriber, audio_manifest_file: str, decode_save_path: str,
             out_result_file: str, scoring: str = "sacrebleu",
             reference_field: str = "tgt_text") -> str:
    """Transcribe every manifest row's ``<id>_pred.wav`` with
    ``transcriber(wave, sr)``, write ``hyp\\tref\\tid`` lines and return the
    scorer's result string."""
    with open(audio_manifest_file, encoding="utf-8") as f:
        rows = [(row["id"], row[reference_field]) for row in
                csv.DictReader(f, delimiter="\t", quoting=csv.QUOTE_NONE)]
    wav_dir = Path(decode_save_path) / "wav"
    out_path = Path(out_result_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    scorer = (WerScorer(lowercase=True, remove_punct=True)
              if scoring == "wer" else BleuScorer(lowercase=True))
    n = 0
    with open(out_path, "w", encoding="utf-8") as out:
        for uid, ref_text in rows:
            wav_path = wav_dir / f"{uid}_pred.wav"
            ref_n = normalize_text(ref_text)
            if not wav_path.exists():
                logger.warning(f"missing {wav_path.name}; emitting empty "
                               "hypothesis to keep line alignment")
                out.write(f"\t{ref_n}\t{uid}\n")
                scorer.add_string(ref_n, "")
                continue
            wave, sr = read_wav(str(wav_path))
            hyp_n = normalize_text(transcriber(wave, sr))
            out.write(f"{hyp_n}\t{ref_n}\t{uid}\n")
            scorer.add_string(ref_n, hyp_n)
            n += 1
    logger.info(f"scored {n} utterances ({len(rows) - n} missing)")
    return scorer.result_string()


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--audio-manifest-file", required=True,
                   help="TSV with id + tgt_text reference transcripts")
    p.add_argument("--decode-save-path", required=True,
                   help="generate_waveform --results-path (contains wav/)")
    p.add_argument("--out-result-file", required=True)
    p.add_argument("--scoring", default="sacrebleu",
                   choices=["sacrebleu", "wer"])
    p.add_argument("--asr-model-path",
                   default="facebook/wav2vec2-large-960h-lv60-self",
                   help="HF model dir or cached hub id")
    p.add_argument("--reference-field", default="tgt_text")
    p.add_argument("--device", default=None,
                   help="torch device; CUDA when not given")
    return p


def main(argv=None, transcriber=None) -> int:
    logging.basicConfig(level=logging.INFO, stream=sys.stdout)
    args = get_parser().parse_args(argv)
    if transcriber is None:
        from ..models.wav2vec2_ctc import Transcriber
        disable_tf32()
        device = resolve_device(args.device)
        try:
            transcriber = Transcriber(args.asr_model_path, device)
        except (OSError, ValueError, KeyError, RuntimeError,
                NotImplementedError) as e:
            logger.error(
                f"cannot load ASR model '{args.asr_model_path}': {e}\n"
                "This environment has no network egress; download the model "
                "elsewhere and pass --asr-model-path /path/to/dir")
            return 2
    result = evaluate(transcriber, args.audio_manifest_file,
                      args.decode_save_path, args.out_result_file,
                      scoring=args.scoring,
                      reference_field=args.reference_field)
    print(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
