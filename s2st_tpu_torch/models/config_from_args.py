"""Model flags and the model config a checkpoint implies.

Counterpart of ``s2st_tpu/options.py``: the model flags with the same names
and defaults (:222-303, :484-488, the HuBERT frontend's :70-75),
``model_args_from_checkpoint`` (:2371),
which lets the checkpoint's own flag echo (``__meta__["args"]``) override
the command line for every architectural key and ``--model-overrides``
override both, and ``build_model_config``
(:2445-2509), and the archs the port builds with their defaults
(``apply_arch``, the arch functions of options.py:700-1004) and configs:
``s2st_transformer`` and ``s2st_transformer_mtl`` (``model_config``), the
S2T archs (``S2T_ARCHS``, ``s2t_config``), ``t2s_transformer``
(``t2s_config``), ``xm_transformer`` (``xm_config``),
``convtransformer[_espnet]`` (``convtransformer_config``), the four
``s2t_berard`` sizes (``berard_config``), ``tacotron_2`` / ``tacotron2``
(``tacotron2_config``, its flags :270-280) and ``fastspeech2``
(``fastspeech2_config``, its flags :289-300); ``arch_family`` names the
model an arch builds, as JAX's ``build_model_and_loss`` dispatches
(tasks/s2s_translation.py:113-294): all seven of its families.
``model_config`` takes the vocabulary sizes from the caller
(the training CLI's dictionaries); ``build_model_config`` takes them, and
the speaker count, from a checkpoint's array shapes, so that generation
loads no dictionary.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
from typing import Any, Dict, List, Optional

import torch

from .s2st_transformer import S2STConfig

# run-time keys the checkpoint's echo never overrides (options.py:2362)
GEN_CLI_KEYS = frozenset({
    "data", "task", "path", "gen_subset", "train_subset", "valid_subset",
    "config_yaml", "results_path", "user_dir", "max_tokens", "batch_size",
    "max_sentences", "num_workers", "seed", "scoring", "beam", "nbest",
    "model_overrides", "skip_invalid_size_inputs_valid_test",
    "required_batch_size_multiple", "source_lang", "target_lang",
})


def _str2bool(v: str) -> bool:
    return str(v).lower() in ("1", "true", "yes", "y")


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arch", default="s2st_transformer")
    p.add_argument("--fp16", action="store_true",
                   help="bfloat16 compute")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--n-frames-per-step", type=int, default=1)
    p.add_argument("--max-source-positions", type=int, default=3000)
    p.add_argument("--max-target-positions", type=int, default=2400)
    p.add_argument("--use-hubert", type=_str2bool, default=False)
    p.add_argument("--load-pretrained-hubert-from", default=None,
                   help="a fairseq HuBERT .pt; the train CLI loads its trunk "
                   "into the frontend")
    p.add_argument("--hubert-hidden", type=int, default=768)
    p.add_argument("--hubert-layers", type=int, default=12)
    p.add_argument("--hubert-ffn", type=int, default=3072)
    p.add_argument("--hubert-heads", type=int, default=12)
    p.add_argument("--encoder-layers", type=int, default=12)
    p.add_argument("--encoder-embed-dim", type=int, default=512)
    p.add_argument("--encoder-ffn-embed-dim", type=int, default=2048)
    p.add_argument("--encoder-attention-heads", type=int, default=4)
    p.add_argument("--encoder-normalize-before", action="store_true",
                   help="accepted for the recipe; always on, as in JAX")
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--decoder-embed-dim", type=int, default=512)
    p.add_argument("--decoder-ffn-embed-dim", type=int, default=2048)
    p.add_argument("--decoder-attention-heads", type=int, default=4)
    p.add_argument("--decoder-normalize-before", action="store_true",
                   help="accepted for the recipe; always on, as in JAX")
    p.add_argument("--conv-kernel-sizes", default="5,5")
    p.add_argument("--conv-channels", type=int, default=1024)
    p.add_argument("--middle-layers", default="6")
    p.add_argument("--middle-layers-decoder", default="",
                   help="MTL: comma-separated decoder tap layers")
    p.add_argument("--prenet-layers", type=int, default=2)
    p.add_argument("--prenet-dim", type=int, default=256)
    p.add_argument("--prenet-dropout", type=float, default=0.5)
    p.add_argument("--postnet-layers", type=int, default=5)
    p.add_argument("--postnet-conv-dim", type=int, default=512)
    p.add_argument("--postnet-conv-kernel-size", type=int, default=5)
    p.add_argument("--postnet-dropout", type=float, default=0.5)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--attention-dropout", type=float, default=0.1)
    p.add_argument("--activation-dropout", type=float, default=0.01)
    p.add_argument("--output-frame-dim", type=int, default=80)
    p.add_argument("--asr-decoder-layers", type=int, default=6)
    p.add_argument("--asr-decoder-embed-dim", type=int, default=256)
    p.add_argument("--st-decoder-layers", type=int, default=6)
    p.add_argument("--st-decoder-embed-dim", type=int, default=256)
    p.add_argument("--speaker-embed-dim", type=int, default=64)
    # the T2S text encoder's knobs (options.py:265-269)
    p.add_argument("--encoder-conv-layers", type=int, default=3)
    p.add_argument("--encoder-conv-kernel-size", type=int, default=5)
    p.add_argument("--encoder-dropout", type=float, default=0.5)
    p.add_argument("--encoder-transformer-layers", type=int, default=6)
    p.add_argument("--activation-fn", default="relu")
    p.add_argument("--no-scale-embedding", action="store_true")
    p.add_argument("--ctc-weight", type=float, default=0.0)
    p.add_argument("--ctc-weight-tgt", type=float, default=0.0)
    p.add_argument("--asr-ce-weight", type=float, default=0.0)
    p.add_argument("--st-ce-weight", type=float, default=0.0)
    # Tacotron2 (options.py:270-280)
    p.add_argument("--encoder-lstm-layers", type=int, default=1)
    p.add_argument("--attention-dim", type=int, default=128)
    p.add_argument("--attention-conv-dim", type=int, default=32)
    p.add_argument("--attention-conv-kernel-size", type=int, default=15)
    p.add_argument("--init-attn-c", default="zero", choices=["zero", "avg"])
    p.add_argument("--attention-use-cumprob", action="store_true",
                   default=True)
    p.add_argument("--zoneout", type=float, default=0.1)
    p.add_argument("--decoder-lstm-layers", type=int, default=2)
    p.add_argument("--decoder-lstm-dim", type=int, default=1024)
    # FastSpeech2 (options.py:289-300)
    p.add_argument("--fft-hidden-dim", type=int, default=1024)
    p.add_argument("--fft-kernel-size", type=int, default=9)
    p.add_argument("--var-pred-n-bins", type=int, default=256)
    p.add_argument("--var-pred-hidden-dim", type=int, default=256)
    p.add_argument("--var-pred-kernel-size", type=int, default=3)
    p.add_argument("--var-pred-dropout", type=float, default=0.5)
    p.add_argument("--pitch-min", type=float, default=0.0)
    p.add_argument("--pitch-max", type=float, default=600.0)
    p.add_argument("--energy-min", type=float, default=0.0)
    p.add_argument("--energy-max", type=float, default=5.0)
    p.add_argument("--add-postnet", action="store_true",
                   help="FastSpeech2: refine the features with a postnet")
    # the S2T criterion's targets (options.py:281-282)
    p.add_argument("--test-type", default="st", choices=["st", "asr"])


# the S2T archs' defaults (options.py:735-737, :1008-1013, :1938-2004):
# the size suffix -> (width, heads, FFN width, dropout, encoder layers,
# decoder layers), the layers None where the size keeps the flags'; each
# size also with ``_hubert``, which turns the frontend on
_S2T_SIZES = {"": None,
              "_s": (256, 4, 2048, 0.1, None, None),
              "_xs": (256, 4, 1024, 0.3, 6, 3),
              "_sp": (256, 4, 2048, 0.1, 16, None),
              "_m": (512, 8, 2048, 0.15, None, None),
              "_mp": (512, 8, 2048, 0.15, 16, None),
              "_l": (1024, 16, 4096, 0.2, None, None),
              "_lp": (1024, 16, 4096, 0.2, 16, None)}
S2T_ARCHS = {f"s2t_transformer{hub}{suffix}": (bool(hub), size)
             for hub in ("", "_hubert")
             for suffix, size in _S2T_SIZES.items()}


# the other archs' defaults (options.py:705-711, :938-953, :981-1004)
_CONVTRANSFORMER = dict(
    encoder_layers=6, encoder_embed_dim=512, encoder_ffn_embed_dim=2048,
    encoder_attention_heads=8, decoder_layers=6, decoder_embed_dim=512,
    decoder_ffn_embed_dim=2048, decoder_attention_heads=8, dropout=0.1,
    attention_dropout=0.0, activation_dropout=0.0)
# Berard's archs (options.py:956-980, :2230-2250). Its sizes are no flags
# in JAX: the arch functions set them on the namespace, the layer lists as
# Python literals. ``s2t_berard`` keeps the parser's --attention-dim (128;
# the arch function's getattr default of 512 never applies, ROADMAP §3)
_BERARD = dict(input_layers="[256, 128]",
               conv_layers="[(16, 3, 2), (16, 3, 2)]", num_blstm_layers=3,
               lstm_size=256, dropout=0.2, decoder_embed_dim=128,
               decoder_num_layers=2, decoder_hidden_dim=512,
               output_layer_dim=128)
_BERARD_512 = dict(_BERARD, num_blstm_layers=5, lstm_size=512, dropout=0.3,
                   decoder_embed_dim=256, decoder_num_layers=3,
                   decoder_hidden_dim=1024, attention_dim=512,
                   output_layer_dim=256)
# arch -> (the model it builds, its defaults). JAX's build_model_and_loss
# matches ``t2s_transformer`` by prefix, so ``tts_transformer``, registered
# beside it, builds the S2ST model (ROADMAP §3). ``tacotron2`` builds what
# ``tacotron_2`` builds, as JAX's build_model_and_loss does (its CLI knows
# only ``tacotron_2``; the arch function sets the parser's defaults)
ARCHS = {
    "s2st_transformer": ("s2st", {}),
    # the decoder tap at 3 unless --middle-layers-decoder names others
    "s2st_transformer_mtl": ("s2st", {"middle_layers_decoder": "3"}),
    "tts_transformer": ("s2st", {}),
    "t2s_transformer": ("t2s", {}),
    "xm_transformer": ("xm", dict(use_hubert=True, decoder_layers=12,
                                  decoder_embed_dim=1024,
                                  decoder_ffn_embed_dim=4096,
                                  decoder_attention_heads=16,
                                  activation_fn="gelu")),
    "convtransformer": ("convtransformer", _CONVTRANSFORMER),
    "convtransformer_espnet": ("convtransformer", {
        **_CONVTRANSFORMER, "encoder_layers": 12,
        "encoder_attention_heads": 4, "decoder_attention_heads": 4}),
    "s2t_berard": ("berard", _BERARD),
    "s2t_berard_256_3_3": ("berard", dict(_BERARD, decoder_num_layers=3)),
    "s2t_berard_512_5_3": ("berard", _BERARD_512),
    "s2t_berard_512_3_2": ("berard", dict(_BERARD_512, num_blstm_layers=3,
                                          decoder_num_layers=2)),
    "tacotron_2": ("tacotron2", dict(encoder_embed_dim=512,
                                     encoder_dropout=0.5,
                                     encoder_conv_layers=3,
                                     encoder_conv_kernel_size=5)),
    "tacotron2": ("tacotron2", {}),
    "fastspeech2": ("fastspeech2", dict(
        encoder_layers=4, encoder_embed_dim=256, encoder_attention_heads=2,
        decoder_layers=4, decoder_embed_dim=256, decoder_attention_heads=2,
        dropout=0.2, attention_dropout=0.0)),
}


# the self-supervised and CTC archs (options.py:770-783, :852-866,
# :897-915); their tasks (tasks/audio_*.py) build the model. They set the
# parser's defaults only: a flag given on the command line wins
_SSL_BASE = dict(encoder_layers=12, encoder_embed_dim=768,
                 encoder_ffn_embed_dim=3072, encoder_attention_heads=12,
                 activation_dropout=0.0)
SSL_ARCHS = {
    "wav2vec2": dict(_SSL_BASE, dropout=0.1, attention_dropout=0.1,
                     quantize_targets=True, infonce=True),
    "hubert": dict(_SSL_BASE, dropout=0.1, attention_dropout=0.1,
                   mask_prob=0.8, loss_weights="10"),
    "wav2vec_ctc": dict(_SSL_BASE, dropout=0.0, attention_dropout=0.0,
                        dropout_input=0.0, dropout_features=0.0,
                        feature_grad_mult=0.0, mask_prob=0.65),
}
SSL_ARCHS["hubert_ctc"] = SSL_ARCHS["wav2vec_ctc"]


def add_wav2vec2_args(p: argparse.ArgumentParser) -> None:
    """The audio tasks' flags (``add_wav2vec2_args``, options.py:400-475;
    wav2vec 1.0's left out with its model)."""
    g = p.add_argument_group("wav2vec2")
    g.add_argument("--sample-rate", type=int, default=16000)
    g.add_argument("--max-sample-size", type=int, default=250000)
    g.add_argument("--min-sample-size", type=int, default=32000)
    g.add_argument("--normalize", action="store_true",
                   help="layer-normalize each (cropped) waveform")
    g.add_argument("--conv-feature-layers",
                   default="[(512,10,5)]+[(512,3,2)]*4+[(512,2,2)]*2",
                   help="python literal [(dim, kernel, stride), ...]")
    g.add_argument("--final-dim", type=int, default=256)
    g.add_argument("--logit-temp", type=float, default=0.1)
    g.add_argument("--quantize-targets", action="store_true")
    g.add_argument("--latent-vars", type=int, default=320)
    g.add_argument("--latent-groups", type=int, default=2)
    g.add_argument("--latent-dim", type=int, default=0)
    g.add_argument("--latent-temp", default="(2.0,0.5,0.999995)")
    g.add_argument("--mask-prob", type=float, default=0.65)
    g.add_argument("--mask-length", default="10")
    g.add_argument("--num-negatives", type=int, default=100)
    g.add_argument("--cross-sample-negatives", type=int, default=0)
    g.add_argument("--dropout-input", type=float, default=0.1)
    g.add_argument("--dropout-features", type=float, default=0.1)
    g.add_argument("--feature-grad-mult", type=float, default=0.1)
    g.add_argument("--conv-pos", type=int, default=128)
    g.add_argument("--conv-pos-groups", type=int, default=16)
    g.add_argument("--layer-norm-first", action="store_true")
    g.add_argument("--infonce", action="store_true")
    g.add_argument("--loss-weights", default="0.1,10",
                   help="prob_ppl,features_pen weights")
    g.add_argument("--labels", default="km",
                   help="comma list of label suffixes")
    g.add_argument("--label-dir", default=None,
                   help="dir of {split}.{label} + dict.{label}.txt "
                   "(default: the data dir)")
    g.add_argument("--label-rate", type=float, default=50.0)
    g.add_argument("--untie-final-proj", action="store_true")
    g.add_argument("--skip-masked", action="store_true")
    g.add_argument("--skip-nomask", action="store_true")
    g.add_argument("--pred-masked-weight", type=float, default=1.0)
    g.add_argument("--pred-nomask-weight", type=float, default=0.0)
    g.add_argument("--w2v-path", default=None,
                   help="pretrained SSL trunk (a fairseq .pt or an .npz)")
    g.add_argument("--final-dropout", type=float, default=0.0)
    g.add_argument("--apply-mask", action="store_true",
                   help="apply the span mask during fine-tuning")
    g.add_argument("--mask-channel-prob", type=float, default=0.0)
    g.add_argument("--mask-channel-length", type=int, default=10)
    g.add_argument("--freeze-finetune-updates", type=int, default=0)
    g.add_argument("--blank-weight", type=float, default=0.0)
    g.add_argument("--blank-mode", default="add", choices=["add", "set"])
    g.add_argument("--no-zero-infinity", dest="zero_infinity",
                   action="store_false", default=True)


def wav2vec2_config(args: argparse.Namespace):
    """``build_wav2vec2_config`` (options.py:808-849): the trunk from the
    shared encoder flags, bf16 compute under ``--fp16``."""
    from .hubert import HubertConfig, conv_spec
    from .wav2vec2 import Wav2Vec2Config
    dtype = _dtype(args)
    trunk = HubertConfig(
        conv_layers=conv_spec(str(args.conv_feature_layers)),
        encoder_layers=args.encoder_layers,
        encoder_embed_dim=args.encoder_embed_dim,
        encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
        encoder_attention_heads=args.encoder_attention_heads,
        conv_pos=args.conv_pos, conv_pos_groups=args.conv_pos_groups,
        layer_norm_first=args.layer_norm_first, dtype=dtype)
    return Wav2Vec2Config(
        trunk=trunk, final_dim=args.final_dim, logit_temp=args.logit_temp,
        quantize_targets=args.quantize_targets,
        latent_vars=args.latent_vars, latent_groups=args.latent_groups,
        latent_dim=args.latent_dim,
        latent_temp=tuple(ast.literal_eval(str(args.latent_temp))),
        mask_prob=args.mask_prob, mask_length=int(args.mask_length),
        num_negatives=args.num_negatives,
        cross_sample_negatives=args.cross_sample_negatives,
        dropout=args.dropout, attention_dropout=args.attention_dropout,
        activation_dropout=args.activation_dropout,
        dropout_input=args.dropout_input,
        dropout_features=args.dropout_features,
        feature_grad_mult=args.feature_grad_mult, dtype=dtype)


def hubert_pretrain_config(args: argparse.Namespace, num_classes):
    """``build_hubert_pretrain_config`` (options.py:869-892): the wav2vec2
    trunk with the pretraining fields."""
    return dataclasses.replace(
        wav2vec2_config(args).trunk, label_rate=args.label_rate,
        sample_rate=args.sample_rate, final_dim=args.final_dim,
        logit_temp=args.logit_temp, num_classes=tuple(num_classes),
        untie_final_proj=args.untie_final_proj,
        skip_masked=args.skip_masked, skip_nomask=args.skip_nomask,
        feature_grad_mult=args.feature_grad_mult, mask_prob=args.mask_prob,
        mask_length=int(args.mask_length), dropout_input=args.dropout_input,
        dropout_features=args.dropout_features, dropout=args.dropout,
        activation_dropout=args.activation_dropout)


def ctc_asr_config(args: argparse.Namespace, vocab_size: int):
    """``build_ctc_asr_config`` (options.py:918-935)."""
    from .ctc_asr import CtcAsrConfig
    return CtcAsrConfig(
        trunk=hubert_pretrain_config(args, ()), vocab_size=vocab_size,
        final_dropout=args.final_dropout, apply_mask=args.apply_mask,
        mask_channel_prob=args.mask_channel_prob,
        mask_channel_length=args.mask_channel_length,
        freeze_finetune_updates=args.freeze_finetune_updates,
        blank_weight=args.blank_weight, blank_mode=args.blank_mode,
        dtype=_dtype(args))


def arch_family(args: argparse.Namespace) -> str:
    """The model an arch builds: "s2st", "s2t", "t2s", "xm",
    "convtransformer", "berard", "tacotron2" or "fastspeech2" (each family
    JAX's build_model_and_loss dispatches); an arch the port does not
    build raises."""
    arch = getattr(args, "arch", "s2st_transformer")
    if arch in S2T_ARCHS:
        return "s2t"
    if arch in ARCHS:
        return ARCHS[arch][0]
    raise NotImplementedError(f"arch {arch} is not ported")


def apply_arch(args: argparse.Namespace, argv: List[str]
               ) -> argparse.Namespace:
    """An arch's defaults over the parsed flags, each flag given in
    ``argv`` kept (``_two_pass``, options.py:2293-2320)."""
    if args.arch in S2T_ARCHS:
        hubert, size = S2T_ARCHS[args.arch]
        defaults = {"use_hubert": True} if hubert else {}
        if size:
            dim, heads, ffn, drop, enc, dec = size
            defaults.update(encoder_embed_dim=dim, decoder_embed_dim=dim,
                            encoder_ffn_embed_dim=ffn,
                            decoder_ffn_embed_dim=ffn,
                            encoder_attention_heads=heads,
                            decoder_attention_heads=heads, dropout=drop)
            defaults.update({k: v for k, v in (("encoder_layers", enc),
                                               ("decoder_layers", dec))
                             if v})
    elif args.arch in SSL_ARCHS:
        defaults = dict(SSL_ARCHS[args.arch])
    else:
        defaults = dict(ARCHS.get(args.arch, ("", {}))[1])
        if getattr(args, "middle_layers_decoder", ""):
            defaults.pop("middle_layers_decoder", None)
    explicit = {a[2:].split("=")[0].replace("-", "_")
                for a in argv if a.startswith("--")}
    for key, value in defaults.items():
        if key not in explicit:
            setattr(args, key, value)
    return args


def berard_config(args: argparse.Namespace, src_vocab_size: int,
                  tgt_vocab_size: int, input_feat_per_channel: int,
                  num_speakers: int = 0):
    """Berard's config (tasks/s2s_translation.py:235-263): the layer lists
    read with ``ast.literal_eval``, the text vocabulary of --test-type."""
    from .berard import BerardConfig
    return BerardConfig(
        vocab_size=_text_vocab(args, src_vocab_size, tgt_vocab_size),
        input_feat_per_channel=input_feat_per_channel,
        input_layers=tuple(ast.literal_eval(str(getattr(
            args, "input_layers", "[256, 128]")))),
        conv_layers=tuple(tuple(t) for t in ast.literal_eval(str(getattr(
            args, "conv_layers", "[(16, 3, 2), (16, 3, 2)]")))),
        num_blstm_layers=getattr(args, "num_blstm_layers", 3),
        lstm_size=getattr(args, "lstm_size", 256),
        decoder_embed_dim=args.decoder_embed_dim,
        decoder_num_layers=getattr(args, "decoder_num_layers", 2),
        decoder_hidden_dim=getattr(args, "decoder_hidden_dim", 512),
        attention_dim=getattr(args, "attention_dim", 512),
        output_layer_dim=getattr(args, "output_layer_dim", 128),
        dropout=args.dropout, dtype=_dtype(args))


def tacotron2_config(args: argparse.Namespace, src_vocab_size: int,
                     tgt_vocab_size: int, input_feat_per_channel: int,
                     num_speakers: int = 0):
    """Tacotron2's config (tasks/s2s_translation.py:132-165): the source
    vocabulary, the flags, and the frames and speakers of the base."""
    from .tacotron2 import Tacotron2Config
    a = args
    return Tacotron2Config(
        vocab_size=src_vocab_size, encoder_dropout=a.encoder_dropout,
        encoder_embed_dim=a.encoder_embed_dim,
        encoder_conv_layers=a.encoder_conv_layers,
        encoder_conv_kernel_size=a.encoder_conv_kernel_size,
        encoder_lstm_layers=a.encoder_lstm_layers,
        attention_dim=a.attention_dim, attention_conv_dim=a.attention_conv_dim,
        attention_conv_kernel_size=a.attention_conv_kernel_size,
        prenet_dropout=a.prenet_dropout, prenet_layers=a.prenet_layers,
        prenet_dim=a.prenet_dim, postnet_dropout=a.postnet_dropout,
        postnet_layers=a.postnet_layers, postnet_conv_dim=a.postnet_conv_dim,
        postnet_conv_kernel_size=a.postnet_conv_kernel_size,
        init_attn_c=a.init_attn_c,
        attention_use_cumprob=a.attention_use_cumprob, zoneout=a.zoneout,
        decoder_lstm_layers=a.decoder_lstm_layers,
        decoder_lstm_dim=a.decoder_lstm_dim,
        output_frame_dim=a.output_frame_dim,
        n_frames_per_step=a.n_frames_per_step, num_speakers=num_speakers,
        speaker_embed_dim=a.speaker_embed_dim, dtype=_dtype(a))


def fastspeech2_config(args: argparse.Namespace, src_vocab_size: int,
                       tgt_vocab_size: int, input_feat_per_channel: int,
                       num_speakers: int = 0):
    """FastSpeech2's config (tasks/s2s_translation.py:166-203): the source
    vocabulary, the flags, the CTC head where --ctc-weight is above 0."""
    from .fastspeech2 import FS2Config
    a = args
    return FS2Config(
        vocab_size=src_vocab_size, output_frame_dim=a.output_frame_dim,
        n_frames_per_step=a.n_frames_per_step,
        encoder_layers=a.encoder_layers,
        encoder_embed_dim=a.encoder_embed_dim,
        encoder_attention_heads=a.encoder_attention_heads,
        decoder_layers=a.decoder_layers,
        decoder_embed_dim=a.decoder_embed_dim,
        decoder_attention_heads=a.decoder_attention_heads,
        fft_hidden_dim=a.fft_hidden_dim, fft_kernel_size=a.fft_kernel_size,
        dropout=a.dropout, attention_dropout=a.attention_dropout,
        var_pred_n_bins=a.var_pred_n_bins,
        var_pred_hidden_dim=a.var_pred_hidden_dim,
        var_pred_kernel_size=a.var_pred_kernel_size,
        var_pred_dropout=a.var_pred_dropout, pitch_min=a.pitch_min,
        pitch_max=a.pitch_max, energy_min=a.energy_min,
        energy_max=a.energy_max, add_postnet=a.add_postnet,
        postnet_layers=a.postnet_layers, postnet_conv_dim=a.postnet_conv_dim,
        postnet_conv_kernel_size=a.postnet_conv_kernel_size,
        postnet_dropout=a.postnet_dropout,
        speaker_embed_dim=a.speaker_embed_dim, num_speakers=num_speakers,
        ctc=a.ctc_weight > 0.0, max_source_positions=a.max_source_positions,
        max_target_positions=a.max_target_positions, dtype=_dtype(a))


def add_model_overrides_arg(p: argparse.ArgumentParser) -> None:
    """``--model-overrides`` of the generation CLIs (options.py:601)."""
    p.add_argument("--model-overrides", default="{}",
                   help="a Python dict literal of model flags that win over "
                        "the checkpoint's echo and the command line")


def model_args_from_checkpoint(args: argparse.Namespace,
                               meta: Dict[str, Any]) -> argparse.Namespace:
    """The checkpoint's flag echo over the command line, run-time keys
    excepted, and ``--model-overrides`` (a Python dict literal, read with
    ``ast.literal_eval``) over both; the command line alone when there is
    neither (options.py:2371-2407)."""
    overrides = {}
    raw = (getattr(args, "model_overrides", None) or "").strip()
    if raw and raw != "{}":
        overrides = ast.literal_eval(raw)
        if not isinstance(overrides, dict):
            raise ValueError(f"--model-overrides is not a dict: {raw}")
    saved = meta.get("args")
    if not saved and not overrides:
        return args
    merged = dict(vars(args))
    merged.update({k: v for k, v in (saved or {}).items()
                   if k not in GEN_CLI_KEYS})
    merged.update(overrides)
    return argparse.Namespace(**merged)


def _ints(s) -> tuple:
    return tuple(int(x) for x in str(s).split(",") if x != "")


def add_speaker_args(p: argparse.ArgumentParser) -> None:
    """``--speaker-to-id`` (options.py:78); ``--speaker-embed-dim`` is a
    model flag."""
    p.add_argument("--speaker-to-id", default=None,
                   help='a JSON dict, e.g. \'{"fisher_spanish": 0}\'')


def speaker_to_id(args: argparse.Namespace) -> Optional[Dict[str, int]]:
    """The ``--speaker-to-id`` map, or None (tasks/s2s_translation.py:42)."""
    raw = getattr(args, "speaker_to_id", None)
    return json.loads(raw) if raw else None


def num_speakers(args: argparse.Namespace) -> int:
    """max id + 1 of ``--speaker-to-id``, 0 without one (:100-101)."""
    ids = speaker_to_id(args)
    return max(ids.values()) + 1 if ids else 0


def build_model_config(args: argparse.Namespace, variables: Dict[str, Any],
                       input_feat_per_channel: int,
                       speakers: Optional[int] = None):
    """The config of a checkpoint's model: vocabularies from its array
    shapes, the rest from ``args``; the speaker count is ``speakers``
    where given, else the checkpoint's. A T2S checkpoint (its echo's arch)
    gives a ``T2SConfig``, a Berard, Tacotron2 or FastSpeech2 one its
    family's config, others an ``S2STConfig``."""
    params = variables["params"]

    def rows(*path, axis=0, default=0):
        node = params
        for p in path:
            if p not in node:
                return default
            node = node[p]
        return int(node.shape[axis])

    src_vocab = rows("aux_asr_decoder", "embed", "w") \
        or rows("encoder", "embed_tokens", "w") \
        or rows("embed", "w") \
        or rows("decoder", "ctc_proj", "w", axis=1, default=100)
    tgt_vocab = rows("aux_st_decoder", "embed", "w") \
        or rows("decoder", "ctc_proj_tgt", "w", axis=1, default=100)
    family = arch_family(args)
    if family == "berard":      # one text vocabulary, the decoder's
        src_vocab = tgt_vocab = rows("decoder", "embed", "w")
    if speakers is None:
        speakers = rows("encoder", "embed_speaker", "w") \
            or rows("embed_speaker", "w")
    build = {"t2s": t2s_config, "berard": berard_config,
             "tacotron2": tacotron2_config,
             "fastspeech2": fastspeech2_config}.get(family, model_config)
    return build(args, src_vocab, tgt_vocab, input_feat_per_channel,
                 num_speakers=speakers)


def _base_config(args: argparse.Namespace, *sizes, **kw) -> S2STConfig:
    """``model_config`` of the flags as the S2ST arch reads them: the base
    config of the other families (JAX's ``task.build_model_config``)."""
    return model_config(argparse.Namespace(**{**vars(args),
                                              "arch": "s2st_transformer"}),
                        *sizes, **kw)


def _text_vocab(args, src_vocab_size: int, tgt_vocab_size: int) -> int:
    """A text decoder's vocabulary: the source dictionary's for
    ``--test-type asr``, the target's for ``st``."""
    return src_vocab_size if getattr(args, "test_type", "st") == "asr" \
        else tgt_vocab_size


def t2s_config(args: argparse.Namespace, src_vocab_size: int,
               tgt_vocab_size: int, input_feat_per_channel: int,
               num_speakers: int = 0):
    """The T2S model's config (tasks/s2s_translation.py:123-131)."""
    from .t2s_transformer import T2SConfig
    return T2SConfig(
        base=_base_config(args, src_vocab_size, tgt_vocab_size,
                          input_feat_per_channel, num_speakers),
        encoder_conv_layers=args.encoder_conv_layers,
        encoder_conv_kernel_size=args.encoder_conv_kernel_size,
        encoder_dropout=args.encoder_dropout,
        encoder_transformer_layers=args.encoder_transformer_layers)


def xm_config(args: argparse.Namespace, src_vocab_size: int,
              tgt_vocab_size: int, input_feat_per_channel: int,
              num_speakers: int = 0):
    """The xm_transformer's config (tasks/s2s_translation.py:204-234): the
    trunk of the four HuBERT width flags in the compute dtype, the
    adaptor's defaults (JAX has no flags for them), the decoder of the
    flags with at most 1024 positions."""
    from .hubert import HubertConfig
    from .xm_transformer import XMConfig
    dtype = _dtype(args)
    return XMConfig(
        trunk=HubertConfig(encoder_embed_dim=args.hubert_hidden,
                           encoder_layers=args.hubert_layers,
                           encoder_ffn_embed_dim=args.hubert_ffn,
                           encoder_attention_heads=args.hubert_heads,
                           dtype=dtype),
        vocab_size=_text_vocab(args, src_vocab_size, tgt_vocab_size),
        decoder_layers=args.decoder_layers,
        decoder_embed_dim=args.decoder_embed_dim,
        decoder_ffn_embed_dim=args.decoder_ffn_embed_dim,
        decoder_attention_heads=args.decoder_attention_heads,
        adaptor_n_layers=getattr(args, "adaptor_n_layers", 3),
        adaptor_kernel_size=getattr(args, "adaptor_kernel_size", 3),
        adaptor_stride=getattr(args, "adaptor_stride", 2),
        adaptor_layernorm=getattr(args, "adaptor_layernorm", False),
        dropout=args.dropout, attention_dropout=args.attention_dropout,
        activation_dropout=args.activation_dropout,
        max_target_positions=min(args.max_target_positions, 1024),
        dtype=dtype)


def convtransformer_config(args: argparse.Namespace, src_vocab_size: int,
                           tgt_vocab_size: int, input_feat_per_channel: int,
                           num_speakers: int = 0):
    """The ConvTransformer's config (tasks/s2s_translation.py:264-277)."""
    from .convtransformer import ConvTransformerConfig
    return ConvTransformerConfig(
        base=_base_config(args, src_vocab_size, tgt_vocab_size,
                          input_feat_per_channel, num_speakers),
        conv_out_channels=getattr(args, "conv_out_channels", 256),
        decoder_layers=args.decoder_layers,
        decoder_embed_dim=args.decoder_embed_dim,
        vocab_size=_text_vocab(args, src_vocab_size, tgt_vocab_size))


def s2t_config(args: argparse.Namespace, src_vocab_size: int,
               tgt_vocab_size: int, input_feat_per_channel: int,
               num_speakers: int = 0):
    """The S2T model's config (tasks/s2s_translation.py:278-290): the base
    config of the flags, the decoder's depth and width, and the source
    vocabulary for ``--test-type asr``, the target's for ``st``."""
    from .s2t_transformer import S2TConfig
    base = _base_config(args, src_vocab_size, tgt_vocab_size,
                        input_feat_per_channel, num_speakers)
    return S2TConfig(base=base, decoder_layers=args.decoder_layers,
                     decoder_embed_dim=args.decoder_embed_dim,
                     vocab_size=_text_vocab(args, src_vocab_size,
                                            tgt_vocab_size))


def model_config(args: argparse.Namespace, src_vocab_size: int,
                 tgt_vocab_size: int, input_feat_per_channel: int,
                 num_speakers: int = 0) -> S2STConfig:
    """The S2ST model's config of the flags (``build_model_config``,
    options.py:2445-2509); an arch that builds another model raises."""
    if arch_family(args) != "s2st":
        raise NotImplementedError(f"arch {args.arch} is not ported")
    return S2STConfig(
        src_vocab_size=src_vocab_size,
        tgt_vocab_size=tgt_vocab_size,
        input_feat_per_channel=input_feat_per_channel,
        conv_kernel_sizes=_ints(args.conv_kernel_sizes),
        conv_channels=args.conv_channels,
        encoder_layers=args.encoder_layers,
        encoder_embed_dim=args.encoder_embed_dim,
        encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
        encoder_attention_heads=args.encoder_attention_heads,
        encoder_normalize_before=True,
        middle_layers=_ints(args.middle_layers),
        decoder_layers=args.decoder_layers,
        decoder_embed_dim=args.decoder_embed_dim,
        decoder_ffn_embed_dim=args.decoder_ffn_embed_dim,
        decoder_attention_heads=args.decoder_attention_heads,
        decoder_normalize_before=True,
        output_frame_dim=args.output_frame_dim,
        n_frames_per_step=args.n_frames_per_step,
        prenet_layers=args.prenet_layers,
        prenet_dim=args.prenet_dim,
        prenet_dropout=args.prenet_dropout,
        postnet_layers=args.postnet_layers,
        postnet_conv_dim=args.postnet_conv_dim,
        postnet_conv_kernel_size=args.postnet_conv_kernel_size,
        postnet_dropout=args.postnet_dropout,
        ctc=args.ctc_weight > 0.0,
        aux_asr=args.asr_ce_weight > 0.0,
        aux_st=args.st_ce_weight > 0.0,
        ctc_tgt=getattr(args, "ctc_weight_tgt", 0.0) > 0.0,
        middle_layers_decoder=_ints(getattr(args, "middle_layers_decoder",
                                            "")),
        asr_decoder_layers=args.asr_decoder_layers,
        asr_decoder_embed_dim=args.asr_decoder_embed_dim,
        st_decoder_layers=args.st_decoder_layers,
        st_decoder_embed_dim=args.st_decoder_embed_dim,
        num_speakers=num_speakers,
        speaker_embed_dim=args.speaker_embed_dim,
        speaker_embed_dim_dec=args.speaker_embed_dim,
        dropout=args.dropout,
        attention_dropout=args.attention_dropout,
        activation_dropout=args.activation_dropout,
        encoder_layerdrop=getattr(args, "encoder_layerdrop", 0.0),
        activation_fn=args.activation_fn,
        no_scale_embedding=args.no_scale_embedding,
        max_source_positions=args.max_source_positions,
        max_target_positions=args.max_target_positions,
        use_hubert=bool(getattr(args, "use_hubert", False)),
        hubert_hidden=getattr(args, "hubert_hidden", 768),
        hubert_layers=getattr(args, "hubert_layers", 12),
        hubert_ffn=getattr(args, "hubert_ffn", 3072),
        hubert_heads=getattr(args, "hubert_heads", 12),
        dtype=_dtype(args),
    )


def _dtype(args: argparse.Namespace) -> torch.dtype:
    """The compute dtype: bf16 under ``--fp16`` or ``--bf16``."""
    return torch.bfloat16 if (args.fp16 or args.bf16) else torch.float32
