"""Model flags and the model config a checkpoint implies.

Counterpart of ``s2st_tpu/options.py``: the model flags with the same names
and defaults (:222-303, :484-488, the HuBERT frontend's :70-75),
``model_args_from_checkpoint`` (:2371),
which lets the checkpoint's own flag echo (``__meta__["args"]``) override
the command line for every architectural key, and ``build_model_config``
(:2445-2509). ``model_config`` takes the vocabulary sizes from the caller
(the training CLI's dictionaries); ``build_model_config`` takes them, and
the speaker count, from a checkpoint's array shapes, so that generation
loads no dictionary.
"""

from __future__ import annotations

import argparse
from typing import Any, Dict

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
    p.add_argument("--activation-fn", default="relu")
    p.add_argument("--no-scale-embedding", action="store_true")
    p.add_argument("--ctc-weight", type=float, default=0.0)
    p.add_argument("--ctc-weight-tgt", type=float, default=0.0)
    p.add_argument("--asr-ce-weight", type=float, default=0.0)
    p.add_argument("--st-ce-weight", type=float, default=0.0)


def model_args_from_checkpoint(args: argparse.Namespace,
                               meta: Dict[str, Any]) -> argparse.Namespace:
    """The checkpoint's flag echo over the command line, run-time keys
    excepted; the command line alone when the checkpoint holds no echo."""
    saved = meta.get("args")
    if not saved:
        return args
    merged = dict(vars(args))
    merged.update({k: v for k, v in saved.items() if k not in GEN_CLI_KEYS})
    return argparse.Namespace(**merged)


def _ints(s) -> tuple:
    return tuple(int(x) for x in str(s).split(",") if x != "")


def build_model_config(args: argparse.Namespace, variables: Dict[str, Any],
                       input_feat_per_channel: int) -> S2STConfig:
    """The config of a checkpoint's model: vocabularies and speakers from
    its array shapes, the rest from ``args``."""
    params = variables["params"]

    def rows(*path, axis=0, default=0):
        node = params
        for p in path:
            if p not in node:
                return default
            node = node[p]
        return int(node.shape[axis])

    src_vocab = rows("aux_asr_decoder", "embed", "w") \
        or rows("decoder", "ctc_proj", "w", axis=1, default=100)
    tgt_vocab = rows("aux_st_decoder", "embed", "w") \
        or rows("decoder", "ctc_proj_tgt", "w", axis=1, default=100)
    return model_config(args, src_vocab, tgt_vocab, input_feat_per_channel,
                        num_speakers=rows("encoder", "embed_speaker", "w"))


def model_config(args: argparse.Namespace, src_vocab_size: int,
                 tgt_vocab_size: int, input_feat_per_channel: int,
                 num_speakers: int = 0) -> S2STConfig:
    if getattr(args, "arch", "s2st_transformer") != "s2st_transformer":
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
        dtype=torch.bfloat16 if (args.fp16 or args.bf16) else torch.float32,
    )
