"""LightConv flags, architecture presets and the model config they give.

Counterpart of the parts of ``s2st_tpu/options.py`` the text ``generate``
CLI reads for the LightConv family: the model flags with the JAX names and
defaults (:222-310, the lightconv flags :336-350), the presets
``lightconv``, ``lightconv_iwslt_de_en``, ``lightconv_wmt_en_de``,
``dynamicconv`` and the three ``_big`` ones (:1016-1031, :1205-1247,
:2086-2112), applied as ``_two_pass`` applies them (:2293-2314: the preset
sets its fields, flags given on the command line win), and
``build_lightconv_config`` (:1250-1284). The checkpoint's flag echo then
overrides both, through ``config_from_args.model_args_from_checkpoint``.
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import torch

from .lightconv_model import LightConvConfig
from .transformer_text import TransformerTextConfig


def _str2bool(v) -> bool:
    return str(v).lower() in ("true", "1", "yes", "y")


def add_lightconv_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--arch", default="lightconv")
    p.add_argument("--fp16", action="store_true", help="bfloat16 compute")
    p.add_argument("--bf16", action="store_true")
    p.add_argument("--encoder-layers", type=int, default=12)
    p.add_argument("--encoder-embed-dim", type=int, default=512)
    p.add_argument("--encoder-ffn-embed-dim", type=int, default=2048)
    p.add_argument("--encoder-attention-heads", type=int, default=4)
    p.add_argument("--encoder-normalize-before", action="store_true")
    p.add_argument("--decoder-layers", type=int, default=6)
    p.add_argument("--decoder-embed-dim", type=int, default=512)
    p.add_argument("--decoder-ffn-embed-dim", type=int, default=2048)
    p.add_argument("--decoder-attention-heads", type=int, default=4)
    p.add_argument("--decoder-normalize-before", action="store_true")
    p.add_argument("--max-source-positions", type=int, default=3000)
    p.add_argument("--max-target-positions", type=int, default=2400)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--attention-dropout", type=float, default=0.1)
    p.add_argument("--activation-dropout", type=float, default=0.01)
    p.add_argument("--activation-fn", default="relu")
    p.add_argument("--share-decoder-input-output-embed", action="store_true")
    p.add_argument("--share-all-embeddings", action="store_true")
    p.add_argument("--quant-noise-scalar", type=float, default=0.0)
    p.add_argument("--encoder-conv-dim", type=int, default=None)
    p.add_argument("--decoder-conv-dim", type=int, default=None)
    p.add_argument("--encoder-glu", type=_str2bool, default=True)
    p.add_argument("--decoder-glu", type=_str2bool, default=True)
    p.add_argument("--encoder-conv-type", default="lightweight",
                   choices=["lightweight", "dynamic"])
    p.add_argument("--decoder-conv-type", default="lightweight",
                   choices=["lightweight", "dynamic"],
                   help="accepted; the encoder's conv type sets both, as "
                        "in the JAX config")
    p.add_argument("--weight-softmax", type=_str2bool, default=True)
    p.add_argument("--weight-dropout", type=float, default=None)
    p.add_argument("--input-dropout", type=float, default=0.1)
    p.add_argument("--relu-dropout", type=float, default=0.0)
    p.add_argument("--encoder-kernel-size-list", default=None,
                   help="comma-separated per-layer kernel sizes")
    p.add_argument("--decoder-kernel-size-list", default=None)


def _transformer_text_base(a):
    """transformer base_architecture (options.py:1016-1031)."""
    a.encoder_layers, a.encoder_embed_dim = 6, 512
    a.encoder_ffn_embed_dim, a.encoder_attention_heads = 2048, 8
    a.decoder_layers, a.decoder_embed_dim = 6, 512
    a.decoder_ffn_embed_dim, a.decoder_attention_heads = 2048, 8
    a.dropout, a.attention_dropout, a.activation_dropout = 0.1, 0.0, 0.0
    a.max_source_positions = a.max_target_positions = 1024


def _lightconv_base(a):
    _transformer_text_base(a)
    a.encoder_layers = 7
    a.dropout, a.attention_dropout = 0.1, 0.0


def _lightconv_iwslt_de_en(a):
    _lightconv_base(a)
    a.encoder_layers, a.decoder_layers = 7, 6
    a.encoder_ffn_embed_dim = a.decoder_ffn_embed_dim = 1024
    a.encoder_attention_heads = a.decoder_attention_heads = 4
    a.attention_dropout = a.weight_dropout = 0.1
    a.encoder_glu = a.decoder_glu = False
    a.input_dropout = 0.0


def _dynamicconv(a):
    _lightconv_base(a)
    a.encoder_conv_type = a.decoder_conv_type = "dynamic"


def _lightconv_wmt_en_de_big(a):
    _lightconv_base(a)
    a.encoder_embed_dim = a.decoder_embed_dim = 1024
    a.encoder_ffn_embed_dim = a.decoder_ffn_embed_dim = 4096
    a.encoder_attention_heads = a.decoder_attention_heads = 16
    a.attention_dropout, a.dropout = 0.1, 0.3


def _lightconv_wmt_en_fr_big(a):
    _lightconv_wmt_en_de_big(a)
    a.dropout = 0.1


def _lightconv_wmt_zh_en_big(a):
    _lightconv_wmt_en_de_big(a)
    a.dropout = a.attention_dropout = a.weight_dropout = 0.2


ARCH_PRESETS = {
    "lightconv": _lightconv_base,
    "lightconv_iwslt_de_en": _lightconv_iwslt_de_en,
    "lightconv_wmt_en_de": _lightconv_base,
    "dynamicconv": _dynamicconv,
    "lightconv_wmt_en_de_big": _lightconv_wmt_en_de_big,
    "lightconv_wmt_en_fr_big": _lightconv_wmt_en_fr_big,
    "lightconv_wmt_zh_en_big": _lightconv_wmt_zh_en_big,
}


def _explicit_flags(argv: List[str]) -> List[str]:
    return [a[2:].split("=")[0].replace("-", "_") for a in argv
            if a.startswith("--")]


def apply_arch(args: argparse.Namespace, argv: List[str]
               ) -> argparse.Namespace:
    """Set the preset of ``args.arch``; flags given in ``argv`` win."""
    if args.arch not in ARCH_PRESETS:
        return args
    saved = dict(vars(args))
    ARCH_PRESETS[args.arch](args)
    for k in _explicit_flags(argv):
        if k in saved:
            setattr(args, k, saved[k])
    return args


def arch_args(arch: str, argv: Optional[List[str]] = None, **overrides
              ) -> argparse.Namespace:
    """The model flags of ``arch`` (defaults, preset, ``argv``, then
    ``overrides``): what a checkpoint's ``__meta__["args"]`` echoes."""
    p = argparse.ArgumentParser(add_help=False)
    add_lightconv_model_args(p)
    argv = ["--arch", arch] + list(argv or [])
    args = apply_arch(p.parse_args(argv), argv)
    for k, v in overrides.items():
        setattr(args, k, v)
    return args


def _kernel_sizes(spec, default, n: int):
    ks = default if spec is None else \
        tuple(int(x) for x in str(spec).split(","))
    if ks is None:
        raise ValueError(f"{n} layers need a kernel size list")
    if len(ks) == 1:
        ks = ks * n
    if len(ks) != n:
        raise ValueError("kernel_size_list doesn't match layers")
    return tuple(ks)


def build_lightconv_config(args: argparse.Namespace, src_vocab: int,
                           tgt_vocab: int) -> LightConvConfig:
    """args -> LightConvConfig (options.py:1250-1284)."""
    if args.arch not in ARCH_PRESETS:
        raise NotImplementedError(f"arch {args.arch!r} is not ported; the "
                                  f"text generate CLI takes "
                                  f"{sorted(ARCH_PRESETS)}")
    if float(getattr(args, "quant_noise_scalar", 0.0) or 0.0) > 0:
        raise NotImplementedError("int8 scalar-quantized decoding "
                                  "(--quant-noise-scalar) is not ported")
    base = TransformerTextConfig(
        src_vocab_size=src_vocab, tgt_vocab_size=tgt_vocab,
        encoder_layers=args.encoder_layers,
        encoder_embed_dim=args.encoder_embed_dim,
        encoder_ffn_embed_dim=args.encoder_ffn_embed_dim,
        encoder_attention_heads=args.encoder_attention_heads,
        encoder_normalize_before=args.encoder_normalize_before,
        decoder_layers=args.decoder_layers,
        decoder_embed_dim=args.decoder_embed_dim,
        decoder_ffn_embed_dim=args.decoder_ffn_embed_dim,
        decoder_attention_heads=args.decoder_attention_heads,
        decoder_normalize_before=args.decoder_normalize_before,
        dropout=args.dropout, attention_dropout=args.attention_dropout,
        activation_dropout=args.activation_dropout,
        activation_fn=args.activation_fn,
        share_decoder_input_output_embed=getattr(
            args, "share_decoder_input_output_embed", False),
        share_all_embeddings=getattr(args, "share_all_embeddings", False),
        max_source_positions=args.max_source_positions,
        max_target_positions=args.max_target_positions,
        dtype=torch.bfloat16 if (args.fp16 or args.bf16) else torch.float32)
    el, dl = args.encoder_layers, args.decoder_layers
    wd = args.weight_dropout
    return LightConvConfig(
        base=base,
        conv_type=getattr(args, "encoder_conv_type", "lightweight"),
        encoder_kernel_sizes=_kernel_sizes(
            args.encoder_kernel_size_list,
            (3, 7, 15, 31, 31, 31, 31)[:el] if el <= 7 else None, el),
        decoder_kernel_sizes=_kernel_sizes(
            args.decoder_kernel_size_list,
            (3, 7, 15, 31, 31, 31)[:dl] if dl <= 6 else None, dl),
        encoder_conv_dim=args.encoder_conv_dim or args.encoder_embed_dim,
        decoder_conv_dim=args.decoder_conv_dim or args.decoder_embed_dim,
        encoder_glu=args.encoder_glu, decoder_glu=args.decoder_glu,
        weight_softmax=args.weight_softmax,
        weight_dropout=wd if wd is not None else args.attention_dropout,
        input_dropout=args.input_dropout, relu_dropout=args.relu_dropout)
