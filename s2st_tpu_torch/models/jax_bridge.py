"""Weights across the two packages.

The JAX package keeps a model as a ``{"params", "stats"}`` tree of arrays
and checkpoints it as one ``.npz`` whose keys join the tree path with
``::`` (``params::encoder::layer0::self_attn::q::w``), with a ``__meta__``
member of JSON bytes (``s2st_tpu/train/checkpoint.py:30, :102-122,
:164-179``). This module is the port's own copy of that layout and of the
export map ``s2st_tpu/models/torch_import.py::to_fairseq_state_dict``
(:566-673): one table, built from the port model's modules, maps each
``state_dict`` entry to its JAX leaf and serves both directions.

The LightConv family (``models/lightconv_model.py``, fairseq's
``LightConv*Layer`` names; the JAX package has no fairseq importer for it)
maps as:

  encoder.embed_tokens.weight          params::encoder::embed::w
  {enc,dec}.layers.i.linear1/linear2/fc1/fc2   ::layeri::<same>::{w (T), b}
  {enc,dec}.layers.i.conv.weight (H,1,K)       ::layeri::conv_weight (H,K)
  {enc,dec}.layers.i.conv.weight_linear.weight ::layeri::weight_linear::w (T)
  encoder.layers.i.layer_norms.0 / .1          ::layeri::conv_ln / final_ln
  decoder.layers.i.conv_layer_norm             ::layeri::conv_ln
  decoder.layers.i.encoder_attn.{q,k,v,out}_proj  ::layeri::cross_attn::{q,k,v,out}
  decoder.layers.i.encoder_attn_layer_norm     ::layeri::cross_attn_ln
  decoder.layers.i.final_layer_norm            ::layeri::final_ln
  {encoder,decoder}.layer_norm                 ::final_ln
  decoder.embed_tokens.weight                  params::decoder::embed::w
  decoder.embed_out (V, D)                     params::decoder::out_proj::w (D, V)

The HuBERT frontend (``models/hubert.py``, fairseq ``HubertModel`` names
under ``encoder.hubert``) maps to JAX's top-level ``params::hubert``
subtree:

  feature_extractor.conv_layers.i.0 (Cout, Cin, K)  hubert::extractor::convi::w (K, Cin, Cout)
  feature_extractor.conv_layers.0.2 (GroupNorm)     hubert::extractor::gn0
  layer_norm / post_extract_proj                    hubert::feat_ln / post_proj
  encoder.pos_conv.0 (768, 48, 128)                 hubert::pos_conv (128, 48, 768)
  encoder.layer_norm                                hubert::enc_ln
  encoder.layers.i (fairseq layer names)            hubert::layeri::<as above>
  mask_emb / final_proj / label_embs_concat         hubert::mask_emb / final_proj / label_embs

with (T) a transposed (out, in) weight and layer and group norms'
weight/bias as scale/bias. The xm_transformer's trunk
(``encoder.w2v_model``) maps the same way to JAX's ``params::w2v``, its
adaptor (``encoder.adaptor.layers.i`` / ``layernorms.i``) to
``params::adaptor::conv<i>`` / ``ln<i>``; the T2S text encoder's
``encoder.prenet.i.0`` / ``.1`` (conv, BatchNorm) to ``encoder::conv<i>`` /
``bn<i>``, whose running statistics live under ``stats::encoder``,
``encoder.embed_tokens`` to ``encoder::embed_tokens`` (the model's
``jax_rules``) and ``encoder.spk_emb_proj`` to ``encoder::spk_proj``; the
ConvTransformer's ``encoder.conv.0`` / ``.2`` (Conv2d, (out, in, KH, KW)
<-> (KH, KW, in, out)) to ``encoder::conv1`` / ``conv2``; and a
``layernorm_embedding`` to ``embed_ln``.

- ``state_dict_from_jax`` / ``load_jax_variables``: JAX tree (numpy) ->
  port ``state_dict``, loaded with ``strict=True``.
- ``read_jax_checkpoint``: ``.npz`` -> (tree, meta).
- ``jax_variables`` / ``write_jax_checkpoint``: port model -> JAX tree,
  or ``.npz`` in the JAX layout.
"""

from __future__ import annotations

import json
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

SEP = "::"


def trunk_jax_rules(tree: str = "", module: str = "") -> list:
    """The rules of a HuBERT trunk: fairseq ``HubertModel`` names under the
    torch module ``module`` (the model's root when empty) -> JAX's subtree
    ``tree`` (the top level when empty); a module's other leaves
    (``mask_emb``, ``final_proj``) go under ``tree`` too."""
    m = re.escape(module) + r"\." if module else ""
    t = tree + "::" if tree else ""
    rules = [
        (rf"^{m}feature_extractor\.conv_layers\.0\.2$", rf"{t}extractor::gn0"),
        (rf"^{m}feature_extractor\.conv_layers\.(\d+)\.0$",
         rf"{t}extractor::conv\1"),
        (rf"^{m}layer_norm$", rf"{t}feat_ln"),
        (rf"^{m}post_extract_proj$", rf"{t}post_proj"),
        (rf"^{m}encoder\.pos_conv\.0$", rf"{t}pos_conv"),
        (rf"^{m}encoder\.layer_norm$", rf"{t}enc_ln"),
        (rf"^{m}encoder\.layers\.(\d+)(\.|$)", rf"{t}layer\1\2"),
    ]
    if module:
        rules.append((rf"^{re.escape(module)}(\.|$)", rf"{tree}\1"))
    return rules


# torch module name -> JAX module path, first match wins (a model's own
# ``jax_rules`` come before these)
_MODULE_RULES = [
    # the HuBERT frontend of the S2ST and S2T models (encoder.hubert) and
    # the xm_transformer's trunk (encoder.w2v_model; JAX's params::w2v)
    *trunk_jax_rules("hubert", "encoder.hubert"),
    *trunk_jax_rules("w2v", "encoder.w2v_model"),
    # the xm_transformer's Conv1dAdaptor (JAX's params::adaptor)
    (r"^encoder\.adaptor\.layers\.(\d+)$", r"adaptor::conv\1"),
    (r"^encoder\.adaptor\.layernorms\.(\d+)$", r"adaptor::ln\1"),
    # the T2S text encoder's conv prenet (conv, BatchNorm) blocks
    (r"^encoder\.prenet\.(\d+)\.0$", r"encoder::conv\1"),
    (r"^encoder\.prenet\.(\d+)\.1$", r"encoder::bn\1"),
    (r"^encoder\.spk_emb_proj$", r"encoder::spk_proj"),
    # the ConvTransformer's two Conv2d (encoder.conv = conv, ReLU, conv,
    # ReLU)
    (r"^encoder\.conv\.0$", r"encoder::conv1"),
    (r"^encoder\.conv\.2$", r"encoder::conv2"),
    # LightConv (fairseq LightConvEncoderLayer / LightConvDecoderLayer)
    (r"^(encoder|decoder)\.layers\.(\d+)\.layer_norms\.0$", r"\1::layer\2::conv_ln"),
    (r"^(encoder|decoder)\.layers\.(\d+)\.layer_norms\.1$", r"\1::layer\2::final_ln"),
    (r"^(encoder|decoder)\.layers\.(\d+)\.conv\.weight_linear$",
     r"\1::layer\2::weight_linear"),
    (r"^(encoder|decoder)\.layers\.(\d+)\.conv$", r"\1::layer\2"),
    (r"^(encoder|decoder)\.layers\.(\d+)(\.|$)", r"\1::layer\2\3"),
    (r"^encoder\.subsample\.conv_layers\.(\d+)$", r"encoder::subsample::conv\1"),
    (r"^(encoder|decoder)\.transformer_layers\.(\d+)(\.|$)", r"\1::layer\2\3"),
    (r"^(aux_asr_decoder|aux_st_decoder)\.layers\.(\d+)(\.|$)", r"\1::layer\2\3"),
    (r"^decoder\.prenet\.0\.layers\.(\d+)\.0$", r"decoder::prenet::fc\1"),
    (r"^decoder\.prenet\.1$", r"decoder::prenet_proj"),
    (r"^decoder\.postnet\.convolutions\.(\d+)\.0$", r"decoder::postnet::conv\1"),
    (r"^decoder\.postnet\.convolutions\.(\d+)\.1$", r"decoder::postnet::bn\1"),
    (r"^(\w+)\.layer_norm$", r"\1::final_ln"),
    (r"^(\w+)\.layernorm_embedding$", r"\1::embed_ln"),
    (r"^(\w+)\.embed_tokens$", r"\1::embed"),
    (r"^(\w+)\.output_projection$", r"\1::out_proj"),
]
_LAYER_PARTS = {
    "self_attn_layer_norm": "self_attn_ln",
    "conv_layer_norm": "conv_ln",
    "encoder_attn_layer_norm": "cross_attn_ln",
    "encoder_attn": "cross_attn",
    "final_layer_norm": "final_ln",
    "q_proj": "q", "k_proj": "k", "v_proj": "v", "out_proj": "out",
}
_BN_STATS = {"running_mean": "mean", "running_var": "var",
             "num_batches_tracked": "count"}
# a ``jax_names`` leaf that is a whole key, not one under the module's path
_ABSOLUTE = ("params" + SEP, "stats" + SEP)


def _jax_module_path(name: str, rules=()) -> str:
    name = ".".join(_LAYER_PARTS.get(p, p) for p in name.split("."))
    for pat, rep in [*rules, *_MODULE_RULES]:
        if re.search(pat, name):
            name = re.sub(pat, rep, name)
            break
    return name.replace(".", SEP)


def jax_layout(model: nn.Module) -> List[Tuple[str, str, str]]:
    """(state_dict name, JAX flat key, kind) for every entry of the
    model's ``state_dict``. kind: "linear" (weight transposed), "conv"
    ((out, in, K) <-> (K, in, out)), "conv2d" ((out, in, KH, KW) <->
    (KH, KW, in, out)), "heads_k" ((H, 1, K) <-> (H, K)), "scalar" ((1,)
    <-> ()), "count" (int32 in JAX) or "same". A module may name its own
    entries' leaves in a ``jax_names`` table {entry: (leaf path, kind)}, a
    leaf path that starts with ``params::`` or ``stats::`` being the whole
    key, and a model its own module rules, tried before the shared ones,
    in ``jax_rules``."""
    table = []
    rules = getattr(model, "jax_rules", ())
    for mod_name, mod in model.named_modules():
        entries = list(mod.named_parameters(recurse=False)) + [
            (n, b) for n, b in mod.named_buffers(recurse=False)
            if n not in mod._non_persistent_buffers_set]
        if not entries:
            continue
        path = _jax_module_path(mod_name, rules)
        for pname, _ in entries:
            full = f"{mod_name}.{pname}" if mod_name else pname
            kind = "same"
            own = getattr(mod, "jax_names", {})
            if pname in own:
                leaf, kind = own[pname]
                key = leaf if leaf.startswith(_ABSOLUTE) \
                    else SEP.join(["params", path, leaf])
                table.append((full, key, kind))
                continue
            if isinstance(mod, nn.Linear):
                leaf = {"weight": "w", "bias": "b"}[pname]
                kind = "linear" if pname == "weight" else "same"
            elif isinstance(mod, (nn.Conv1d, nn.Conv2d)):
                leaf = {"weight": "w", "bias": "b"}[pname]
                kind = "same" if pname != "weight" else \
                    "conv" if isinstance(mod, nn.Conv1d) else "conv2d"
            elif isinstance(mod, nn.Embedding):
                leaf = "w"
            elif isinstance(mod, (nn.LayerNorm, nn.GroupNorm,
                                  nn.BatchNorm1d)) and \
                    pname in ("weight", "bias"):
                leaf = {"weight": "scale", "bias": "bias"}[pname]
            elif isinstance(mod, nn.BatchNorm1d):
                # running stats live in the JAX "stats" tree under the
                # module that holds the norm (decoder::postnet::bnI ->
                # stats::postnet::bnI, encoder::bnI -> stats::encoder::bnI)
                group, bn = path.split(SEP)[-2:]
                table.append((full, SEP.join(["stats", group, bn,
                                              _BN_STATS[pname]]),
                              "count" if pname == "num_batches_tracked"
                              else "same"))
                continue
            else:
                leaf = pname
            table.append((full, SEP.join(["params", path, leaf]), kind))
    return table


def _to_torch(arr: np.ndarray, kind: str) -> torch.Tensor:
    arr = np.asarray(arr)
    if kind == "linear":
        arr = arr.T
    elif kind == "conv":
        arr = np.transpose(arr, (2, 1, 0))
    elif kind == "conv2d":
        arr = np.transpose(arr, (3, 2, 0, 1))
    elif kind == "heads_k":
        arr = arr[:, None, :]
    elif kind == "scalar":
        arr = arr.reshape(1)
    return torch.from_numpy(np.array(arr, order="C"))


def _to_jax(t: torch.Tensor, kind: str) -> np.ndarray:
    arr = t.detach().to("cpu", torch.float32 if t.is_floating_point()
                        else t.dtype).numpy()
    if kind == "linear":
        arr = arr.T
    elif kind == "conv":
        arr = np.transpose(arr, (2, 1, 0))
    elif kind == "conv2d":
        arr = np.transpose(arr, (2, 3, 1, 0))
    elif kind == "heads_k":
        arr = arr[:, 0, :]
    elif kind == "scalar":
        arr = arr.reshape(())
    elif kind == "count":
        arr = arr.astype(np.int32)
    return np.array(arr, order="C")


def flatten_tree(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """Nested dicts (and lists, by index, as JAX flattens FastSpeech2's
    layer lists) -> {"a::b::c": leaf}."""
    flat = {}
    items = enumerate(tree) if isinstance(tree, (list, tuple)) \
        else tree.items()
    for k, v in items:
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, (dict, list, tuple)):
            flat.update(flatten_tree(v, key))
        else:
            flat[key] = v
    return flat


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        node = tree
        *parents, leaf = key.split(SEP)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def state_dict_from_jax(model: nn.Module, variables: Dict[str, Any]
                        ) -> Dict[str, torch.Tensor]:
    """JAX ``{"params", "stats"}`` tree of numpy arrays -> the model's
    ``state_dict``. Raises on a JAX leaf the model has no place for, a
    missing leaf, or a shape that does not agree."""
    flat = flatten_tree({"params": variables["params"],
                         "stats": variables.get("stats", {})})
    model_sd = model.state_dict()
    sd = {}
    for name, key, kind in jax_layout(model):
        if key not in flat:
            raise KeyError(f"JAX variables lack {key} (for {name})")
        t = _to_torch(flat.pop(key), kind)
        if tuple(t.shape) != tuple(model_sd[name].shape):
            raise ValueError(f"shape of {key} {tuple(t.shape)} does not fit "
                             f"{name} {tuple(model_sd[name].shape)}")
        sd[name] = t.to(model_sd[name].dtype)
    if flat:
        raise KeyError(f"JAX leaves with no place in the model: "
                       f"{sorted(flat)[:8]}")
    return sd


def load_jax_variables(model: nn.Module, variables: Dict[str, Any]
                       ) -> nn.Module:
    model.load_state_dict(state_dict_from_jax(model, variables), strict=True)
    return model


def _bf16_void_to_f32(arr: np.ndarray) -> np.ndarray:
    """np.savez writes bfloat16 (ml_dtypes) as 2-byte void; widen to fp32."""
    bits = arr.view(np.uint16).astype(np.uint32) << 16
    return bits.view(np.float32)


def read_jax_checkpoint(path: str) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """JAX ``.npz`` checkpoint -> ({"params", "stats"} tree of numpy
    arrays, meta dict). Optimizer state is not read."""
    with np.load(path, allow_pickle=False) as z:
        meta = {}
        flat = {}
        for k in z.files:
            if k == "__meta__":
                meta = json.loads(bytes(z[k].tobytes()).decode("utf-8"))
            elif k.startswith(("params" + SEP, "stats" + SEP)):
                arr = z[k]
                if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
                    arr = _bf16_void_to_f32(arr)
                flat[k] = arr
    tree = unflatten_tree(flat)
    tree.setdefault("stats", {})
    return tree, meta


def jax_variables(model: nn.Module) -> Dict[str, Any]:
    """The model's weights as the JAX ``{"params", "stats"}`` tree of
    numpy arrays (inverse of ``state_dict_from_jax``)."""
    sd = model.state_dict()
    return unflatten_tree({key: _to_jax(sd[name], kind)
                           for name, key, kind in jax_layout(model)})


def write_jax_checkpoint(path: str, model: nn.Module,
                         meta: Optional[Dict[str, Any]] = None) -> None:
    """Write the model's weights as a JAX ``.npz`` checkpoint (params and
    stats; no optimizer state, which the JAX loaders reset)."""
    flat = flatten_tree(jax_variables(model))
    meta = dict(meta or {})
    meta.setdefault("step", 0)
    flat["__meta__"] = np.frombuffer(json.dumps(meta).encode("utf-8"),
                                     dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez(f, **flat)


__all__ = ["jax_layout", "state_dict_from_jax", "load_jax_variables",
           "jax_variables", "read_jax_checkpoint", "write_jax_checkpoint",
           "flatten_tree", "unflatten_tree"]
