"""The port's wav2vec2 CTC transcriber (stage 8's ASR) against HF's, on the
CPU.

Tiny random ``Wav2Vec2ForCTC`` models are built here with ``transformers``
in both layouts it defines: ``feat_extract_norm="group"`` with post-LN
layers (the tiny model of ``tests/test_evaluate_s2s_bleu.py``, base-960h's
layout) and ``feat_extract_norm="layer"`` with ``conv_bias`` and stable
(pre-)LN (lv60-self's). Each is saved as ``model.safetensors``, as
``pytorch_model.bin``, and as a ``.bin`` whose ``pos_conv`` is spelled
``weight_g``/``weight_v`` as on the hub. The port reads every file without
HF and must give:

- HF's input values bit for bit (float32 numpy normalisation);
- HF's logits within atol 1e-4 + rtol 1e-4 (fp32 sums in another order);
- ``batch_decode``'s text exactly on the same ids, including ids that give
  ``<s>``, ``</s>``, ``<unk>``, runs of ``|`` and repeats split by blanks,
  with and without ``do_lower_case`` and ``clean_up_tokenization_spaces``;
- the refusal of a 22.05 kHz input, as HF's feature extractor refuses it.

The safetensors reader is held against ``safetensors`` itself in F32, F16
and BF16. Skips where ``transformers`` or ``safetensors`` is missing.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from s2st_tpu_torch.data.wav2vec2_processor import Wav2Vec2Processor
from s2st_tpu_torch.models import hf_checkpoint, wav2vec2_ctc
from tests._torch_port import one_thread  # noqa: F401  (autouse)

# facebook/wav2vec2-large-960h-lv60-self's vocabulary
LV60_VOCAB = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, "|": 4, "E": 5,
              "T": 6, "A": 7, "O": 8, "N": 9, "I": 10, "H": 11, "S": 12,
              "R": 13, "D": 14, "L": 15, "U": 16, "M": 17, "W": 18, "C": 19,
              "F": 20, "G": 21, "Y": 22, "P": 23, "B": 24, "V": 25, "K": 26,
              "'": 27, "X": 28, "J": 29, "Q": 30, "Z": 31}
LAYOUTS = ("group", "layer")
FORMATS = ("safetensors", "bin", "bin_weight_g")
TOL = dict(atol=1e-4, rtol=1e-4)


def make_hf_wav2vec2(root, layout: str, fmt: str = "safetensors",
                     seed: int = 0, tokenizer_kwargs=None):
    """A tiny random HF ``Wav2Vec2ForCTC`` and its processor in ``root``:
    head_dim 16, the lv60-self vocabulary."""
    transformers = pytest.importorskip("transformers")
    root.mkdir(parents=True, exist_ok=True)
    (root / "vocab.json").write_text(json.dumps(LV60_VOCAB))
    tok = transformers.Wav2Vec2CTCTokenizer(str(root / "vocab.json"),
                                            **(tokenizer_kwargs or {}))
    fe = transformers.Wav2Vec2FeatureExtractor(
        feature_size=1, sampling_rate=16000, padding_value=0.0,
        do_normalize=True, return_attention_mask=layout == "layer")
    transformers.Wav2Vec2Processor(feature_extractor=fe,
                                   tokenizer=tok).save_pretrained(str(root))
    kw = dict(vocab_size=len(LV60_VOCAB), hidden_size=32,
              num_hidden_layers=2, num_attention_heads=2,
              intermediate_size=64, conv_dim=(16,) * 7,
              num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4)
    if layout == "layer":
        kw.update(feat_extract_norm="layer", conv_bias=True,
                  do_stable_layer_norm=True, layer_norm_eps=1e-5)
    torch.manual_seed(seed)
    model = transformers.Wav2Vec2ForCTC(transformers.Wav2Vec2Config(**kw))
    with torch.no_grad():      # non-trivial norms and biases
        for name, p in model.named_parameters():
            if "layer_norm" in name or name.endswith("bias"):
                p.add_(0.1 * torch.randn_like(p))
    model.save_pretrained(str(root), safe_serialization=fmt == "safetensors")
    if fmt == "bin_weight_g":
        sd = torch.load(root / "pytorch_model.bin", weights_only=True)
        pre = "wav2vec2.encoder.pos_conv_embed.conv."
        sd[pre + "weight_g"] = sd.pop(pre + "parametrizations.weight.original0")
        sd[pre + "weight_v"] = sd.pop(pre + "parametrizations.weight.original1")
        torch.save(sd, root / "pytorch_model.bin")
    return root


@pytest.fixture(scope="module")
def hf_models(tmp_path_factory):
    root = tmp_path_factory.mktemp("w2v2")
    return {(layout, fmt): make_hf_wav2vec2(root / f"{layout}_{fmt}", layout,
                                            fmt, seed=i)
            for i, (layout, fmt) in enumerate(
                (lo, f) for lo in LAYOUTS for f in FORMATS)}


def waves():
    r = np.random.RandomState(3)
    return [(r.randn(n) * s).astype(np.float32)
            for n, s in ((16000, 0.1), (7200, 0.3), (400, 0.05))]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_logits_match_hf(hf_models, layout, fmt):
    transformers = pytest.importorskip("transformers")
    root = hf_models[layout, fmt]
    hf = transformers.Wav2Vec2ForCTC.from_pretrained(str(root)).eval()
    hp = transformers.Wav2Vec2Processor.from_pretrained(str(root))
    model, proc = wav2vec2_ctc.load(str(root))
    assert model.cfg.do_stable_layer_norm == (layout == "layer")
    for wave in waves():
        want = hp(wave, sampling_rate=16000, return_tensors="pt",
                  padding=True).input_values
        got = torch.from_numpy(proc.features(wave, 16000))[None]
        assert torch.equal(got, want)
        with torch.no_grad():
            ref = hf(want).logits
            out = model(got)
        assert out.shape == ref.shape
        assert out.shape[1] == model.cfg.output_length(len(wave))
        torch.testing.assert_close(out, ref, **TOL)
        assert torch.equal(out.argmax(-1), ref.argmax(-1))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_transcriber_matches_jax_stage8_transcriber(hf_models, layout):
    """The port's Transcriber on the CPU and JAX's build_hf_transcriber
    give the same text."""
    pytest.importorskip("transformers")
    from s2st_tpu.cli.evaluate_s2s_bleu import build_hf_transcriber
    root = str(hf_models[layout, "safetensors"])
    ref = build_hf_transcriber(root)
    port = wav2vec2_ctc.Transcriber(root, torch.device("cpu"))
    for wave in waves():
        assert port(wave, 16000) == ref(wave, 16000)


def _id_rows():
    ids = {k: v for k, v in LV60_VOCAB.items()}
    crafted = [
        [],
        [0, 0, 0],
        [ids["H"], ids["H"], 0, ids["E"], ids["L"], 0, ids["L"], ids["O"],
         ids["|"], ids["|"], ids["|"], ids["W"], 0, ids["|"], 0, ids["|"],
         ids["'"], ids["S"]],
        [ids["|"], ids["<s>"], ids["<s>"], ids["A"], ids["</s>"],
         ids["<unk>"], 0, ids["<unk>"], ids["|"]],
        [ids["<pad>"], ids["N"], ids["|"], ids["'"], ids["T"], ids["|"],
         ids["'"], ids["|"], ids["M"], ids["|"], 0],
        [40, 3, 31, 31, 4, 27],     # an id past the vocabulary
    ]
    r = np.random.RandomState(0)
    return crafted + [r.randint(0, 32, size=50).tolist() for _ in range(8)]


@pytest.mark.parametrize("kwargs", [{}, {"do_lower_case": True},
                                    {"clean_up_tokenization_spaces": True}])
def test_decode_matches_batch_decode(tmp_path, kwargs):
    transformers = pytest.importorskip("transformers")
    root = make_hf_wav2vec2(tmp_path / "m", "group",
                            tokenizer_kwargs=kwargs)
    hp = transformers.Wav2Vec2Processor.from_pretrained(str(root))
    proc = Wav2Vec2Processor(str(root))
    for row in _id_rows():
        want = hp.batch_decode([row])[0]
        assert proc.decode(row) == want, row
    if not kwargs:
        assert proc.decode(_id_rows()[3]) == "<s>A</s><unk><unk>"


def test_other_sampling_rate_is_refused(hf_models):
    transformers = pytest.importorskip("transformers")
    root = str(hf_models["group", "safetensors"])
    wave = waves()[0]
    with pytest.raises(ValueError, match="sampling rate"):
        transformers.Wav2Vec2Processor.from_pretrained(root)(
            wave, sampling_rate=22050, return_tensors="pt")
    with pytest.raises(ValueError, match="sampling rate of 16000"):
        Wav2Vec2Processor(root).features(wave, 22050)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_safetensors_reader(tmp_path, dtype):
    st = pytest.importorskip("safetensors.torch")
    g = torch.Generator().manual_seed(1)
    tensors = {"a.weight": torch.randn(3, 5, generator=g).to(dtype),
               "b": torch.randn(7, generator=g).to(dtype),
               "c.bias": torch.randn(2, 2, 2, generator=g).to(dtype)}
    path = tmp_path / "x.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = hf_checkpoint.read_safetensors(path)
    assert set(got) == set(tensors)
    for k, v in st.load_file(str(path)).items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v.float())


@pytest.mark.parametrize("extra", [{"add_adapter": True},
                                   {"adapter_attn_dim": 16},
                                   {"layer_norm_eps": 1e-6}])
def test_unported_configs_are_refused(hf_models, extra):
    cfg = hf_checkpoint.read_config(hf_models["layer", "safetensors"])
    wav2vec2_ctc.Wav2Vec2CTCConfig.from_hf(cfg)
    with pytest.raises(NotImplementedError, match="not ported"):
        wav2vec2_ctc.Wav2Vec2CTCConfig.from_hf({**cfg, **extra})


def test_port_names_cover_hf_names(hf_models):
    """Every HF name maps to one of the port's, and back to the module
    tree's state_dict, one to one (strict loading)."""
    st = pytest.importorskip("safetensors.torch")
    root = hf_models["group", "safetensors"]
    hf_sd = st.load_file(str(root / "model.safetensors"))
    port = wav2vec2_ctc.port_state_dict(hf_sd)
    cfg = wav2vec2_ctc.Wav2Vec2CTCConfig.from_hf(
        hf_checkpoint.read_config(root))
    assert set(port) == set(wav2vec2_ctc.Wav2Vec2ForCTC(cfg).state_dict())
    assert wav2vec2_ctc.port_key(
        "wav2vec2.encoder.layers.11.feed_forward.output_dense.weight") == \
        "wav2vec2.encoder.layers.11.fc2.weight"
    assert wav2vec2_ctc.port_key(
        "wav2vec2.encoder.layers.3.layer_norm.bias") == \
        "wav2vec2.encoder.layers.3.self_attn_layer_norm.bias"
    assert wav2vec2_ctc.port_key("wav2vec2.encoder.layer_norm.bias") == \
        "wav2vec2.encoder.layer_norm.bias"
    for key in hf_sd:
        assert wav2vec2_ctc.hf_key(wav2vec2_ctc.port_key(key)) == key


def test_chip_smoke_checkpoint_is_hf_layout(tmp_path):
    """chip_smoke.py's phase-17 writer (lv60-self's files and settings,
    pos_conv as weight_g/weight_v), at a tiny width: HF's from_pretrained
    reads it, and the port gives HF's logits and text on it."""
    transformers = pytest.importorskip("transformers")
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    try:
        import chip_smoke
    finally:
        sys.path.pop(0)
    tiny = dict(chip_smoke.W2V2_LARGE_CONFIG, conv_dim=[16] * 7,
                hidden_size=64, num_hidden_layers=2, num_attention_heads=1,
                intermediate_size=32, num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4)
    root = tmp_path / "lv60"
    chip_smoke.write_wav2vec2_checkpoint(root, tiny, seed=3)
    sd = torch.load(root / "pytorch_model.bin", weights_only=True)
    assert "wav2vec2.encoder.pos_conv_embed.conv.weight_g" in sd
    hf = transformers.Wav2Vec2ForCTC.from_pretrained(str(root)).eval()
    hp = transformers.Wav2Vec2Processor.from_pretrained(str(root))
    port = wav2vec2_ctc.Transcriber(str(root), torch.device("cpu"))
    assert port.model.cfg.do_stable_layer_norm and port.model.cfg.conv_bias
    for wave in waves():
        x = hp(wave, sampling_rate=16000, return_tensors="pt",
               padding=True).input_values
        with torch.no_grad():
            ref = hf(x).logits
            out = port.model(x)
        torch.testing.assert_close(out, ref, **TOL)
        assert port(wave, 16000) == hp.batch_decode(ref.argmax(-1))[0]
