"""Shared helpers of the tests that hold s2st_tpu_torch against s2st_tpu:
the same tiny config on both sides and the same weights, carried across by
the port's JAX bridge. Every comparison runs fp32 on the CPU."""

import atexit
import dataclasses
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from s2st_tpu_torch.models.jax_bridge import load_jax_variables
from s2st_tpu_torch.models.s2st_transformer import S2STConfig, S2STTransformer

# The JAX package's CLIs, which these tests and the package's own call, put
# JAX's persistent compilation cache under ~/.cache/s2st_tpu, where it
# outlives the test run. Every process that imports this module (each pytest
# worker collects it) gets a cache of its own, removed at exit, so no test
# loads an executable that an earlier run compiled: the insertion
# transformer's 8-device CPU train step, loaded from that cache, stalls in
# XLA's collective rendezvous and aborts the process
# (tests/test_insertion.py::test_insertion_e2e).
JAX_CACHE_DIR = tempfile.mkdtemp(prefix="s2st_xla_cache_")
atexit.register(shutil.rmtree, JAX_CACHE_DIR, ignore_errors=True)
os.environ["S2ST_TPU_COMPILATION_CACHE_DIR"] = JAX_CACHE_DIR


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test, for a module that imports this fixture:
    the tier-1 run's six workers share the machine's cores, and PyTorch's
    default of a thread a core makes their OpenMP pools thrash (the fast
    gate: 3 s alone, over 900 s with six copies at once on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_cfg(jax_cfg, **overrides) -> S2STConfig:
    """The port's config with every field the JAX config shares, fp32."""
    names = {f.name for f in dataclasses.fields(S2STConfig)} - {"dtype"}
    vals = {n: getattr(jax_cfg, n) for n in names if hasattr(jax_cfg, n)}
    return S2STConfig(dtype=torch.float32, **vals).replace(**overrides)


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return np.asarray(tree)


def port_model(jax_cfg, variables, **overrides) -> S2STTransformer:
    """Port model on the CPU holding the JAX variables (strict load)."""
    model = S2STTransformer(port_cfg(jax_cfg, **overrides))
    load_jax_variables(model, numpy_tree(variables))
    return model.eval()


def t(x, dtype=None):
    """numpy -> torch (CPU)."""
    out = torch.from_numpy(np.array(x, order="C"))
    return out if dtype is None else out.to(dtype)


# The small LightConv of tests/test_lightconv_model.py: 2 + 2 layers, kernels
# (3, 5), vocabulary 30.
LIGHTCONV_SMALL = dict(vocab=30, dim=16, ffn=32, heads=2, kernels=(3, 5))


def lightconv_cfgs(conv_type="lightweight", glu=True, normalize_before=False,
                   tied=False, small=LIGHTCONV_SMALL):
    """(JAX LightConvConfig, port LightConvConfig) with the same fields,
    fp32, dropout off."""
    import jax.numpy as jnp
    from s2st_tpu.models import lightconv_model as jlc
    from s2st_tpu.models import transformer_text as jtt
    from s2st_tpu_torch.models import lightconv_model as plc
    from s2st_tpu_torch.models.transformer_text import TransformerTextConfig
    s = small
    base = dict(src_vocab_size=s["vocab"], tgt_vocab_size=s["vocab"],
                encoder_layers=len(s["kernels"]),
                encoder_embed_dim=s["dim"], encoder_ffn_embed_dim=s["ffn"],
                encoder_attention_heads=s["heads"],
                encoder_normalize_before=normalize_before,
                decoder_layers=len(s["kernels"]),
                decoder_embed_dim=s["dim"], decoder_ffn_embed_dim=s["ffn"],
                decoder_attention_heads=s["heads"],
                decoder_normalize_before=normalize_before,
                dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                share_decoder_input_output_embed=tied,
                max_source_positions=256, max_target_positions=256)
    rest = dict(conv_type=conv_type, encoder_kernel_sizes=s["kernels"],
                decoder_kernel_sizes=s["kernels"], encoder_conv_dim=s["dim"],
                decoder_conv_dim=s["dim"], encoder_glu=glu, decoder_glu=glu,
                weight_dropout=0.0, input_dropout=0.0, relu_dropout=0.0)
    jcfg = jlc.LightConvConfig(
        base=jtt.TransformerTextConfig(dtype=jnp.float32, **base), **rest)
    pcfg = plc.LightConvConfig(
        base=TransformerTextConfig(dtype=torch.float32, **base), **rest)
    return jcfg, pcfg


def lightconv_port_model(pcfg, variables):
    """Port LightConv on the CPU holding the JAX variables (strict load)."""
    from s2st_tpu_torch.models.lightconv_model import LightConvModel
    model = LightConvModel(pcfg)
    load_jax_variables(model, numpy_tree(variables))
    return model.eval()


# stage 1's inputs: English-side source text, Chinese-side target text (the
# recipe's g2p keeps a target row only without Latin letters)
SRC_SENTENCES = ["Mr. Smith went to St. Louis", "hello   world, how are you",
                 "Dr. Who is here", "we meet at 10 o'clock",
                 "the cat sat on the mat", "Capt. Hook and Lt. Dan"]
TGT_SENTENCES = ["我们在2019年3月5日见面", "你好，世界！", "花了12.5元",
                 "百分之50的人", "电话是13912345678", "今天天气很好"]


def write_wav_pairs(root, splits=(("train", 4), ("dev", 2), ("tst", 2)),
                    seed: int = 0, src_seconds=(0.3, 1.2),
                    tgt_seconds=(0.2, 0.9), latin_row: bool = False) -> list:
    """Seeded stage-1 inputs under root: source and target WAVs (16 kHz
    PCM16 noise, every third with a silent stretch) and a metadata TSV a
    split (id, src_wav, tgt_wav, src_text, tgt_text, speaker; two
    speakers; with ``latin_row`` one target text holds Latin letters).
    Returns the ``split:path`` specs of stage 1's --metadata."""
    from s2st_tpu_torch.data.audio_utils import write_wav
    from pathlib import Path
    root = Path(root)
    (root / "wavs").mkdir(parents=True, exist_ok=True)
    r = np.random.RandomState(seed)
    specs, k = [], 0
    for split, n in splits:
        lines = ["id\tsrc_wav\ttgt_wav\tsrc_text\ttgt_text\tspeaker"]
        for i in range(n):
            uid = f"{split}_{i:02d}"
            for side, (lo, hi) in (("src", src_seconds),
                                   ("tgt", tgt_seconds)):
                wav = r.randn(int(r.uniform(lo, hi) * 16000)) * 0.1
                if k % 3 == 0:
                    wav[len(wav) // 4:len(wav) // 2] = 0.0
                write_wav(str(root / "wavs" / f"{uid}_{side}.wav"),
                          np.clip(wav, -1, 1), 16000)
            tgt = TGT_SENTENCES[k % len(TGT_SENTENCES)]
            if latin_row and k == 1:
                tgt = tgt + " OK"
            lines.append(f"{uid}\t{uid}_src.wav\t{uid}_tgt.wav\t"
                         f"{SRC_SENTENCES[k % len(SRC_SENTENCES)]}\t{tgt}\t"
                         f"spk{k % 2}")
            k += 1
        (root / f"meta_{split}.tsv").write_text("\n".join(lines) + "\n")
        specs.append(f"{split}:{root / f'meta_{split}.tsv'}")
    return specs
