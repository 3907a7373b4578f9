"""s2st_tpu_torch's aux-decoder text generation (stages 10-11) against
s2st_tpu's, on the CPU.

The ``tiny_cfg`` model (1-layer 16-d aux ASR and ST decoders over encoder
taps 0 and 1, CTC on) with dropout off, from one JAX init carried across by
the port's JAX bridge, fp32:

- ``_aux_step``: four steps' log-probs of both decoders;
- ``beam_search_aux`` for both decoders at beam 1 and 5, with and without
  ``--no-repeat-ngram-size``, with the EOS column of the output projection
  raised so that hypotheses finish at different steps: tokens and lengths
  equal, scores and per-position scores within 1e-5;
- ``score_sequences`` (SequenceScorer) within 1e-5 and
  ``ctc_argmax_decode`` equal;
- bf16 in both packages on the same weights: the encoder taps of a 10-layer
  encoder tapped at 4 and 9, and one ``_aux_step``'s log-probs. JAX rounds
  its Python-float scales to bf16 (sqrt(16) and 8**-0.5 are exact; the
  encoder's sqrt(16) too), so what differs is the order of bf16 sums and
  their roundings: the taps within 3e-2 of their scale, the log-probs
  within 3e-2 relative;
- the scorers: WER (with each option), the 13a tokenizer and the BLEU line
  against JAX's, which uses the installed sacrebleu;
- end to end: one tiny corpus, one checkpoint with the flag echo, and the
  JAX and port ``generate_for_s2st`` CLIs under ``--scoring wer
  --wer-lowercase --wer-remove-punct``, ``--scoring sacrebleu`` and
  ``--score-reference``: every printed line identical.

Tolerances: fp32 on both sides, so only the order of sums differs (1e-5).
"""

import contextlib
import io
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.generate import sequence_generator as jsg
from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.nn.attention import cross_attn_precompute as j_cross
from s2st_tpu.nn.attention import self_attn_cache_init as j_cache
from s2st_tpu.nn.transformer import sinusoidal_table as j_table
from s2st_tpu_torch.generate import sequence_generator as psg
from s2st_tpu_torch.nn.attention import cross_attn_precompute, \
    self_attn_cache_init
from s2st_tpu_torch.nn.transformer import fuse_decoder_layer_params
from tests._torch_port import port_model, t

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  prenet_dropout=0.0, postnet_dropout=0.0)
TOL = dict(atol=1e-5, rtol=0)
DECODERS = {"aux_asr_decoder": 0, "aux_st_decoder": 1}


def close(port, ref, **tol):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(ref, np.float32), **(tol or TOL))


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    return tiny_cfg.replace(**NO_DROPOUT)


@pytest.fixture(scope="module")
def variables(tiny_variables):
    """The tiny init with the EOS logit of both aux decoders raised, so
    that beams finish at different steps."""
    v = jax.tree_util.tree_map(lambda x: np.array(x, copy=True),
                               tiny_variables)
    for name in DECODERS:
        w = v["params"][name]["out_proj"]["w"]
        w[:, psg.EOS] = w[:, psg.EOS] * 8.0 + 0.5 * np.abs(w).mean()
    return jax.tree_util.tree_map(jnp.asarray, v)


@pytest.fixture(scope="module")
def encoded(cfg, variables):
    """(JAX encode, port model, port encode) of 3 utterances, one short."""
    r = np.random.RandomState(0)
    src = r.randn(3, 37, cfg.input_feat_per_channel).astype(np.float32)
    lens = np.array([37, 30, 12], np.int32)
    src[1, 30:] = 0.0
    src[2, 12:] = 0.0
    jenc = jm.encode(variables, cfg, jnp.asarray(src), jnp.asarray(lens))
    model = port_model(cfg, variables)
    with torch.no_grad():
        penc = model.encode(t(src), t(lens).long())
    return jenc, model, penc


def _jax_aux(variables, cfg, which):
    p = variables["params"][which]
    dim = cfg.asr_decoder_embed_dim if which == "aux_asr_decoder" \
        else cfg.st_decoder_embed_dim
    n_layers = cfg.asr_decoder_layers if which == "aux_asr_decoder" \
        else cfg.st_decoder_layers
    return p, dim, n_layers


@pytest.mark.parametrize("which", sorted(DECODERS))
def test_aux_step_matches_jax(cfg, variables, encoded, which):
    jenc, model, penc = encoded
    tap_i = DECODERS[which]
    jtap = jenc["out_middle_layers"][tap_i]
    jpad = jenc["encoder_padding_mask"]
    p, dim, n_layers = _jax_aux(variables, cfg, which)
    heads = cfg.decoder_attention_heads
    max_len = 8
    table = j_table(max_len + 9, dim, 1)
    jcaches = tuple(j_cache(3, max_len, heads, dim // heads, jnp.float32)
                    for _ in range(n_layers))
    jcross = tuple(j_cross(p[f"layer{i}"]["cross_attn"], jtap, heads)
                   for i in range(n_layers))
    dec = getattr(model, which)
    ptap = penc["out_middle_layers"][tap_i]
    pcaches = [self_attn_cache_init(3, max_len, heads, dim // heads,
                                    torch.float32, "cpu")
               for _ in range(n_layers)]
    pcross = [cross_attn_precompute(layer.encoder_attn, ptap)
              for layer in dec.layers]
    pfused = [fuse_decoder_layer_params(layer) for layer in dec.layers]
    close(ptap, jtap)
    tokens = np.array([[2, 5, 7, 9], [2, 4, 4, 3], [2, 8, 6, 5]], np.int32)
    for step in range(tokens.shape[1]):
        tok = tokens[:, step:step + 1]
        jlp, jcaches = jsg._aux_step(p, cfg, dim, n_layers, table,
                                     jnp.asarray(tok), step, jcaches, jcross,
                                     jpad)
        with torch.no_grad():
            plp = psg._aux_step(dec, pfused, t(tok).long(), step, pcaches,
                                pcross, penc["encoder_padding_mask"])
        assert plp.dtype == torch.float32
        close(plp, jlp)


@pytest.mark.parametrize("ngram", [0, 2])
@pytest.mark.parametrize("beam", [1, 5])
@pytest.mark.parametrize("which", sorted(DECODERS))
def test_beam_search_aux_matches_jax(cfg, variables, encoded, which, beam,
                                     ngram):
    jenc, model, penc = encoded
    tap_i = DECODERS[which]
    bs = dict(beam=beam, max_len=12, no_repeat_ngram_size=ngram)
    ref = jsg.beam_search_aux(variables, cfg, which,
                              jenc["out_middle_layers"][tap_i],
                              jenc["encoder_padding_mask"],
                              jsg.BeamConfig(**bs))
    got = psg.beam_search_aux(getattr(model, which),
                              penc["out_middle_layers"][tap_i],
                              penc["encoder_padding_mask"],
                              psg.BeamConfig(**bs))
    lengths = np.asarray(ref["lengths"])
    assert np.array_equal(got["lengths"].numpy(), lengths)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    close(got["scores"], ref["scores"])
    close(got["pos_scores"], ref["pos_scores"])
    # hypotheses end before the bound, and at different steps in a beam
    assert lengths.min() < 13
    assert beam == 1 or len(set(lengths.ravel().tolist())) > 1


@pytest.mark.parametrize("which", sorted(DECODERS))
def test_score_sequences_matches_jax(cfg, variables, encoded, which):
    jenc, model, penc = encoded
    tap_i = DECODERS[which]
    r = np.random.RandomState(4)
    lens = np.array([6, 3, 1], np.int32)
    toks = np.full((3, 8), 1, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n - 1] = r.randint(4, 11, n - 1)
        toks[i, n - 1] = 2
    ref = jsg.score_sequences(variables, cfg, which,
                              jenc["out_middle_layers"][tap_i],
                              jenc["encoder_padding_mask"], jnp.asarray(toks),
                              jnp.asarray(lens))
    got = psg.score_sequences(getattr(model, which),
                              penc["out_middle_layers"][tap_i],
                              penc["encoder_padding_mask"], t(toks).long(),
                              t(lens).long())
    close(got["positional_scores"], ref["positional_scores"])
    close(got["score"], ref["score"])


def test_ctc_argmax_decode_matches_jax(cfg, variables, encoded):
    jenc, model, penc = encoded
    ref = jsg.ctc_argmax_decode(variables, cfg, jenc["out_middle_layers"][0],
                                jenc["out_lengths"])
    got = psg.ctc_argmax_decode(model, penc["out_middle_layers"][0],
                                penc["out_lengths"])
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g.tolist() == r.tolist()


def test_bf16_taps_and_aux_step_match_jax(tiny_cfg):
    """The owed bf16 check across packages for this path: 10 encoder
    layers tapped at 4 and 9, then one aux step of each decoder."""
    cfg32 = tiny_cfg.replace(encoder_layers=10, middle_layers=(4, 9),
                             **NO_DROPOUT)
    variables = jm.init_s2st(jax.random.PRNGKey(3), cfg32)
    cfg = cfg32.replace(dtype=jnp.bfloat16)
    r = np.random.RandomState(1)
    src = r.randn(2, 29, cfg.input_feat_per_channel).astype(np.float32)
    lens = np.array([29, 21], np.int32)
    src[1, 21:] = 0.0
    jenc = jm.encode(variables, cfg, jnp.asarray(src, jnp.bfloat16),
                     jnp.asarray(lens))
    model = port_model(cfg32, variables, dtype=torch.bfloat16)
    with torch.no_grad():
        penc = model.encode(t(src), t(lens).long())
    valid = np.arange(jenc["out_middle_layers"][0].shape[1])[None, :] \
        < np.asarray(jenc["out_lengths"])[:, None]
    for i in range(2):
        ref = np.asarray(jenc["out_middle_layers"][i], np.float32)
        got = penc["out_middle_layers"][i].float().numpy()
        assert penc["out_middle_layers"][i].dtype == torch.bfloat16
        scale = np.abs(ref[valid]).max()
        assert np.abs(got - ref)[valid].max() <= 3e-2 * scale, i
    for which, tap_i in DECODERS.items():
        p, dim, n_layers = _jax_aux(variables, cfg, which)
        heads = cfg.decoder_attention_heads
        jtap = jenc["out_middle_layers"][tap_i]
        jcaches = tuple(j_cache(2, 4, heads, dim // heads, jnp.bfloat16)
                        for _ in range(n_layers))
        jcross = tuple(j_cross(p[f"layer{i}"]["cross_attn"], jtap, heads)
                       for i in range(n_layers))
        jlp, _ = jsg._aux_step(p, cfg, dim, n_layers, j_table(13, dim, 1),
                               jnp.asarray([[2], [2]]), 0, jcaches, jcross,
                               jenc["encoder_padding_mask"])
        dec = getattr(model, which)
        ptap = penc["out_middle_layers"][tap_i]
        pcaches = [self_attn_cache_init(2, 4, heads, dim // heads,
                                        torch.bfloat16, "cpu")
                   for _ in range(n_layers)]
        pcross = [cross_attn_precompute(layer.encoder_attn, ptap)
                  for layer in dec.layers]
        pfused = [fuse_decoder_layer_params(layer) for layer in dec.layers]
        with torch.no_grad():
            plp = psg._aux_step(dec, pfused, torch.full((2, 1), 2), 0,
                                pcaches, pcross, penc["encoder_padding_mask"])
        np.testing.assert_allclose(plp.numpy(), np.asarray(jlp), rtol=3e-2,
                                   atol=0, err_msg=which)


# --------------------------------------------------------------------------
# scorers
# --------------------------------------------------------------------------

SENTENCES = ["Hello, world! It's 3.5 o'clock.", "the cat-dog (A&amp;B) ran",
             "&quot;well&quot; 1,000 x-y?", "", "no  extra   spaces",
             "Dr. Smith's 12-3 win.", "<skipped> gone", "a b c d e f"]


def _pairs(seed):
    r = np.random.RandomState(seed)
    words = " ".join(SENTENCES).split()
    refs = [" ".join(r.choice(words, r.randint(0, 10))) for _ in range(20)]
    hyps = [" ".join(w for w in ref.split() if r.rand() < 0.8)
            + (" " + r.choice(words) if r.rand() < 0.5 else "")
            for ref in refs]
    return refs + SENTENCES, hyps + SENTENCES[::-1]


@pytest.mark.parametrize("opts", [dict(), dict(lowercase=True),
                                  dict(remove_punct=True),
                                  dict(lowercase=True, remove_punct=True,
                                       tokenizer="13a")])
def test_wer_matches_jax(opts):
    from s2st_tpu.scoring import WerScorer as JWer
    from s2st_tpu_torch.scoring import WerScorer as PWer
    refs, hyps = _pairs(1)
    j, p = JWer(**opts), PWer(**opts)
    for ref, hyp in zip(refs, hyps):
        j.add_string(ref, hyp)
        p.add_string(ref, hyp)
    assert (p.distance, p.ref_length) == (j.distance, j.ref_length)
    assert p.result_string() == j.result_string()


def test_tokenizer_13a_and_bleu_line_match_sacrebleu():
    from s2st_tpu.scoring import BleuScorer as JBleu
    from s2st_tpu_torch.scoring import BleuScorer as PBleu
    from s2st_tpu_torch.scoring import Tokenizer13a
    sacrebleu = pytest.importorskip("sacrebleu")
    from sacrebleu.tokenizers.tokenizer_13a import Tokenizer13a as Ref13a
    for s in SENTENCES + _pairs(2)[0]:
        assert Tokenizer13a()(s) == Ref13a()(s), s
    for seed in range(3):
        refs, hyps = _pairs(seed)
        j, p = JBleu(), PBleu()
        for ref, hyp in zip(refs, hyps):
            j.add_string(ref, hyp)
            p.add_string(ref, hyp)
        assert p.result_string() == j.result_string() == str(
            sacrebleu.corpus_bleu(hyps, [refs], tokenize="13a"))
        assert p.score() == j.score()
    # no n-gram matched, and a corpus of one empty hypothesis
    for hyps, refs in ((["x y"], ["a b"]), ([""], ["a b"])):
        p = PBleu()
        p.add_string(refs[0], hyps[0])
        assert p.result_string() == str(sacrebleu.corpus_bleu(
            hyps, [refs], tokenize="13a"))


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

CLI_MODEL = ["--encoder-layers", "2", "--decoder-layers", "1",
             "--encoder-embed-dim", "16", "--decoder-embed-dim", "16",
             "--encoder-ffn-embed-dim", "32", "--decoder-ffn-embed-dim", "32",
             "--encoder-attention-heads", "2", "--decoder-attention-heads",
             "2", "--conv-channels", "16", "--middle-layers", "0,1",
             "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
             "--asr-decoder-embed-dim", "16", "--st-decoder-embed-dim", "16",
             "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
             "--prenet-dim", "8", "--postnet-conv-dim", "8",
             "--postnet-layers", "2", "--output-frame-dim", "8",
             "--max-source-positions", "256", "--max-target-positions",
             "256"]


@pytest.fixture(scope="module")
def cli_setup(tmp_path_factory):
    """A tiny corpus (11-symbol dictionaries, so random weights end their
    hypotheses) and a port-initialised checkpoint with the flag echo."""
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from tests.make_tiny_corpus import make_tiny_corpus
    root = tmp_path_factory.mktemp("aux_cli")
    corpus = make_tiny_corpus(root / "corpus", n_test=6)
    args = train.get_parser().parse_args([str(corpus), *CLI_MODEL])
    model = S2STTransformer(model_config(args, 11, 11, 8)).init_weights(7)
    ckpt = root / "checkpoint.npz"
    write_jax_checkpoint(str(ckpt), model, {"args": train.args_echo(args)})
    return corpus, ckpt


def _stdout(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    # the log lines (time stamps, speeds) are not the CLI's result
    return [line for line in buf.getvalue().splitlines()
            if re.match(r"^[STHDP]-|^Generate ", line)]


@pytest.mark.parametrize("mode", ["wer", "sacrebleu", "score_reference"])
def test_cli_prints_the_lines_of_jax_generate_for_s2st(cli_setup, mode,
                                                       tmp_path):
    from s2st_tpu.cli.generate_for_s2st import main as jax_main
    from s2st_tpu_torch.cli.generate_for_s2st import main as port_main
    corpus, ckpt = cli_setup
    flags = [str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
             "test", "--task", "s2s_translation", "--path", str(ckpt),
             "--max-tokens", "50000", "--beam", "5", "--nbest", "2"]
    flags += {"wer": ["--scoring", "wer", "--wer-lowercase",
                      "--wer-remove-punct"],
              "sacrebleu": ["--scoring", "sacrebleu"],
              "score_reference": ["--scoring", "sacrebleu",
                                  "--score-reference"]}[mode]
    want = _stdout(jax_main, flags)
    got = _stdout(port_main, flags + ["--device", "cpu", "--results-path",
                                      str(tmp_path)])
    assert got == want
    assert got[-1].startswith("Generate test with beam=5: " +
                              ("WER: " if mode == "wer" else "BLEU = "))
    kinds = {line[0] for line in got[:-1]}
    assert kinds == ({"S", "T", "H", "P"} if mode == "score_reference"
                     else {"S", "T", "H", "D"})
    assert sum(line.startswith("S-") for line in got) == 6
    timing = (tmp_path / "timing.json").read_text()
    assert ('"forward_ms"' if mode == "score_reference" else '"beam_ms"') \
        in timing


def test_generate_waveform_takes_the_stage7_line(cli_setup, tmp_path):
    """recipes/run_baseline.sh:164-178 word for word (tiny values), with
    --device cpu and a short decode: the _targ WAVs and features beside
    the predictions, and a plot for each where matplotlib imports."""
    import importlib.util
    import wave
    from s2st_tpu_torch.cli import generate_waveform
    corpus, ckpt = cli_setup
    out = tmp_path / "dump"
    assert generate_waveform.main([
        str(corpus), "--config-yaml", "config.yaml", "--gen-subset", "test",
        "--task", "s2s_translation", "--path", str(ckpt),
        "--max-tokens", "100000", "--spec-bwd-max-iter", "64",
        "--n-frames-per-step", "4", "--middle-layers", "0,1",
        "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
        "--ctc-weight", "0.0", "--encoder-normalize-before",
        "--decoder-normalize-before", "--fp16",
        "--asr-decoder-layers", "1", "--st-decoder-layers", "1",
        "--asr-decoder-embed-dim", "16", "--st-decoder-embed-dim", "16",
        "--prenet-dim", "8", "--dump-waveforms", "--dump-attentions",
        "--dump-features", "--dump-plots", "--dump-target",
        "--results-path", str(out), "--device", "cpu",
        "--max-iter", "12"]) == 0
    ids = [f"test_{i}" for i in range(6)]
    for uid in ids:
        tgt = np.load(corpus / "features" / f"{uid}_tgt.npy")
        np.testing.assert_allclose(np.load(out / "feat" / f"{uid}_targ.npy"),
                                   tgt, atol=1e-4, rtol=1e-5)
        with wave.open(str(out / "wav" / f"{uid}_targ.wav"), "rb") as w:
            assert (w.getsampwidth(), w.getframerate()) == (2, 16000)
            assert w.getnframes() == 64 * (len(tgt) - 1)
        assert (out / "wav" / f"{uid}_pred.wav").is_file()
        assert (out / "plots" / f"{uid}.png").is_file() == (
            importlib.util.find_spec("matplotlib") is not None)
