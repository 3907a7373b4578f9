"""s2st_tpu_torch's text generation path against s2st_tpu, fp32 on the CPU.

- The binarized corpus: the port's ``mmap`` builder and reader against
  JAX's ``MMapIndexedDataset``, both ways; ``Dictionary.string`` with and
  without BPE removal; the generation batches (order, rows, padding) of
  the port's translation task against JAX's ``get_batch_iterator``.
- Beam search against ``beam_search_aux`` on the same step functions (a
  small recurrent scorer written once in each framework): tokens and
  lengths identical, scores and per-position scores within 1e-5, with
  ``--lenpen``, ``--min-len``, per-sentence ``--max-len-a/-b``,
  ``--no-repeat-ngram-size`` and the forced-EOS finish at ``max_len``.
- BLEU against the JAX package's scorer, which prints sacrebleu's line.
- End to end: one corpus written by JAX's ``cli/preprocess.py``, one
  checkpoint written by JAX's checkpoint code for each conv type, one run of
  ``s2st_tpu.cli.generate`` and one of the port's CLI with the same flags,
  with and without ``--score-reference``. The S-/T-/H-/D-/P- lines hold the
  same tokens, and every printed score agrees to its 4 decimals (within
  one unit of the last: fp32 values that differ in the 7th digit can round
  to neighbouring 4th decimals). The BLEU lines are equal.
"""

import argparse
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.data import indexed_dataset as jid
from s2st_tpu.data.dictionary import Dictionary as JDictionary
from s2st_tpu.generate import sequence_generator as jsg
from s2st_tpu_torch.data import indexed_dataset as pid
from s2st_tpu_torch.data.dictionary import Dictionary as PDictionary
from s2st_tpu_torch.generate import sequence_generator as psg
from s2st_tpu_torch.models.lightconv_args import arch_args
from s2st_tpu_torch.scoring import BleuScorer
from s2st_tpu_torch.tasks.translation import TranslationTask

TOL = dict(atol=1e-5, rtol=1e-5)


# --------------------------------------------------------------------------
# corpus, dictionary, batches
# --------------------------------------------------------------------------

def test_indexed_dataset_matches_jax(tmp_path):
    r = np.random.RandomState(0)
    items = [r.randint(0, 9000, r.randint(1, 40)) for _ in range(25)]
    pid.write_dataset(str(tmp_path / "port"), items, vocab_size=9000)
    jb = jid.MMapIndexedDatasetBuilder(
        str(tmp_path / "jax.bin"), dtype=jid.best_fitting_int_dtype(9000))
    for it in items:
        jb.add_item(it)
    jb.finalize(str(tmp_path / "jax.idx"))
    for ext in ("bin", "idx"):
        assert (tmp_path / f"port.{ext}").read_bytes() == \
            (tmp_path / f"jax.{ext}").read_bytes()
    for reader_prefix in ("port", "jax"):
        port = pid.MMapIndexedDataset(str(tmp_path / reader_prefix))
        ref = jid.MMapIndexedDataset(str(tmp_path / reader_prefix))
        assert port.dtype == np.uint16 and len(port) == len(ref) == 25
        np.testing.assert_array_equal(port.sizes, ref.sizes)
        for i, it in enumerate(items):
            np.testing.assert_array_equal(port[i], ref[i])
            np.testing.assert_array_equal(port[i], it)
            assert port[i].dtype == np.int64


def test_dictionary_string_matches_jax(tmp_path):
    path = tmp_path / "dict.txt"
    path.write_text("".join(f"w{i}{'@@' if i % 3 == 0 else ''} {100 - i}\n"
                            for i in range(20)) + "▁a 3\n▁b 2\n")
    port, ref = PDictionary.load(str(path)), JDictionary.load(str(path))
    assert len(port) == len(ref) and port.symbols == ref.symbols
    r = np.random.RandomState(1)
    for _ in range(20):
        ids = r.randint(0, len(ref) + 3, r.randint(0, 15))
        for bpe in (None, "@@ ", "sentencepiece"):
            assert port.string(ids, bpe) == ref.string(ids, bpe)
            assert port.string(ids, bpe, escape_unk=True) == \
                ref.string(ids, bpe, escape_unk=True)


def _write_text_corpus(root, n_test=10, seed=0):
    """train/test text of 3-9 words over 12 types, a third of them BPE
    pieces ("@@"); the target is the source reversed."""
    rnd = random.Random(seed)
    for split, n in (("train", 40), ("test", n_test)):
        with open(root / f"{split}.de", "w") as fs, \
                open(root / f"{split}.en", "w") as ft:
            for _ in range(n):
                words = [f"w{rnd.randrange(12)}"
                         + ("@@" if rnd.random() < 0.3 else "")
                         for _ in range(rnd.randint(3, 9))]
                fs.write(" ".join(words) + "\n")
                ft.write(" ".join(reversed(words)) + "\n")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A corpus binarized by the JAX package's preprocess CLI."""
    from s2st_tpu.cli.preprocess import main as preprocess
    root = tmp_path_factory.mktemp("text_corpus")
    _write_text_corpus(root)
    assert preprocess(["--source-lang", "de", "--target-lang", "en",
                       "--trainpref", str(root / "train"), "--testpref",
                       str(root / "test"), "--destdir", str(root / "bin"),
                       "--workers", "1"]) == 0
    return root / "bin"


def _task_args(data, **kw):
    a = dict(data=str(data), source_lang=None, target_lang=None,
             left_pad_source=True, left_pad_target=False, dataset_impl=None,
             required_batch_size_multiple=8)
    a.update(kw)
    return argparse.Namespace(**a)


@pytest.mark.parametrize("max_tokens,batch_size,mult",
                         [(40000, None, 8), (30, None, 1), (40000, 3, 8),
                          (60, 4, 2)])
def test_batches_match_jax(corpus, max_tokens, batch_size, mult):
    from s2st_tpu.tasks.translation import TranslationTask as JTask
    jargs = _task_args(corpus, required_batch_size_multiple=mult)
    jtask = JTask.setup_task(jargs)
    jbatches = list(jtask.get_batch_iterator(
        "test", max_tokens=max_tokens, max_sentences=batch_size,
        shuffle=False).next_epoch_itr(shuffle=False))
    ptask = TranslationTask.setup_task(_task_args(corpus))
    ds = ptask.load_dataset("test")
    pbatches = [ds.collate(ix) for ix in
                ds.batches(max_tokens, batch_size, mult)]
    assert len(pbatches) == len(jbatches) >= 1
    for pb, jb in zip(pbatches, jbatches):
        n = len(jb["id"])
        np.testing.assert_array_equal(pb["id"].numpy(), jb["id"])
        ts, tt = pb["src_tokens"].shape[1], pb["target"].shape[1]
        src = np.asarray(jb["src_tokens"])[:n]
        assert (src[:, :src.shape[1] - ts] == 1).all()
        np.testing.assert_array_equal(pb["src_tokens"].numpy(),
                                      src[:, src.shape[1] - ts:])
        for key in ("target", "prev_output_tokens"):
            full = np.asarray(jb[key])[:n]
            assert (full[:, tt:] == 1).all()
            np.testing.assert_array_equal(pb[key].numpy(), full[:, :tt])


# --------------------------------------------------------------------------
# beam search
# --------------------------------------------------------------------------

V, D = 24, 8


def _scorer_tables(seed, eos_bias):
    r = np.random.RandomState(seed)
    emb = r.randn(V, D).astype(np.float32)
    out = r.randn(D, V).astype(np.float32)
    pos = (r.randn(64, V) * 0.5).astype(np.float32)
    pos[:, 2] += eos_bias
    return emb, out, pos


def _jax_step(tables):
    emb, out, pos = (jnp.asarray(x) for x in tables)

    def step(tokens_t, t, cache):
        h = jnp.tanh(cache["h"] + emb[tokens_t[:, 0]])
        return jax.nn.log_softmax(h @ out + pos[t], axis=-1), {"h": h}
    return step


def _port_step(tables):
    emb, out, pos = (torch.from_numpy(x) for x in tables)

    def step(tokens_t, t, cache):
        h = torch.tanh(cache["h"] + emb[tokens_t[:, 0]])
        return torch.log_softmax(h @ out + pos[t], dim=-1), {"h": h}
    return step


BEAM_CASES = {
    "max_len_reached": dict(max_len=9),
    "lenpen_min_len": dict(max_len=10, len_penalty=0.6, min_len=4),
    "per_sentence_max_len": dict(max_len=14, max_len_a=1.0, max_len_b=2.0),
    "no_repeat_ngram": dict(max_len=12, no_repeat_ngram_size=2),
    "eos_heavy": dict(max_len=12, len_penalty=1.3, no_repeat_ngram_size=3,
                      eos_bias=2.5),
}


@pytest.mark.parametrize("case", list(BEAM_CASES))
def test_beam_search_matches_jax(case):
    kw = dict(BEAM_CASES[case])
    tables = _scorer_tables(seed=len(case), eos_bias=kw.pop("eos_bias", 1.0))
    b, k = 3, 4
    src_lens = np.asarray([3, 6, 9], np.int32)
    jcfg = jsg.BeamConfig(beam=k, **kw)
    want = jsg.beam_search_aux(
        [None], None, "decoder", [jnp.zeros((b, 1, 1))],
        [jnp.zeros((b, 1), bool)], jcfg, src_lengths=jnp.asarray(src_lens),
        step_fns=[_jax_step(tables)],
        init_caches=[{"h": jnp.zeros((b * k, D))}], vocab_size=V)
    got = psg.beam_search(
        _port_step(tables), {"h": torch.zeros(b * k, D)}, b, V,
        psg.BeamConfig(beam=k, **kw), torch.device("cpu"),
        src_lengths=torch.from_numpy(src_lens))
    np.testing.assert_array_equal(got["tokens"].numpy(),
                                  np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["lengths"].numpy(),
                                  np.asarray(want["lengths"]))
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), **TOL)
    np.testing.assert_allclose(got["pos_scores"].numpy(),
                               np.asarray(want["pos_scores"]), **TOL)
    assert 1 <= got["steps"] <= kw["max_len"] + 1


def test_beam_config_refuses_unported_strategies():
    with pytest.raises(NotImplementedError, match="sampling"):
        psg.BeamConfig(strategy="sampling")


def test_bleu_matches_jax_counts():
    """The port's BLEU is what JAX's scorer prints with the installed
    sacrebleu: ``corpus_bleu(hyps, [refs], tokenize="13a")``."""
    from s2st_tpu.scoring import BleuScorer as JBleuScorer
    r = np.random.RandomState(2)
    refs = [" ".join(f"w{i}" for i in r.randint(0, 6, r.randint(3, 12)))
            for _ in range(30)]
    hyps = [" ".join(w if r.rand() < 0.7 else f"w{r.randint(0, 6)}"
                     for w in ref.split()[:r.randint(2, 12)]) for ref in refs]
    scorer, ref_scorer = BleuScorer(), JBleuScorer()
    for ref, hyp in zip(refs, hyps):
        scorer.add_string(ref, hyp)
        ref_scorer.add_string(ref, hyp)
    assert scorer.result_string() == ref_scorer.result_string()
    assert scorer.score() == ref_scorer.score()
    assert 0 < scorer.score() < 100


# --------------------------------------------------------------------------
# end to end
# --------------------------------------------------------------------------

MODEL_FLAGS = ["--encoder-layers", "2", "--decoder-layers", "2",
               "--encoder-embed-dim", "32", "--decoder-embed-dim", "32",
               "--encoder-ffn-embed-dim", "64", "--decoder-ffn-embed-dim",
               "64", "--encoder-attention-heads", "4",
               "--decoder-attention-heads", "4",
               "--encoder-kernel-size-list", "3,5",
               "--decoder-kernel-size-list", "3,5",
               "--max-source-positions", "256",
               "--max-target-positions", "256"]
GEN_FLAGS = ["--task", "translation", "--gen-subset", "test", "--beam", "3",
             "--nbest", "2", "--max-len-a", "1.2", "--max-len-b", "4",
             "--min-len", "2", "--lenpen", "0.8",
             "--no-repeat-ngram-size", "3", "--remove-bpe",
             "--batch-size", "4"]


def _jax_checkpoint(corpus, conv_type, path):
    """A JAX-initialised LightConv saved by the JAX checkpoint code, with
    the model flags echoed in __meta__["args"] (as the JAX trainer does)."""
    from s2st_tpu.models import lightconv_model as jlc
    from s2st_tpu.options import build_lightconv_config
    from s2st_tpu.train import checkpoint as ckpt
    from s2st_tpu.train.optim import adam
    from s2st_tpu.train.trainer import create_train_state
    echo = {k: v for k, v in vars(arch_args(
        "lightconv", MODEL_FLAGS + ["--encoder-conv-type", conv_type])).items()
        if k not in ("fp16", "bf16")}
    jargs = argparse.Namespace(**echo, fp16=False, bf16=False,
                               no_scale_embedding=False)
    n_src, n_tgt = (len(JDictionary.load(str(corpus / f"dict.{lang}.txt")))
                    for lang in ("de", "en"))
    cfg = build_lightconv_config(jargs, n_src, n_tgt)
    variables = jlc.init_lightconv(jax.random.PRNGKey(1), cfg)
    ckpt.save_checkpoint_file(str(path), create_train_state(variables, adam()),
                              extra_meta={"args": echo})


def _parse(lines):
    """{(kind, id, index): (score or None, text)}, BLEU line left out."""
    out, seen = {}, {}
    for line in lines:
        if line.startswith("Generate "):
            continue
        head, rest = line.split("\t", 1)
        kind, sid = head.split("-", 1)
        n = seen[(kind, sid)] = seen.get((kind, sid), -1) + 1
        if kind in ("H", "D"):
            score, text = rest.split("\t", 1)
            out[(kind, sid, n)] = ([float(score)], text)
        elif kind == "P":
            out[(kind, sid, n)] = ([float(x) for x in rest.split()], "")
        else:
            out[(kind, sid, n)] = ([], rest)
    return out


@pytest.mark.parametrize("score_reference", [False, True])
@pytest.mark.parametrize("conv_type", ["lightweight", "dynamic"])
def test_cli_prints_the_lines_of_jax_generate(corpus, conv_type,
                                              score_reference, tmp_path):
    from s2st_tpu.cli.generate import main as jax_generate
    from s2st_tpu_torch.cli import generate as port_generate
    ckpt = tmp_path / "checkpoint.npz"
    _jax_checkpoint(corpus, conv_type, ckpt)
    flags = [str(corpus), *GEN_FLAGS, "--path", str(ckpt)] + \
        (["--score-reference"] if score_reference else [])
    assert jax_generate(flags + ["--results-path", str(tmp_path / "j")]) == 0
    assert port_generate.main(flags + ["--results-path", str(tmp_path / "p"),
                                       "--device", "cpu"]) == 0
    jlines = (tmp_path / "j" / "generate-test.txt").read_text().splitlines()
    plines = (tmp_path / "p" / "generate-test.txt").read_text().splitlines()
    want, got = _parse(jlines), _parse(plines)
    kinds = {key[0] for key in got}
    assert kinds == ({"S", "T", "H", "P"} if score_reference
                     else {"S", "T", "H", "D", "P"})
    assert sum(key[0] == "H" for key in got) == \
        10 * (1 if score_reference else 2)
    assert list(got) == list(want)
    for key, (scores, text) in want.items():
        assert got[key][1] == text, key
        np.testing.assert_allclose(got[key][0], scores, atol=1.01e-4,
                                   rtol=0, err_msg=str(key))
    # the BLEU line: JAX's, sacrebleu's form
    assert plines[-1].startswith("Generate test with beam=3: BLEU = ")
    assert plines[-1] == jlines[-1]
    timing = (tmp_path / "p" / "timing.json").read_text()
    assert ('"forward_ms"' if score_reference else '"beam_ms"') in timing
