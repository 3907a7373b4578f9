"""Stage 9 through the port: ``s2st_tpu_torch.cli.score`` against JAX's
``s2st_tpu.cli.score`` (with sacrebleu installed, as here) and against
``sacrebleu.corpus_bleu`` itself.

One and four references, with and without ``--ignore-case``, under
``--scoring sacrebleu`` (and ``wer`` with one reference): the printed line
must equal JAX's and sacrebleu's, character for character. The corpus
has mixed case, punctuation, an empty hypothesis, and a hypothesis whose
length lies exactly between two references' (sacrebleu takes the shorter).
JAX's refusals are kept: ``wer`` with several references, and files whose
line counts differ. Skips where sacrebleu is missing.
"""

import pytest

from s2st_tpu_torch.cli import score as port
from s2st_tpu_torch.scoring import BleuScorer, corpus_bleu

HYPS = ["The cat sat on the mat today.",
        "a quick brown Fox jumps over it",
        "hello world again",
        "",
        "one two three four five",          # 5 tokens: refs of 4 and 6
        "it's a ring-tone, isn't it?"]
REFS = [["the cat sat on a mat today .", "A quick brown fox leaps over it",
         "Hello there world", "nothing here", "one two three four",
         "It's a ringtone, isn't it?"],
        ["a cat sat on the mat", "a fast brown fox jumps over it",
         "hello world again and again", "", "one two three four five six",
         "its a ring tone isnt it"],
        ["The cat sat on the mat today", "quick brown fox",
         "hello WORLD", "empty", "two three four five six seven",
         "it is a ring-tone, is not it?"],
        ["the the the", "a quick brown fox jumps over it .",
         "Hello world again!", "x y", "ONE TWO THREE",
         "a ring tone"]]


def _files(tmp_path, n_refs):
    sys_f = tmp_path / "sys.txt"
    sys_f.write_text("\n".join(HYPS) + "\n")
    refs = []
    for i in range(n_refs):
        refs.append(tmp_path / f"en.{i}.norm.lc.rm")
        refs[-1].write_text("\n".join(REFS[i]) + "\n")
    return sys_f, refs


def _line(main, argv, capsys):
    assert main(argv) == 0
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("ignore_case", [False, True])
@pytest.mark.parametrize("scoring,n_refs", [("sacrebleu", 1), ("sacrebleu", 4),
                                            ("bleu", 1), ("bleu", 4),
                                            ("wer", 1)])
def test_score_line_equals_jax_and_sacrebleu(tmp_path, capsys, n_refs,
                                             ignore_case, scoring):
    sacrebleu = pytest.importorskip("sacrebleu")
    from s2st_tpu.cli.score import main as jax_main
    sys_f, refs = _files(tmp_path, n_refs)
    argv = ["--scoring", scoring, "--sys", str(sys_f),
            "--ref", *map(str, refs)] + (["--ignore-case"] if ignore_case
                                         else [])
    want = _line(jax_main, argv, capsys)
    assert _line(port.main, argv, capsys) == want
    if scoring != "wer":
        hyps = [h.strip() for h in HYPS]
        streams = [r[:len(HYPS)] for r in REFS[:n_refs]]
        if n_refs > 1 and ignore_case:
            hyps = [h.lower() for h in hyps]
            streams = [[r.lower() for r in s] for s in streams]
        ref = sacrebleu.corpus_bleu(
            hyps, streams, tokenize="13a",
            lowercase=ignore_case and n_refs == 1)
        assert want == str(ref)


def test_closest_reference_length_takes_the_shorter_on_a_tie():
    sacrebleu = pytest.importorskip("sacrebleu")
    hyps = ["a b c d e"]
    for streams in ([["a b c d"], ["a b c d e f"]],
                    [["a b c d e f"], ["a b c d"]]):
        got = corpus_bleu(hyps, streams)
        assert got.ref_len == 4
        assert str(got) == str(sacrebleu.corpus_bleu(hyps, streams))


@pytest.mark.parametrize("lowercase", [False, True])
def test_bleu_scorer_lowercase_equals_sacrebleu(lowercase):
    sacrebleu = pytest.importorskip("sacrebleu")
    scorer = BleuScorer(lowercase=lowercase)
    for hyp, ref in zip(HYPS, REFS[0]):
        scorer.add_string(ref, hyp)
    assert scorer.result_string() == str(sacrebleu.corpus_bleu(
        HYPS, [REFS[0]], lowercase=lowercase, tokenize="13a"))


def test_wer_refuses_several_references_and_counts_must_match(tmp_path):
    from s2st_tpu.cli.score import main as jax_main
    sys_f, refs = _files(tmp_path, 2)
    argv = ["--scoring", "wer", "--sys", str(sys_f), "--ref",
            *map(str, refs)]
    for main in (jax_main, port.main):
        with pytest.raises(SystemExit) as e:
            main(argv)
        assert e.value.code == 2
    refs[1].write_text("only one line\n")
    argv = ["--sys", str(sys_f), "--ref", *map(str, refs)]
    for main in (jax_main, port.main):
        with pytest.raises(AssertionError, match="line-count"):
            main(argv)


@pytest.mark.parametrize("tokenizer", ["intl", "char", "13a", "none"])
def test_wer_tokenizers_match_jax_through_build_scorer(tokenizer):
    """``--scoring wer --wer-tokenizer <name>`` as ``generate_for_s2st``
    and text ``generate`` build it: the WER line equals JAX's exactly
    (JAX splits on white space for every name but ``13a``)."""
    import argparse
    from s2st_tpu.scoring import build_scorer as jax_build
    from s2st_tpu_torch.scoring import build_scorer
    pairs = [("Hello, world! It's 3.5 km.", "hello world its 3.5 km"),
             ("The cat-sat (on) the mat.", "the cat sat on mat"),
             ("Ünïcödé wörds, ok?", "unicode words ok"),
             ("", "extra words")]
    for lower, punct in ((False, False), (True, True)):
        args = argparse.Namespace(scoring="wer", wer_tokenizer=tokenizer,
                                  wer_lowercase=lower,
                                  wer_remove_punct=punct)
        port, ref = build_scorer(args), jax_build(args)
        for r, h in pairs:
            port.add_string(r, h)
            ref.add_string(r, h)
        assert port.result_string() == ref.result_string()
        assert (port.distance, port.ref_length) == \
            (ref.distance, ref.ref_length)
