"""The port's generate_for_s2st (stages 10-11) under every search option,
against s2st_tpu's CLI on the CPU.

One tiny corpus (11-symbol dictionaries, so random weights end their
hypotheses) and two port-initialised checkpoints with the flag echo:

- JAX's CLI runs twice: (a) ``--beam 4 --diverse-beam-groups 2
  --prefix-size 1`` with the 2-checkpoint ensemble ``--path a:b``, the aux
  ASR decoder (``--scoring wer``); (b) ``--diversity-rate 0.5 --nbest 2``
  with ``--lenpen 0.7``, the aux ST decoder (``--scoring sacrebleu``). The
  port prints the same lines, character for character;
- sampling cannot match JAX's stream (the port draws from a
  ``torch.Generator``), so the port alone: every line well formed and the
  scores finite, the same ``--seed`` gives the same lines, another seed
  other lines, and ``--sampling-topk 1`` the tokens of ``--beam 1``.

Lexical constraints from a file are held against JAX's CLI in
``test_torch_fairseq_checkpoint.py``, on the ``.pt`` it serves.
"""

import contextlib
import io
import re

import pytest

from tests._torch_port import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_aux_generate import CLI_MODEL


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from tests.make_tiny_corpus import make_tiny_corpus
    root = tmp_path_factory.mktemp("search_cli")
    corpus = make_tiny_corpus(root / "corpus", n_test=6)
    args = train.get_parser().parse_args([str(corpus), *CLI_MODEL])
    ckpts = []
    for seed in (7, 8):
        model = S2STTransformer(model_config(args, 11, 11, 8)
                                ).init_weights(seed)
        ckpts.append(root / f"checkpoint{seed}.npz")
        write_jax_checkpoint(str(ckpts[-1]), model,
                             {"args": train.args_echo(args)})
    return corpus, ckpts


def stdout_lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return [line for line in buf.getvalue().splitlines()
            if re.match(r"^[STHDPC]-|^Generate ", line)]


def base_flags(corpus, path, scoring):
    return [str(corpus), "--config-yaml", "config.yaml", "--gen-subset",
            "test", "--task", "s2s_translation", "--path", path,
            "--max-tokens", "50000",
            *(["--scoring", "wer", "--wer-lowercase"] if scoring == "wer"
              else ["--scoring", "sacrebleu"])]


CASES = {
    "diverse_beam_prefix_ensemble": (
        "wer", True, ["--beam", "4", "--diverse-beam-groups", "2",
                      "--diverse-beam-strength", "0.8", "--prefix-size", "1",
                      "--nbest", "4"]),
    "diverse_siblings": (
        "sacrebleu", False, ["--beam", "3", "--diversity-rate", "0.5",
                             "--nbest", "2", "--lenpen", "0.7"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_prints_the_lines_of_jax(setup, case):
    from s2st_tpu.cli.generate_for_s2st import main as jax_main
    from s2st_tpu_torch.cli.generate_for_s2st import main as port_main
    corpus, ckpts = setup
    scoring, ensemble, extra = CASES[case]
    path = f"{ckpts[0]}:{ckpts[1]}" if ensemble else str(ckpts[0])
    flags = base_flags(corpus, path, scoring) + extra
    want = stdout_lines(jax_main, flags)
    got = stdout_lines(port_main, flags + ["--device", "cpu"])
    assert got == want
    hyps = [line for line in got if line.startswith("H-")]
    nbest = int(extra[extra.index("--nbest") + 1])
    assert len(hyps) == 6 * nbest
    if case.startswith("diverse_beam"):
        # the groups give different hypotheses for each sentence, each
        # starting with the reference's first word
        texts = [line.split("\t")[2] for line in hyps]
        assert len(set(texts[:4])) > 1
        refs = {line.split("\t")[0][2:]: line.split("\t")[1]
                for line in got if line.startswith("T-")}
        for line in hyps:
            sid, _, text = line.split("\t")
            assert text.split()[0] == refs[sid[2:]].split()[0], line


def test_sampling_is_seeded_and_topk1_is_greedy(setup):
    from s2st_tpu_torch.cli.generate_for_s2st import main as port_main
    corpus, ckpts = setup
    flags = base_flags(corpus, str(ckpts[0]), "sacrebleu") + [
        "--device", "cpu", "--beam", "3", "--nbest", "3"]
    runs = {seed: stdout_lines(port_main, flags + [
        "--sampling", "--sampling-topp", "0.9", "--seed", str(seed)])
        for seed in (1, 2)}
    first = stdout_lines(port_main, flags + [
        "--sampling", "--sampling-topp", "0.9", "--seed", "1"])
    assert runs[1] == first
    assert runs[2] != first
    for line in first[:-1]:
        kind, rest = line.split("\t", 1)
        if kind[0] in "HD":
            score, _ = rest.split("\t", 1)
            assert float(score) < 0.0
    assert sum(line.startswith("H-") for line in first) == 18
    assert first[-1].startswith("Generate test with beam=3: BLEU = ")

    def tokens(lines):
        return [line.split("\t")[2] for line in lines if line.startswith("H-")]
    greedy = stdout_lines(port_main, flags[:-4] + ["--beam", "1"])
    topk1 = stdout_lines(port_main, flags[:-2] + [
        "--nbest", "1", "--sampling", "--sampling-topk", "1"])
    assert tokens(topk1) == tokens(greedy)
