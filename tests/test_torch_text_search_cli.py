"""The port's LightConv / DynamicConv text ``generate`` under the search
options, against s2st_tpu's CLI on the CPU.

The corpus of ``test_torch_text_generate`` (binarized by JAX's preprocess
CLI) and seeded checkpoints of its small LightConv in the JAX layout:

- JAX's CLI runs twice: (a) lightweight convs, the 2-checkpoint ensemble
  ``--path a:b`` with ``--beam 4 --diverse-beam-groups 2 --prefix-size 2``
  and ``--constraints ordered``, which both CLIs parse and ignore; (b)
  dynamic convs with ``--diversity-rate 0.5``. The S-/T-/H-/D-/P- lines
  hold the same tokens, every printed score agrees to its 4 decimals
  (within one unit of the last) and the BLEU lines are equal;
- sampling, the port alone: the same ``--seed`` gives the same lines,
  another seed other lines, and ``--sampling-topk 1`` the tokens of
  ``--beam 1``.
"""

import numpy as np
import pytest

from s2st_tpu_torch.models.lightconv_args import arch_args
from tests._torch_port import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_text_generate import (GEN_FLAGS, MODEL_FLAGS, _parse,
                                            corpus)  # noqa: F401


def _checkpoint(corpus, conv_type, path, seed):
    """A seeded LightConv (the port's init, JAX's distributions) saved in
    the JAX layout with the model flags echoed, as the JAX trainer does."""
    from s2st_tpu_torch.data.dictionary import Dictionary
    from s2st_tpu_torch.models.jax_bridge import write_jax_checkpoint
    from s2st_tpu_torch.models.lightconv_args import build_lightconv_config
    from s2st_tpu_torch.models.lightconv_model import LightConvModel
    args = arch_args("lightconv",
                     MODEL_FLAGS + ["--encoder-conv-type", conv_type])
    echo = {k: v for k, v in vars(args).items() if k not in ("fp16", "bf16")}
    n_src, n_tgt = (len(Dictionary.load(str(corpus / f"dict.{lang}.txt")))
                    for lang in ("de", "en"))
    model = LightConvModel(build_lightconv_config(args, n_src, n_tgt))
    write_jax_checkpoint(str(path), model.init_weights(seed),
                         meta={"args": echo})
    return str(path)


@pytest.fixture(scope="module")
def ckpts(corpus, tmp_path_factory):  # noqa: F811
    root = tmp_path_factory.mktemp("text_search")
    return {"lightweight": [_checkpoint(corpus, "lightweight",
                                        root / f"light{s}.npz", s)
                            for s in (1, 2)],
            "dynamic": [_checkpoint(corpus, "dynamic", root / "dyn.npz", 3)]}


def _flags(corpus, path, *extra):  # noqa: F811
    flags = list(GEN_FLAGS)
    i = flags.index("--beam")
    del flags[i:i + 4]                                 # --beam 3 --nbest 2
    return [str(corpus), *flags, "--path", path, *extra]


CASES = {
    "ensemble_diverse_beam_prefix": (
        "lightweight", ["--beam", "4", "--nbest", "4",
                        "--diverse-beam-groups", "2", "--prefix-size", "2",
                        "--constraints", "ordered"]),
    "dynamic_diverse_siblings": (
        "dynamic", ["--beam", "3", "--nbest", "2", "--diversity-rate",
                    "0.5"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_prints_the_lines_of_jax(corpus, ckpts, case,  # noqa: F811
                                     tmp_path):
    from s2st_tpu.cli.generate import main as jax_generate
    from s2st_tpu_torch.cli import generate as port_generate
    conv, extra = CASES[case]
    flags = _flags(corpus, ":".join(ckpts[conv]), *extra)
    assert jax_generate(flags + ["--results-path", str(tmp_path / "j")]) == 0
    assert port_generate.main(flags + ["--results-path", str(tmp_path / "p"),
                                       "--device", "cpu"]) == 0
    jlines = (tmp_path / "j" / "generate-test.txt").read_text().splitlines()
    plines = (tmp_path / "p" / "generate-test.txt").read_text().splitlines()
    want, got = _parse(jlines), _parse(plines)
    nbest = int(extra[extra.index("--nbest") + 1])
    assert sum(key[0] == "H" for key in got) == 10 * nbest
    assert list(got) == list(want)
    for key, (scores, text) in want.items():
        assert got[key][1] == text, key
        np.testing.assert_allclose(got[key][0], scores, atol=1.01e-4,
                                   rtol=0, err_msg=str(key))
    assert plines[-1] == jlines[-1]
    if "--prefix-size" in extra:
        # every hypothesis opens with the reference's first two tokens
        for (kind, sid, _), (_, text) in got.items():
            if kind == "H":
                head = (" ".join(text.split()[:2]) + " ").replace("@@ ", "")
                assert got[("T", sid, 0)][1].startswith(head.rstrip()), \
                    (sid, text)


def _hyp_tokens(path):
    return [line.split("\t")[2] for line in path.read_text().splitlines()
            if line.startswith("H-")]


def test_sampling_is_seeded_and_topk1_is_greedy(corpus, ckpts,  # noqa: F811
                                                tmp_path):
    from s2st_tpu_torch.cli import generate as port_generate

    def run(name, *extra):
        out = tmp_path / name
        assert port_generate.main(_flags(
            corpus, ckpts["lightweight"][0], *extra,
            "--results-path", str(out), "--device", "cpu")) == 0
        return out / "generate-test.txt"
    sample = ["--beam", "3", "--nbest", "3", "--sampling",
              "--sampling-topk", "4"]
    a, b, c = (run(n, *sample, "--seed", s)
               for n, s in (("a", "1"), ("b", "1"), ("c", "2")))
    assert a.read_text() == b.read_text()
    assert a.read_text() != c.read_text()
    lines = a.read_text().splitlines()
    assert sum(line.startswith("H-") for line in lines) == 30
    assert all(float(line.split("\t")[1]) < 0 for line in lines
               if line[:2] in ("H-", "D-"))
    greedy = run("greedy", "--beam", "1", "--nbest", "1")
    topk1 = run("topk1", "--beam", "3", "--nbest", "1", "--sampling",
                "--sampling-topk", "1")
    assert _hyp_tokens(topk1) == _hyp_tokens(greedy)
