"""fairseq ``.pt`` S2ST checkpoints in the port's serving CLIs, lexical
constraints from a file, and the constraints tool, against s2st_tpu on
the CPU.

One tiny corpus and one seeded model of ``test_torch_aux_generate``'s
flags, its JAX variables written in fairseq's layout by JAX's
``to_fairseq_state_dict`` as ``{"model": state_dict, "cfg": ...}``, and a
variant whose pickled ``cfg`` is an instance of a class from a module
that is then removed (as fairseq's omegaconf configs are on a machine
without omegaconf; JAX's ``torch.load`` cannot read it, the port's
reader can):

- JAX's CLIs run twice, on the plain ``.pt``: ``generate_waveform``
  (``--dump-features``), and ``generate_for_s2st --scoring sacrebleu
  --constraints unordered`` with a constraints file that the port's
  ``constraints_tools extract`` wrote. The port's ``generate_waveform``
  features from either ``.pt`` equal JAX's (atol 1e-5 + rtol 1e-5, fp32),
  and equal its own from the ``.npz`` of the same weights; its
  ``generate_for_s2st`` lines from either ``.pt`` equal JAX's, C- lines
  included, character for character, and an ordered run from the ``.npz``
  prints the lines of the same run from the ``.pt``;
- ``constraints_tools extract`` writes JAX's bytes for the same seed, and
  ``validate`` counts as JAX's;
- the reader: ``state["model"]`` or the bare dict, ``hubert.*`` and
  ``version`` entries dropped, an aux decoder the file lacks raises.
"""

import contextlib
import io
import re
import sys

import numpy as np
import pytest
import torch

from tests._torch_port import one_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_aux_generate import CLI_MODEL

FAKE_CFG_MODULE = '''
class FairseqConfig:
    def __init__(self):
        self.model = {"_name": "s2st_transformer", "encoder_layers": 2}
        self.generation = {"beam": 5}
'''
SERVE_FLAGS = ["--config-yaml", "config.yaml", "--gen-subset", "test",
               "--task", "s2s_translation", "--max-tokens", "50000",
               *CLI_MODEL, "--prenet-dropout", "0.0"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """(corpus, the .npz, the plain .pt, the .pt with an absent-class cfg,
    the constraints file)."""
    from s2st_tpu.models.torch_import import to_fairseq_state_dict
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import model_config
    from s2st_tpu_torch.models.jax_bridge import (jax_variables,
                                                  write_jax_checkpoint)
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from s2st_tpu_torch.preprocessing import constraints_tools
    from tests.make_tiny_corpus import make_tiny_corpus
    root = tmp_path_factory.mktemp("fairseq_pt")
    corpus = make_tiny_corpus(root / "corpus", n_test=6)
    args = train.get_parser().parse_args([str(corpus), *CLI_MODEL,
                                          "--prenet-dropout", "0.0"])
    model = S2STTransformer(model_config(args, 11, 11, 8)).init_weights(9)
    npz = root / "checkpoint.npz"
    write_jax_checkpoint(str(npz), model, {"args": train.args_echo(args)})
    sd = {k: torch.from_numpy(np.array(v, copy=True))
          for k, v in to_fairseq_state_dict(jax_variables(model)).items()}
    sd["encoder.embed_positions._float_tensor"] = torch.zeros(1)
    sd["decoder.version"] = torch.tensor([3.0])
    plain = root / "plain.pt"
    torch.save({"model": sd, "cfg": {"model": {"encoder_layers": 2}},
                "optimizer_history": []}, str(plain))
    mod_dir = root / "mods"
    mod_dir.mkdir()
    (mod_dir / "fake_fairseq_cfg_mod.py").write_text(FAKE_CFG_MODULE)
    sys.path.insert(0, str(mod_dir))
    try:
        import fake_fairseq_cfg_mod
        absent = root / "absent.pt"
        torch.save({"model": sd, "cfg": fake_fairseq_cfg_mod.FairseqConfig()},
                   str(absent))
    finally:
        sys.path.remove(str(mod_dir))
        sys.modules.pop("fake_fairseq_cfg_mod", None)
    cons = root / "constraints.tsv"
    assert constraints_tools.main([
        "extract", "--audio-manifest", str(corpus / "test.tsv"), "-n", "2",
        "--max-len", "2", "--seed", "3", "-o", str(cons)]) == 0
    return corpus, npz, plain, absent, cons


def test_absent_classes_stop_torch_load_but_not_the_reader(setup):
    from s2st_tpu_torch.models import fairseq_checkpoint as fc
    _, _, plain, absent, _ = setup
    with pytest.raises(ModuleNotFoundError):
        torch.load(str(absent), weights_only=False)
    assert fc.plain(fc.read_torch_checkpoint(str(absent))["cfg"])["model"][
        "encoder_layers"] == 2
    a, b = fc.s2st_state_dict(str(absent)), fc.s2st_state_dict(str(plain))
    assert sorted(a) == sorted(b)
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_reader_takes_the_bare_dict_and_drops_hubert(setup, tmp_path):
    from s2st_tpu_torch.models import fairseq_checkpoint as fc
    corpus, _, plain, _, _ = setup
    sd = fc.s2st_state_dict(str(plain))
    bare = dict(sd, **{"hubert.mask_emb": torch.zeros(4)})
    torch.save(bare, str(tmp_path / "bare.pt"))
    assert sorted(fc.s2st_state_dict(str(tmp_path / "bare.pt"))) == \
        sorted(sd)
    # the model keeps the entries it has a place for
    from s2st_tpu_torch.cli import train
    args = train.get_parser().parse_args([str(corpus), *CLI_MODEL])
    cfg = fc.s2st_config(sd, args, 8)
    assert (cfg.src_vocab_size, cfg.tgt_vocab_size) == (11, 11)
    assert cfg.aux_asr and cfg.aux_st and not cfg.ctc
    model = fc.s2st_from_fairseq(cfg, sd)
    own = model.state_dict()
    assert all(torch.equal(own[k], sd[k]) for k in own)
    # a file without the ST decoder cannot serve stage 11
    no_st = {k: v for k, v in sd.items()
             if not k.startswith("aux_st_decoder.")}
    torch.save({"model": no_st}, str(tmp_path / "no_st.pt"))
    from s2st_tpu_torch.cli.generate_for_s2st import main
    with pytest.raises(ValueError, match="has no aux_st_decoder"):
        main([str(corpus), *SERVE_FLAGS, "--path", str(tmp_path / "no_st.pt"),
              "--device", "cpu"])


def test_constraints_tool_writes_jax_bytes(setup, tmp_path):
    from s2st_tpu.preprocessing import constraints_tools as jct
    from s2st_tpu_torch.preprocessing import constraints_tools as pct
    corpus, _, _, _, cons = setup
    for seed in ("3", "4"):
        flags = ["--audio-manifest", str(corpus / "train.tsv"), "-n", "3",
                 "--max-len", "2", "--seed", seed]
        assert jct.extract_main(flags + ["-o", str(tmp_path / "j.tsv")]) == 0
        assert pct.main(["extract", *flags,
                         "-o", str(tmp_path / "p.tsv")]) == 0
        assert (tmp_path / "p.tsv").read_bytes() == \
            (tmp_path / "j.tsv").read_bytes()
    lines = ["C-1\tw a", "H-1\t-0.5\tx w a y", "H-1\t-0.6\tz",
             "C-2\tq", "H-2\t-0.1\tr"]
    assert pct.validate_stream(lines) == jct.validate_stream(lines) == (1, 2)
    assert len(cons.read_text().splitlines()) == 6


def test_generate_waveform_serves_the_pt_as_jax(setup, tmp_path):
    from s2st_tpu.cli.generate_waveform import main as jax_main
    from s2st_tpu_torch.cli.generate_waveform import main as port_main
    corpus, npz, plain, absent, _ = setup
    flags = [str(corpus), *SERVE_FLAGS, "--max-iter", "6",
             "--spec-bwd-max-iter", "2", "--dump-features"]
    assert jax_main(flags + ["--path", str(plain), "--results-path",
                             str(tmp_path / "jax")]) == 0
    for name, path in (("plain", plain), ("absent", absent), ("npz", npz)):
        assert port_main(flags + ["--path", str(path), "--results-path",
                                  str(tmp_path / name), "--device",
                                  "cpu"]) == 0
    feats = sorted((tmp_path / "jax" / "feat").glob("*_pred.npy"))
    assert len(feats) == 6
    for f in feats:
        want = np.load(f)
        for name in ("plain", "absent", "npz"):
            got = np.load(tmp_path / name / "feat" / f.name)
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5,
                                       err_msg=f"{name} {f.name}")


def _lines(fn, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert fn(argv) == 0
    return [line for line in buf.getvalue().splitlines()
            if re.match(r"^[STHDPC]-|^Generate ", line)]


def test_generate_for_s2st_serves_the_pt_with_constraints_as_jax(setup):
    from s2st_tpu.cli.generate_for_s2st import main as jax_main
    from s2st_tpu_torch.cli.generate_for_s2st import main as port_main
    corpus, npz, plain, absent, cons = setup
    flags = [str(corpus), *SERVE_FLAGS, "--scoring", "sacrebleu", "--beam",
             "4", "--nbest", "2", "--constraints-file", str(cons)]
    unordered = ["--constraints", "unordered"]
    want = _lines(jax_main, flags + unordered + ["--path", str(plain)])
    for path in (plain, absent):
        got = _lines(port_main, flags + unordered + ["--path", str(path),
                                                     "--device", "cpu"])
        assert got == want, path.name
    assert sum(line.startswith("C-") for line in want) == sum(
        len(line.split("\t")) - 1 for line in cons.read_text().splitlines())
    # the phrases of each hypothesis that ended before the bound (200
    # steps) are in it
    for sid in {line.split("\t")[0][2:] for line in want
                if line.startswith("C-")}:
        phrases = [line.split("\t")[1] for line in want
                   if line.startswith(f"C-{sid}\t")]
        hyp = next(line.split("\t")[2] for line in want
                   if line.startswith(f"H-{sid}\t"))
        assert all(ph in hyp for ph in phrases) or len(hyp.split()) >= 200
    ordered = ["--constraints", "ordered", "--device", "cpu"]
    assert _lines(port_main, flags + ordered + ["--path", str(npz)]) == \
        _lines(port_main, flags + ordered + ["--path", str(plain)])
