"""s2st_tpu_torch's MTL variant (``--task s2s_translation_mtl --arch
s2st_transformer_mtl``: decoder taps and the target-side CTC) against
s2st_tpu's, fp32 on the CPU.

- The ``tiny_cfg`` model (encoder taps 0 and 1, aux decoders, source CTC)
  with every dropout rate at 0 and the MTL head (decoder tap 0 with
  ``ctc_proj_tgt``),
  one JAX init carried over by the bridge: the training forward's
  ``ctc_tgt_logits``, and ``s2st_loss`` with the recipe's terms and
  ``--ctc-weight 0.3 --ctc-weight-tgt 0.3``: the loss, its
  ``ctc_loss_tgt`` and every other logged term, and per-leaf gradients; a
  decoder tap past the last layer gives no logits and a zero term, in
  both.
- The arch's defaults: ``--middle-layers-decoder`` 3 unless given, as
  JAX's ``_two_pass`` leaves it.
- The train CLI: 2 updates of each package from one init (JAX's
  ``init_s2st`` patched to the port's seeded weights) under the MTL task,
  arch and criterion: the logged losses and their ``ctc_loss_tgt``.
- The fairseq reader: a state dict with ``decoder.ctc_proj_tgt`` builds
  the MTL head and gives JAX's ``from_fairseq_state_dict`` tree.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as ``tests/test_torch_train.py``
holds them; the CLI losses as JAX logs them, rounded to 4 decimals (atol
1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import s2st_transformer as jm
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import numpy_tree, one_thread, port_model  # noqa: F401
from tests.test_torch_train import (NO_DROPOUT, TINY_FLAGS, close,
                                    jax_leaves, port_batch, port_leaves,
                                    train_batch)

MTL = dict(ctc=True, ctc_tgt=True, middle_layers_decoder=(0,))
# the terms of tests/test_torch_train.py, with the target CTC
LOSS = dict(bce_pos_weight=5.0, label_smoothing=0.1, ctc_weight=0.3,
            asr_ce_weight=0.3, st_ce_weight=0.3, ctc_weight_tgt=0.3)


@pytest.fixture(scope="module")
def mtl(tiny_cfg):
    cfg = tiny_cfg.replace(**NO_DROPOUT, **MTL)
    variables = jm.init_s2st(jax.random.PRNGKey(11), cfg)
    assert "ctc_proj_tgt" in variables["params"]["decoder"]
    return cfg, variables


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.mark.parametrize("tap", [0, 5])
def test_target_ctc_matches_jax(mtl, tap):
    """The decoder tap's logits and the target CTC term: tap 0 of 2
    layers, and tap 5, past the last layer, which gives neither logits
    nor a term in either package."""
    cfg, variables = mtl
    cfg = cfg.replace(middle_layers_decoder=(tap,))
    batch = train_batch(cfg, seed=51)
    jlcfg = jl.LossConfig(**LOSS)

    def loss_fn(params):
        b = jnp_tree(batch)
        net = jm.forward({"params": params, "stats": variables["stats"]},
                         cfg, b, rng=None, deterministic=True, train=True)
        loss, ex = jl.s2st_loss({"params": params,
                                 "stats": variables["stats"]}, cfg, jlcfg,
                                b, rng=None, train=True)
        return loss, (ex["logging"], net.get("ctc_tgt_logits"))

    (j_loss, (j_log, j_logits)), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    model = port_model(cfg, variables)
    pb = port_batch(batch)
    net = model(pb, train=True)
    p_loss, p_ex = pl.s2st_loss(model, pl.LossConfig(**LOSS), pb,
                                train=True)
    p_loss.backward()
    if tap == 0:
        close(net["ctc_tgt_logits"], j_logits)
        assert float(p_ex["logging"]["ctc_loss_tgt"].detach()) > 0
    else:
        assert "ctc_tgt_logits" not in net and j_logits is None
        assert float(p_ex["logging"]["ctc_loss_tgt"]) == 0.0
    close(p_loss, j_loss)
    for key in pl.MEAN_KEYS:
        close(torch.as_tensor(p_ex["logging"][key]), j_log[key], msg=key)
    for p in model.parameters():    # an unread head: JAX's gradient is 0
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    got = port_leaves(model, grads=True)
    ref = jax_leaves(j_grads, "params")
    assert set(got) == set(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key]), g, atol=1e-6, rtol=1e-4, msg=key)


@pytest.mark.parametrize("flags", [[], ["--middle-layers-decoder", "1,2"],
                                   ["--middle-layers-decoder", ""]],
                         ids=["default", "given", "empty"])
def test_arch_defaults_match_jax(flags, tmp_path):
    from s2st_tpu.options import parse_training_args
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import apply_arch
    argv = [str(tmp_path), "--arch", "s2st_transformer_mtl", *flags]
    ref = parse_training_args(argv)
    got = apply_arch(train.get_parser().parse_args(argv), argv)
    assert got.middle_layers_decoder == ref.middle_layers_decoder


MTL_FLAGS = [
    "--config-yaml", "config.yaml", "--train-subset", "train",
    "--task", "s2s_translation_mtl", "--criterion", "s2st_loss_mtl",
    "--arch", "s2st_transformer_mtl", "--ctc-weight", "0.3",
    "--ctc-weight-tgt", "0.3", "--middle-layers-decoder", "0",
    "--asr-ce-weight", "0.3", "--st-ce-weight", "0.3",
    "--label-smoothing", "0.1", "--dropout", "0", "--attention-dropout",
    "0", "--activation-dropout", "0", "--prenet-dropout", "0",
    "--postnet-dropout", "0", "--optimizer", "adam", "--lr", "1e-3",
    "--lr-scheduler", "inverse_sqrt", "--warmup-updates", "4",
    "--clip-norm", "1.0", "--seed", "1", "--max-tokens", "200",
    "--max-update", "2", "--disable-validation", "--log-interval", "1",
    "--log-format", "json", *TINY_FLAGS]


def test_train_cli_matches_jax(tmp_path):
    from s2st_tpu.cli.train import main as jax_train
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.jax_bridge import jax_variables
    from s2st_tpu_torch.tasks.s2s_translation import build_model_and_loss
    from tests.make_tiny_corpus import make_tiny_corpus
    from tests.test_torch_hubert import _losses
    from tests.test_torch_paper_recipes import jax_log_handlers
    corpus = make_tiny_corpus(tmp_path / "corpus")
    argv = [str(corpus), *MTL_FLAGS]
    args = train.get_parser().parse_args(argv)
    cfg, model, _ = build_model_and_loss(args, 11, 11, 8)
    assert cfg.ctc_tgt and cfg.middle_layers_decoder == (0,)
    init = jnp_tree({"stats": {}, **jax_variables(model)})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jm, "init_s2st", lambda *a, **k: init)
        for pkg, main, extra in (("port", train.main, ["--device", "cpu"]),
                                 ("jax", jax_train, [])):
            save = tmp_path / pkg
            with jax_log_handlers():
                assert main(argv + extra + ["--save-dir", str(save),
                                            "--log-file",
                                            str(save / "log")]) == 0, pkg
    want = _losses(tmp_path / "jax" / "log", "train_inner_loss")
    got = _losses(tmp_path / "port" / "log", "loss")
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    want = _losses(tmp_path / "jax" / "log", "train_inner_ctc_loss_tgt")
    got = _losses(tmp_path / "port" / "log", "ctc_loss_tgt")
    assert min(got) > 0
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_fairseq_ctc_proj_tgt_matches_jax(mtl):
    """A fairseq state dict of the MTL model (the port's names, seeded
    values): the port's reader builds the target CTC head from
    ``decoder.ctc_proj_tgt``, and its tree is JAX's reader's."""
    from s2st_tpu.models.torch_import import from_fairseq_state_dict
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.fairseq_checkpoint import (s2st_config,
                                                          s2st_from_fairseq)
    from s2st_tpu_torch.models.jax_bridge import flatten_tree, jax_variables
    cfg, variables = mtl
    model = port_model(cfg, variables)
    g = torch.Generator().manual_seed(12)
    sd = {k: (torch.randn(v.shape, generator=g) if v.is_floating_point()
              else v) for k, v in model.state_dict().items()}
    args = train.get_parser().parse_args(
        ["data", "--arch", "s2st_transformer_mtl", "--middle-layers-decoder",
         "0", "--ctc-weight", "0.3", "--asr-ce-weight", "0.3",
         "--st-ce-weight", "0.3", *TINY_FLAGS, "--n-frames-per-step", "1"])
    pcfg = s2st_config(sd, args, cfg.input_feat_per_channel)
    assert pcfg.ctc_tgt and pcfg.tgt_vocab_size == cfg.tgt_vocab_size
    got = flatten_tree(jax_variables(s2st_from_fairseq(pcfg, sd)))
    want = flatten_tree(numpy_tree(from_fairseq_state_dict(
        {k: v.numpy() for k, v in sd.items()})))
    assert "params::decoder::ctc_proj_tgt::w" in want
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], np.asarray(want[k], got[k].dtype)), k
