"""s2st_tpu_torch's CTC fine-tuning (``--task audio_finetuning``) against
s2st_tpu's, fp32 on the CPU, dropout off.

- ``FinetuneAudioDataset`` batches through each package's epoch iterator
  over two epochs: the min-size filter, the audio padded to
  ``snap_len(longest, 256)``, the letters to ``snap_len(longest, 8)``.
- ``forward_ctc`` without and with ``--apply-mask`` (the span and channel
  masks JAX draws, rebuilt from its key splits), at lengths around the
  extractor's frame boundaries.
- The ``ctc`` criterion's loss and every parameter's gradient, frozen and
  thawed, with a blank weight added and under ``--sentence-avg``; its
  eval counters (``c_errors``, ``c_total``, ``w_errors``, ``wv_errors``,
  ``w_total``) on a batch with a pad row and an infeasible row (more
  letters than frames), with and without a blank weight that empties
  hypotheses; ``greedy_ctc_decode``, ``get_ctc_logits`` and the word
  hashes on hand-made logits with empty hypotheses and repeated "|".
- Two ``Trainer`` updates against JAX's ``Trainer`` across the freeze
  (``--freeze-finetune-updates 1``): the parameters and the whole Adam
  state after the frozen update and after the thaw. JAX's criterion never
  advances ``stats::num_updates`` (ROADMAP §3); its state is given the
  count the port's criterion returns.
- ``load_torch_ctc_asr`` and ``--w2v-path`` from a fairseq ``.pt``, a HuBERT
  pretraining ``.npz`` and a wav2vec2 ``.npz`` against JAX's
  ``load_w2v_trunk`` (from the last, only ``mask_emb``: ROADMAP §3).
- The port's train CLI fine-tunes for 2 updates from a HuBERT ``.npz``,
  validates, resumes for a third, and JAX loads ``checkpoint_last.npz``
  strictly into its own init's template.

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss rtol 1e-5; gradients divided by ``sample_size`` (the
losses are sums; the trainer divides so, as JAX's does) rtol 1e-4 and
atol 5e-5, not 1e-6: CTC's gradients are posteriors of log sums over the
time loop, whose fp32 error grows with the loss (``CTC_ATOL``; at the
logits themselves ``tests/test_torch_losses.py`` holds them to 1e-5 on
shorter rows); counters and masks exact. Across the two updates the
parameters agree to atol 1e-6 + rtol 1e-5 and Adam's moments, which hold
those gradients, to ``CTC_ATOL`` + rtol 1e-4, but for an attention key
bias, whose
gradient is 0 in exact arithmetic and rounding noise in each package,
which Adam scales to a step of up to lr (``tests/test_torch_train.py``'s
``ZERO_GRAD``).
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import ctc_asr as jc
from s2st_tpu.models import hubert as jh
from s2st_tpu.models import wav2vec2 as jw
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import ctc_asr as pc
from s2st_tpu_torch.models import hubert as ph
from s2st_tpu_torch.models import wav2vec2 as pw
from s2st_tpu_torch.models.jax_bridge import (load_jax_variables,
                                              write_jax_checkpoint)
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import numpy_tree, one_thread  # noqa: F401
from tests.test_torch_ssl_pretraining import (DATA_FLAGS, TRUNK,
                                              assert_batches_equal,
                                              both_args, check_grads,
                                              jax_batches, jax_template_load,
                                              port_batches, t, write_corpus)
from tests.test_torch_train import close, jax_leaves, port_leaves

VOCAB = 10                 # 4 specials, a b c d e |
SEP = 9
NO_DROP = dict(dropout=0.0, dropout_input=0.0, dropout_features=0.0,
               activation_dropout=0.0)


def cfgs(**kw):
    trunk = dict(TRUNK, mask_prob=0.5, mask_length=3, feature_grad_mult=0.0,
                 **NO_DROP)
    return (jc.CtcAsrConfig(trunk=jh.HubertConfig(**trunk),
                            vocab_size=VOCAB, **kw),
            pc.CtcAsrConfig(trunk=ph.HubertConfig(**trunk),
                            vocab_size=VOCAB, **kw))


def port_model(pcfg, variables, num_updates=0):
    model = pc.CtcAsrModel(pcfg)
    load_jax_variables(model, numpy_tree(
        {"params": variables["params"],
         "stats": {"num_updates": np.int32(num_updates)}}))
    return model


@pytest.fixture(scope="module")
def jax_vars():
    jcfg, _ = cfgs()
    return jc.init_ctc_asr(jax.random.PRNGKey(1), jcfg)


def ctc_batch(seed, infeasible=False):
    """Four rows: lengths around the frame boundaries (the 2-conv
    extractor makes (L - 10) // 5 + 1 frames, then (n - 3) // 2 + 1), the
    last a pad row; letters with repeated and edge "|"; with
    ``infeasible`` the second row has more letters than frames."""
    r = np.random.RandomState(seed)
    lens = np.array([1024, 1019, 700, 0], np.int32)
    src = (0.1 * r.randn(4, 1024)).astype(np.float32)
    for i, n in enumerate(lens):
        src[i, n:] = 0.0
    tgt = np.full((4, 24), 1, np.int32)
    rows = [[4, 5, SEP, SEP, 6, 7, 4], [SEP, 8, 5, SEP], [6, 6, SEP, 7]]
    if infeasible:
        rows[1] = list(r.randint(4, 9, 120))
        tgt = np.full((4, 120), 1, np.int32)
    for i, row in enumerate(rows):
        tgt[i, :len(row)] = row
    return {"source": src, "source_lens": lens, "target": tgt}


def pbatch(batch):
    return {"source": t(batch["source"]),
            "source_lens": t(batch["source_lens"]).long(),
            "target": t(batch["target"]).long()}


# --------------------------------------------------------------------------
# the dataset
# --------------------------------------------------------------------------

def test_finetune_batches_match_jax(tmp_path):
    from s2st_tpu.tasks.audio_finetuning import AudioFinetuningTask as JT
    from s2st_tpu_torch.tasks.audio_finetuning import AudioFinetuningTask
    root = write_corpus(tmp_path)
    jargs, pargs = both_args([str(root), *DATA_FLAGS, "--labels", "ltr"])
    jtask, ptask = JT.setup_task(jargs), AudioFinetuningTask(pargs)
    for epoch in (1, 2):
        got = port_batches(ptask, "train", pargs, epoch)
        assert_batches_equal(got, jax_batches(jtask, "train", jargs, epoch))
        assert all(b["source"].shape[1] % 256 == 0 for b in got)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

def jax_masks(jcfg, batch, rng):
    """The span and channel masks JAX's ``forward_ctc`` draws from
    ``rng`` (:126, :75, :91-100)."""
    r = jax.random.split(jax.random.split(rng, 2)[0], 5)
    tc = jcfg.trunk
    t_out = tc.output_length(batch["source"].shape[1])
    out_lens = np.clip(tc.output_length(batch["source_lens"]), 0, t_out)
    mask = jw.compute_span_mask(r[1], jnp.asarray(out_lens), t_out,
                                tc.mask_prob, tc.mask_length, min_masks=2)
    d = tc.encoder_embed_dim
    cmask = jw.compute_span_mask(r[2], jnp.full((len(out_lens),), d,
                                                jnp.int32), d,
                                 jcfg.mask_channel_prob,
                                 jcfg.mask_channel_length, min_masks=0)
    return {"mask": t(np.asarray(mask)), "channel_mask": t(np.asarray(cmask))}


@pytest.mark.parametrize("apply_mask", [False, True])
def test_forward_ctc_matches_jax(jax_vars, apply_mask):
    kw = dict(apply_mask=apply_mask, mask_channel_prob=0.25,
              mask_channel_length=4)
    jcfg, pcfg = cfgs(**kw)
    batch = ctc_batch(2)
    rng = jax.random.PRNGKey(3)
    ref = jax.jit(lambda p, b: jc.forward_ctc(
        p, jcfg, b["source"], b["source_lens"], rng, train=True,
        num_updates=1))(jax_vars["params"], batch)
    model = port_model(pcfg, jax_vars, 1)
    masks = jax_masks(jcfg, batch, rng) if apply_mask else {}
    if apply_mask:
        assert masks["mask"].any() and masks["channel_mask"].any()
    with torch.no_grad():
        out = model.forward_ctc(t(batch["source"]),
                                t(batch["source_lens"]).long(), train=True,
                                **masks)
    close(out["logits"], ref["logits"])
    assert np.array_equal(out["padding_mask"].numpy(),
                          np.asarray(ref["padding_mask"]))
    for blank_weight, mode in ((0.0, "add"), (1.5, "add"), (-2.0, "set")):
        jcfg2, pcfg2 = cfgs(blank_weight=blank_weight, blank_mode=mode)
        for normalize in (False, True):
            want = np.asarray(jc.get_ctc_logits(ref, jcfg2, normalize))
            got = pc.get_ctc_logits(out, pcfg2, normalize).numpy()
            finite = np.isfinite(want)
            assert np.array_equal(np.isfinite(got), finite)
            np.testing.assert_array_equal(got[~finite], want[~finite])
            close(torch.from_numpy(got[finite]), want[finite])


LCFG = dict(pad_idx=1, eos_idx=2, blank_idx=0, sep_idx=SEP)
# CTC's gradients are posteriors exp(alpha + beta - loss) of log sums over
# the time loop: at a loss near 240 (100 frames) their fp32 logs carry
# about 240 * 2^-24 = 1.4e-5 of error, so a gradient at a logit agrees to
# about 3e-5 (measured), and so do the parameters' gradients over
# sample_size and Adam's first moments
CTC_ATOL = 5e-5


def jax_ctc(variables, jcfg, batch, num_updates, train, **lkw):
    def loss_fn(params):
        loss, ex = jl.ctc_loss(
            {"params": params, "stats": {"num_updates": jnp.int32(
                num_updates)}}, jcfg, jl.CtcLossConfig(**LCFG, **lkw),
            jax.tree_util.tree_map(jnp.asarray, batch), rng=None,
            train=train)
        return loss, ex["logging"]
    if not train:
        return jax.jit(loss_fn)(variables["params"])
    return jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"])


def compare_logging(p_log, j_log):
    assert set(p_log) == set(j_log)
    for key, want in j_log.items():
        got = torch.as_tensor(p_log[key]).float()
        if key == "loss":
            close(got, want, atol=0.0)
        else:
            assert float(got) == float(want), key


@pytest.mark.parametrize("num_updates,blank_weight,sentence_avg", [
    (0, 0.0, False), (1, 0.0, False), (1, 1.5, True)])
def test_ctc_loss_and_grads_match_jax(jax_vars, num_updates, blank_weight,
                                      sentence_avg):
    jcfg, pcfg = cfgs(freeze_finetune_updates=1, blank_weight=blank_weight)
    batch = ctc_batch(4)
    (j_loss, j_log), j_grads = jax_ctc(jax_vars, jcfg, batch, num_updates,
                                       True, sentence_avg=sentence_avg)
    model = port_model(pcfg, jax_vars, num_updates)
    p_loss, p_ex = pl.ctc_criterion(
        model, pl.CtcLossConfig(**LCFG, sentence_avg=sentence_avg),
        pbatch(batch), train=True)
    p_loss.backward()
    trunk_grad = [p.grad for n, p in model.named_parameters()
                  if n.startswith("w2v_encoder.w2v_model.")]
    assert all(g is None for g in trunk_grad) == (num_updates == 0)
    compare_logging(p_ex["logging"], j_log)
    check_grads(model, j_grads, float(j_log["sample_size"]), atol=CTC_ATOL)
    assert int(p_ex["new_stats"]["num_updates"]) == num_updates + 1


@pytest.mark.parametrize("blank_weight", [0.0, 4.0])
def test_ctc_eval_counters_match_jax(jax_vars, blank_weight):
    jcfg, pcfg = cfgs(blank_weight=blank_weight)
    batch = ctc_batch(5, infeasible=True)
    j_log = jax_ctc(jax_vars, jcfg, batch, 0, False)[1]
    model = port_model(pcfg, jax_vars)
    with torch.no_grad():
        _, p_ex = pl.ctc_criterion(model, pl.CtcLossConfig(**LCFG),
                                   pbatch(batch), train=False)
    compare_logging(p_ex["logging"], j_log)
    assert float(j_log["loss"]) > 1e4          # the infeasible row's log(0)
    assert p_ex["new_stats"] == {}


def hand_logits():
    """(logits (4, 12, 6), lengths): a row that decodes to nothing, one
    with repeated and edge separators (unit 5), one cut by its length,
    one whose repeats merge."""
    seqs = [[0] * 12, [5, 5, 1, 0, 5, 2, 2, 5, 0, 5, 3, 5],
            [1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4], [2, 2, 0, 2, 5, 5, 3, 0,
                                                    3, 3, 1, 1]]
    logits = np.full((4, 12, 6), -1.0, np.float32)
    for i, seq in enumerate(seqs):
        logits[i, np.arange(12), seq] = 2.0
    return logits, np.array([12, 12, 7, 12], np.int32)


def test_decode_and_word_hashes_match_jax():
    logits, lens = hand_logits()
    jt, jn = jc.greedy_ctc_decode(jnp.asarray(logits), jnp.asarray(lens))
    pt, pn = pc.greedy_ctc_decode(t(logits), t(lens).long())
    assert np.array_equal(pt.numpy(), np.asarray(jt))
    assert np.array_equal(pn.numpy(), np.asarray(jn))
    assert pn[0] == 0
    jw_, jnw = jl._pack_words(jt, jn, 5)
    pw_, pnw = pl.pack_words(pt, pn, 5)
    assert np.array_equal(pw_.numpy(), np.asarray(jw_))
    assert np.array_equal(pnw.numpy(), np.asarray(jnw))
    ref = np.array([[1, 2, 3], [1, 3, 4], [1, 2, 3]], np.int64)
    rlen = np.array([3, 0, 2])
    for x, xl in ((pt, pn), (pw_, pnw)):
        want = jl._levenshtein_unit(jnp.asarray(x.numpy()[:3]),
                                    jnp.asarray(xl.numpy()[:3]),
                                    jnp.asarray(ref), jnp.asarray(rlen))
        got = pl.levenshtein_unit(x[:3], xl[:3], t(ref), t(rlen))
        assert np.array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------------------------
# two updates across the freeze
# --------------------------------------------------------------------------

ZERO_GRAD = re.compile(r"::k::b$")


def test_updates_across_the_freeze_match_jax_trainer(jax_vars):
    import argparse
    from s2st_tpu.parallel.mesh import make_mesh
    from s2st_tpu.train import checkpoint as jckpt
    from s2st_tpu.train.optim import adam, inverse_sqrt_schedule
    from s2st_tpu.train.trainer import Trainer as JaxTrainer
    from s2st_tpu.train.trainer import create_train_state
    from s2st_tpu_torch.train.checkpoint import state_flat
    from s2st_tpu_torch.train.optim import schedule_from_args
    from s2st_tpu_torch.train.trainer import Trainer
    lr = 1e-3
    jcfg, pcfg = cfgs(freeze_finetune_updates=1)
    variables = jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True),
                                       jax_vars)
    tx = adam(betas=(0.9, 0.98))
    mesh = make_mesh(dp=1, fsdp=1, tp=1, devices=jax.devices()[:1])
    j_tr = JaxTrainer(jcfg, jl.CtcLossConfig(**LCFG), tx,
                      inverse_sqrt_schedule(lr, 2, lr), mesh,
                      loss_fn=jl.ctc_loss)
    state = j_tr.place_state(create_train_state(variables, tx))
    model = port_model(pcfg, jax_vars)
    p_tr = Trainer(model, pl.CtcLossConfig(**LCFG), schedule_from_args(
        argparse.Namespace(lr=str(lr), lr_scheduler="inverse_sqrt",
                           warmup_updates=2, warmup_init_lr=-1.0)),
        loss_fn=pl.ctc_criterion)
    trunk0 = {k: v for k, v in port_leaves(model).items()
              if k.startswith("params::w2v::")}
    for i in range(2):
        batch = ctc_batch(10 + i)
        state, j_met = j_tr.train_step(state, [batch], jax.random.PRNGKey(i))
        p_met = p_tr.train_step(pbatch(batch))
        for key in ("loss", "gnorm", "lr", "sample_size"):
            assert math.isclose(p_met[key], float(j_met[key]), rel_tol=1e-4,
                                abs_tol=1e-7), (i, key)
        # the count the port's criterion returns (JAX's keeps 0)
        assert int(model.stats.num_updates) == i + 1
        state = type(state)(params=state.params,
                            stats={"num_updates": jnp.int32(i + 1)},
                            opt_state=state.opt_state, step=state.step)
        ref = {k: np.asarray(v) for k, v in jckpt._flatten_state(state)
               .items() if k != "__meta__"}
        got = state_flat(p_tr)
        assert set(got) == set(ref)
        for key, r in ref.items():
            moment = key.startswith(("opt::0::.mu", "opt::0::.nu"))
            atol = 3 * lr * (i + 1) if ZERO_GRAD.search(key) else \
                CTC_ATOL if moment else 1e-6
            close(torch.from_numpy(np.asarray(got[key])), r, atol=atol,
                  rtol=1e-4 if moment else 1e-5,
                  msg=f"update {i + 1}: {key}")
        moved = [k for k, v in trunk0.items()
                 if not np.array_equal(port_leaves(model)[k], v)]
        # frozen in the first update; every trunk leaf but the extractor
        # (feature_grad_mult 0) and mask_emb (no mask) moves in the second
        assert (len(moved) > 0) == (i == 1)
        assert not any("extractor" in k or "mask_emb" in k for k in moved)


# --------------------------------------------------------------------------
# the readers and --w2v-path
# --------------------------------------------------------------------------

def fold_to_fairseq(sd, prefix):
    """A port state_dict -> fairseq's (``pos_conv`` as weight_g/v)."""
    sd = {k: v.clone() for k, v in sd.items() if not k.endswith(
        "num_updates")}
    w = sd.pop(prefix + "encoder.pos_conv.0.weight")
    sd[prefix + "encoder.pos_conv.0.weight_g"] = \
        w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd[prefix + "encoder.pos_conv.0.weight_v"] = w
    return sd


def test_load_torch_ctc_asr_matches_jax(tmp_path):
    jcfg, pcfg = cfgs()
    src = pc.CtcAsrModel(pcfg).init_weights(7)
    path = str(tmp_path / "ft.pt")
    torch.save({"model": fold_to_fairseq(src.state_dict(),
                                         "w2v_encoder.w2v_model.")}, path)
    got = port_leaves(pc.load_torch_ctc_asr(path, pcfg))
    ref = jax_leaves(jc.load_torch_ctc_asr(path, jcfg)["params"], "params")
    ref["stats::num_updates"] = np.zeros((), np.int32)
    assert set(got) == set(ref)
    for key, v in ref.items():
        close(torch.from_numpy(got[key]), v, atol=1e-6, rtol=1e-6, msg=key)


def w2v_sources(tmp_path, pcfg):
    """--w2v-path files: a HuBERT pretraining fairseq .pt, its .npz, a
    wav2vec2 .npz."""
    hub_cfg = ph.HubertConfig(**TRUNK, num_classes=(8,), final_dim=6)
    hub = ph.HubertPretrainModel(hub_cfg).init_weights(8)
    pt = str(tmp_path / "hubert.pt")
    torch.save({"model": fold_to_fairseq(hub.state_dict(), "")}, pt)
    hub_npz = str(tmp_path / "hubert.npz")
    write_jax_checkpoint(hub_npz, hub)
    w2v = pw.Wav2Vec2Model(pw.Wav2Vec2Config(
        trunk=ph.HubertConfig(**TRUNK), final_dim=6, latent_vars=4))
    w2v_npz = str(tmp_path / "w2v.npz")
    write_jax_checkpoint(w2v_npz, w2v.init_weights(9))
    return {"pt": pt, "hubert_npz": hub_npz, "w2v_npz": w2v_npz}


@pytest.mark.parametrize("source", ["pt", "hubert_npz", "w2v_npz"])
def test_w2v_path_matches_jax(jax_vars, tmp_path, source):
    jcfg, pcfg = cfgs()
    path = w2v_sources(tmp_path, pcfg)[source]
    ref = jc.load_w2v_trunk(jax_vars, path, jcfg)
    model = port_model(pcfg, jax_vars)
    before = port_leaves(model)
    got = port_leaves(pc.load_w2v_trunk(model, path))
    want = jax_leaves(ref["params"], "params")
    assert set(got) - {"stats::num_updates"} == set(want)
    for key, v in want.items():
        close(torch.from_numpy(got[key]), v, atol=1e-6, rtol=1e-6, msg=key)
    changed = {k for k in want if not np.array_equal(got[k], before[k])}
    if source == "w2v_npz":
        # the wav2vec2 file's trunk is under params::trunk: JAX merges by
        # top-level key, so only mask_emb is taken
        assert changed == {"params::w2v::mask_emb"}
    else:
        assert "params::w2v::layer0::fc1::w" in changed
        assert not any(k.startswith("params::proj") for k in changed)


# --------------------------------------------------------------------------
# the train CLI
# --------------------------------------------------------------------------

CLI_FLAGS = ["--train-subset", "train", "--valid-subset", "dev",
             "--task", "audio_finetuning", "--arch", "hubert_ctc",
             "--criterion", "ctc", "--labels", "ltr",
             "--encoder-layers", "2", "--encoder-embed-dim", "8",
             "--encoder-ffn-embed-dim", "32", "--encoder-attention-heads",
             "2", "--conv-feature-layers", "[(8,10,5),(8,3,2)]",
             "--conv-pos", "8", "--conv-pos-groups", "2",
             "--min-sample-size", "600", "--max-sample-size", "1600",
             "--max-tokens", "8000", "--optimizer", "adam", "--lr", "0.0005",
             "--seed", "1", "--log-interval", "1",
             "--required-batch-size-multiple", "1",
             "--freeze-finetune-updates", "1"]


def test_train_cli_finetunes_and_jax_loads_its_checkpoint(tmp_path):
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.jax_bridge import read_jax_checkpoint
    root = write_corpus(tmp_path / "data")
    trunk = ph.HubertConfig(**dict(TRUNK, encoder_embed_dim=8),
                            num_classes=(8,), final_dim=4)
    pre = str(tmp_path / "pre.npz")
    write_jax_checkpoint(pre, ph.HubertPretrainModel(trunk).init_weights(5))
    save = tmp_path / "ckpt"
    log = save / "log"
    argv = [str(root), *CLI_FLAGS, "--w2v-path", pre]
    run = argv + ["--save-dir", str(save), "--log-file", str(log),
                  "--device", "cpu", "--validate-interval-updates", "1"]
    assert train.main(run + ["--max-update", "1"]) == 0
    after1, _ = read_jax_checkpoint(str(save / "checkpoint_last.npz"))
    pre_tree, _ = read_jax_checkpoint(pre)
    for key, v in jax_leaves(pre_tree["params"], "params").items():
        if key.split("::")[1] not in ("final_proj", "label_embs"):
            w = after1["params"]["w2v"]
            for part in key.split("::")[1:]:
                w = w[part]
            assert np.array_equal(w, v), key      # frozen: bit for bit
    assert train.main(run + ["--max-update", "3"]) == 0
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    train_lines = [x for x in lines if "valid" not in x]
    valid = [x["valid"] for x in lines if "valid" in x]
    assert [x["num_updates"] for x in train_lines] == [1, 2, 3]
    assert len(valid) == 3
    for v in valid:
        for key in ("c_errors", "c_total", "w_errors", "w_total"):
            assert np.isfinite(v[key]) and v["c_total"] > 0, key
    loaded = jax_template_load(argv, save / "checkpoint_last.npz")
    assert set(loaded["params"]) == {"w2v", "proj"}
    assert int(loaded["stats"]["num_updates"]) == 3
    final, _ = read_jax_checkpoint(str(save / "checkpoint_last.npz"))
    assert not np.array_equal(final["params"]["w2v"]["layer0"]["fc1"]["w"],
                              after1["params"]["w2v"]["layer0"]["fc1"]["w"])
    assert np.array_equal(final["params"]["w2v"]["extractor"]["conv0"]["w"],
                          after1["params"]["w2v"]["extractor"]["conv0"]["w"])
