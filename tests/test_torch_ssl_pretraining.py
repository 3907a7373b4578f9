"""s2st_tpu_torch's self-supervised speech training against s2st_tpu's,
fp32 on the CPU, dropout off.

- ``RawAudioDataset`` and ``HubertPretrainDataset`` batches, through each
  package's epoch iterator, equal JAX's over two epochs: the min-size
  filter, the crop-to-shortest snapped down, the label streams cropped in
  step with the label crop's left clamp and the last-unit pad, with and
  without ``--normalize``.
- ``compute_span_mask``'s statistics (nothing on padding, the realized
  fraction, ``min_masks``), as ``tests/test_wav2vec2.py`` checks JAX's.
- HuBERT's ``forward_pretrain`` with a tied and an untied ``final_proj``
  (2 label streams), given JAX's span mask, and ``hubert_loss`` with both
  branches on over a batch with a pad row: the loss terms, the meters and
  every parameter's gradient.
- wav2vec 2.0's ``forward_pretrain`` and ``wav2vec_loss`` given JAX's
  draws (span mask, negatives with cross-sample ones, Gumbel noise, each
  rebuilt from JAX's key splits), in training and in eval: the loss
  terms, the temperature at a nonzero update count, the counter's
  increment, every parameter's gradient; an odd ``conv_pos``.
- ``grad_mult`` and wav2vec2's ``extract_features``; ``load_torch_wav2vec2``
  against JAX's reader.
- The arch defaults of ``hubert``, ``wav2vec2``, ``wav2vec_ctc`` and
  ``hubert_ctc`` as JAX's ``_two_pass`` gives them, a given flag winning.
- The port's train CLI runs 2 updates of ``hubert_pretraining`` and of
  ``audio_pretraining``, validated, resumes the latter for a third, and
  JAX loads each ``checkpoint_last.npz`` strictly into its own init's
  template (``stats::num_updates`` 2, then 3, for wav2vec2).

Tolerances (fp32 both sides, summation order only): outputs atol 1e-5 +
rtol 1e-5; the loss rtol 1e-5; gradients atol 1e-6 + rtol 1e-4, as
``tests/test_torch_train.py`` holds them, on the gradients divided by
``sample_size``: the losses are sums over frames, and the trainer divides
their gradients so (as JAX's does). Counts are exact.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import hubert as jh
from s2st_tpu.models import wav2vec2 as jw
from s2st_tpu.train import losses as jl
from s2st_tpu_torch.models import hubert as ph
from s2st_tpu_torch.models import wav2vec2 as pw
from s2st_tpu_torch.models.jax_bridge import load_jax_variables
from s2st_tpu_torch.train import losses as pl
from tests._torch_port import numpy_tree, one_thread  # noqa: F401
from tests.test_torch_train import close, jax_leaves, port_leaves

TRUNK = dict(conv_layers=((8, 10, 5), (8, 3, 2)), encoder_layers=2,
             encoder_embed_dim=16, encoder_ffn_embed_dim=32,
             encoder_attention_heads=2, conv_pos=8, conv_pos_groups=2)
NO_DROP = dict(dropout=0.0, dropout_input=0.0, dropout_features=0.0,
               activation_dropout=0.0)
CLASSES = (7, 5)


def t(x):
    return torch.from_numpy(np.array(x, order="C"))


def grads_with_zeros(model):
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    return port_leaves(model, grads=True)


def check_grads(model, j_grads, sample_size, atol=1e-6):
    """Every parameter's gradient divided by ``sample_size``, as the
    trainer applies it: these losses are sums over frames, not means."""
    got = grads_with_zeros(model)
    ref = jax_leaves(j_grads, "params")
    assert set(got) == set(ref)
    for key, g in ref.items():
        close(torch.from_numpy(got[key] / sample_size), g / sample_size,
              atol=atol, rtol=1e-4, msg=key)


# --------------------------------------------------------------------------
# the datasets
# --------------------------------------------------------------------------

SIZES = [1200, 1300, 1450, 500, 1600, 2000, 1700, 1250, 1900]


def write_corpus(root, sizes=SIZES, seed=0):
    """Seeded 16 kHz WAVs, their manifest, two k-means label streams (one
    unit a 10 samples, some rows 8 units short so that the crop clamps
    left) and a letter transcript a row."""
    from s2st_tpu_torch.data.audio_utils import write_wav
    r = np.random.RandomState(seed)
    (root / "audio").mkdir(parents=True, exist_ok=True)
    lines = []
    for i, n in enumerate(sizes):
        write_wav(str(root / "audio" / f"u{i}.wav"),
                  np.clip(0.1 * r.randn(n), -1, 1), 16000)
        lines.append(f"u{i}.wav\t{n}")
    for split in ("train", "dev"):
        (root / f"{split}.tsv").write_text(
            str(root / "audio") + "\n" + "\n".join(lines) + "\n")
    units = {"km": list("abcd"), "km2": list("xyz")}
    letters = list("abcde") + ["|"]
    for lbl, syms in units.items():
        (root / f"dict.{lbl}.txt").write_text(
            "".join(f"{u} 1\n" for u in syms))
    (root / "dict.ltr.txt").write_text("".join(f"{u} 1\n" for u in letters))
    for split in ("train", "dev"):
        for lbl, syms in units.items():
            rows = [" ".join(r.choice(syms, n // 10 - (8 if i % 3 == 0
                                                       else 0)))
                    for i, n in enumerate(sizes)]
            (root / f"{split}.{lbl}").write_text("\n".join(rows) + "\n")
        rows = [" ".join(r.choice(letters, 3 + i % 5))
                for i in range(len(sizes))]
        (root / f"{split}.ltr").write_text("\n".join(rows) + "\n")
    return root


def both_args(argv):
    """(JAX's namespace, the port's) of one training command line."""
    from s2st_tpu.options import parse_training_args
    from s2st_tpu_torch.cli import train
    from s2st_tpu_torch.models.config_from_args import apply_arch
    return parse_training_args(argv), \
        apply_arch(train.get_parser().parse_args(argv), argv)


def port_batches(task, split, args, epoch):
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    itr = EpochBatchIterator(
        task.load_dataset(split), args.max_tokens, args.batch_size,
        seed=args.seed,
        required_batch_size_multiple=args.required_batch_size_multiple)
    itr.epoch = epoch
    return list(itr.next_epoch_itr())


def jax_batches(task, split, args, epoch):
    itr = task.get_batch_iterator(split, max_tokens=args.max_tokens,
                                  max_sentences=args.batch_size,
                                  seed=args.seed, shuffle=True)
    itr.epoch = epoch
    return list(itr.next_epoch_itr(shuffle=True))


def assert_batches_equal(got, ref):
    assert len(got) == len(ref) > 1
    for g, r in zip(got, ref):
        assert set(g) == set(r)
        for k, v in r.items():
            want = np.stack(v) if k == "target_list" else np.asarray(v)
            have = g[k].numpy() if isinstance(g[k], torch.Tensor) \
                else np.asarray(g[k])
            assert have.shape == want.shape, k
            np.testing.assert_array_equal(have, want, err_msg=k)


DATA_FLAGS = ["--train-subset", "train", "--min-sample-size", "600",
              "--max-sample-size", "1600", "--max-tokens", "4000",
              "--seed", "3", "--required-batch-size-multiple", "1"]


@pytest.mark.parametrize("normalize", [False, True])
def test_audio_batches_match_jax(tmp_path, normalize):
    from s2st_tpu.tasks.audio_pretraining import AudioPretrainingTask as JT
    from s2st_tpu.tasks.hubert_pretraining import HubertPretrainingTask as JH
    from s2st_tpu_torch.tasks.audio_pretraining import AudioPretrainingTask
    from s2st_tpu_torch.tasks.hubert_pretraining import HubertPretrainingTask
    root = write_corpus(tmp_path)
    argv = [str(root), *DATA_FLAGS, "--labels", "km,km2",
            "--label-rate", "1600"] + (["--normalize"] if normalize else [])
    jargs, pargs = both_args(argv)
    for jcls, pcls in ((JT, AudioPretrainingTask),
                       (JH, HubertPretrainingTask)):
        jtask, ptask = jcls.setup_task(jargs), pcls(pargs)
        assert len(ptask.load_dataset("train")) == len(SIZES) - 1
        for epoch in (1, 2):
            got = port_batches(ptask, "train", pargs, epoch)
            ref = jax_batches(jtask, "train", jargs, epoch)
            assert_batches_equal(got, ref)
    assert clamped_crops(HubertPretrainingTask(pargs), pargs) > 0


def clamped_crops(task, args):
    """How many of two epochs' crops the label windows clamped left."""
    from s2st_tpu_torch.data.iterators import EpochBatchIterator
    ds = task.load_dataset("train")
    itr = EpochBatchIterator(ds, args.max_tokens, args.batch_size,
                             seed=args.seed)
    n = 0
    for epoch in (1, 2):
        itr.epoch = epoch
        for idxs in itr.batches_for_epoch(epoch):
            items = [itr.fetch_item(i) for i in idxs]
            target = ds.snap_kwargs(items)["target_size"]
            frm = int(round(target * 0.1))
            for it in items:
                if len(it["wav"]) > target:
                    start = np.random.RandomState(it["crop_seed"]).randint(
                        0, len(it["wav"]) - target + 1)
                    rem = min(len(lab) for lab in it["labels"])
                    n += start > int(max(rem - frm, 0) / 0.1)
    return n


# --------------------------------------------------------------------------
# the span mask
# --------------------------------------------------------------------------

def test_span_mask_statistics():
    lens = [100, 80, 60, 40]
    lengths = torch.tensor(lens)
    g = torch.Generator().manual_seed(0)
    fracs = []
    for _ in range(30):
        m = pw.compute_span_mask(lengths, 100, 0.5, 10, generator=g).numpy()
        for i, n in enumerate(lens):
            assert not m[i, n:].any()
        fracs.append(m.sum(1) / np.asarray(lens))
    # mask_prob 0.5 with the with-replacement overlap: a bit under 0.5
    assert 0.30 < np.mean(fracs) < 0.55
    # min_masks: a low mask_prob still masks at least one whole span of a
    # row longer than the span; a row of length 0 gets nothing
    short = torch.tensor([30, 12, 0])
    for _ in range(20):
        m = pw.compute_span_mask(short, 30, 0.01, 10, min_masks=2,
                                 generator=g)
        assert m[0].sum() >= 10 and m[1].sum() >= 10 and not m[2].any()
        assert not pw.compute_span_mask(short, 30, 0.01, 10, min_masks=0,
                                        generator=g)[2].any()


# --------------------------------------------------------------------------
# HuBERT pretraining
# --------------------------------------------------------------------------

def hubert_cfgs(untie, label_rate=1600.0):
    kw = dict(TRUNK, label_rate=label_rate, final_dim=6, num_classes=CLASSES,
              untie_final_proj=untie, mask_prob=0.5, mask_length=3,
              feature_grad_mult=0.1, **NO_DROP)
    return jh.HubertConfig(dtype=jnp.float32, **kw), ph.HubertConfig(**kw)


def hubert_batch(seed, label_rate=1600.0):
    """Three rows, the last a pad row (length 0, pad labels)."""
    r = np.random.RandomState(seed)
    lens = np.array([1400, 1100, 0], np.int32)
    src = (0.1 * r.randn(3, 1400)).astype(np.float32)
    src[1, 1100:] = 0.0
    src[2] = 0.0
    # 3 labels short of the frames: the features are trimmed to them
    n_lbl = int(round(1400 * label_rate / 16000)) - 3
    tl = np.stack([r.randint(0, c, (3, n_lbl))
                   for c in CLASSES]).astype(np.int32)
    tl[:, 2] = 1
    return {"source": src, "source_lens": lens, "target_list": tl}


def jax_hubert_mask(jcfg, batch):
    """JAX's span mask for the batch's frames (``forward_pretrain``'s
    draw, rebuilt)."""
    feat = jcfg.output_length(batch["source"].shape[1])
    n_lbl = batch["target_list"].shape[2]
    ratio = jcfg.feat2tar_ratio
    feat = min(feat, int(n_lbl / ratio)) if ratio * feat > n_lbl else feat
    k = max(batch["source"].shape[1] // feat, 1)
    out_lens = (np.arange(feat)[None] * k < batch["source_lens"][:, None]
                ).sum(1)
    return np.asarray(jw.compute_span_mask(
        jax.random.PRNGKey(4), jnp.asarray(out_lens, jnp.int32), feat, 0.5,
        3, min_masks=2))


@pytest.mark.parametrize("untie,label_rate", [(False, 1600.0), (True, 800.0)])
def test_hubert_forward_matches_jax(untie, label_rate):
    jcfg, pcfg = hubert_cfgs(untie, label_rate)
    variables = jh.init_hubert_pretrain(jax.random.PRNGKey(1), jcfg)
    model = ph.HubertPretrainModel(pcfg)
    load_jax_variables(model, numpy_tree(variables))
    batch = hubert_batch(2, label_rate)
    mask = jax_hubert_mask(jcfg, batch)
    ref = jax.jit(lambda p, b, m: jh.forward_pretrain(
        p, jcfg, b["source"], b["source_lens"], list(b["target_list"]),
        rng=jax.random.PRNGKey(5), train=True, mask_indices=m))(
        variables["params"], batch, mask)
    with torch.no_grad():
        out = model.forward_pretrain(
            t(batch["source"]), t(batch["source_lens"]).long(),
            list(t(batch["target_list"]).long()), train=True,
            mask_indices=t(mask))
    assert len(out["logits"]) == 2
    for got, want in zip(out["logits"], ref["logits"]):
        finite = np.isfinite(np.asarray(want))
        assert np.array_equal(np.isfinite(got.numpy()), finite)
        close(got[torch.from_numpy(finite)], np.asarray(want)[finite])
    for key in ("padding_mask", "mask"):
        assert np.array_equal(out[key].numpy(), np.asarray(ref[key])), key
    for got, want in zip(out["target_list"], ref["target_list"]):
        assert np.array_equal(got.numpy(), np.asarray(want))
    close(out["features_pen"], ref["features_pen"])


@pytest.mark.parametrize("untie", [False, True])
def test_hubert_loss_and_grads_match_jax(untie):
    jcfg, pcfg = hubert_cfgs(untie)
    variables = jh.init_hubert_pretrain(jax.random.PRNGKey(6), jcfg)
    model = ph.HubertPretrainModel(pcfg)
    load_jax_variables(model, numpy_tree(variables))
    batch = hubert_batch(7)
    mask = jax_hubert_mask(jcfg, batch)
    lcfg = dict(pred_masked_weight=1.0, pred_nomask_weight=0.5,
                features_pen_weight=10.0)

    def loss_fn(params, m):
        hub_fwd = jh.forward_pretrain

        def fwd(p, c, s, n, tl, rng=None, train=True):
            return hub_fwd(p, c, s, n, tl, rng, train, mask_indices=m)
        jh.forward_pretrain = fwd
        try:
            loss, ex = jl.hubert_loss({"params": params, "stats": {}}, jcfg,
                                      jl.HubertLossConfig(**lcfg),
                                      jax.tree_util.tree_map(jnp.asarray,
                                                             batch),
                                      rng=jax.random.PRNGKey(8), train=True)
        finally:
            jh.forward_pretrain = hub_fwd
        return loss, ex["logging"]

    (j_loss, j_log), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"], jnp.asarray(mask))
    p_loss, p_ex = pl.hubert_loss(
        model, pl.HubertLossConfig(**lcfg),
        {"source": t(batch["source"]),
         "source_lens": t(batch["source_lens"]).long(),
         "target_list": t(batch["target_list"]).long()},
        train=True, mask_indices=t(mask))
    p_loss.backward()
    close(p_loss, j_loss, atol=0.0)
    assert set(p_ex["logging"]) == set(j_log)
    for key, want in j_log.items():
        got = torch.as_tensor(p_ex["logging"][key]).float()
        if key.startswith(("correct", "count", "ntokens", "sample", "nsent")):
            assert float(got) == float(want), key
        else:
            close(got, want, msg=key)
    assert float(j_log["count_u_0"]) > 0 and float(j_log["count_m_0"]) > 0
    check_grads(model, j_grads, float(j_log["sample_size"]))
    assert p_ex["new_stats"] == {}


# --------------------------------------------------------------------------
# wav2vec 2.0
# --------------------------------------------------------------------------

W2V = dict(final_dim=8, latent_groups=2, num_negatives=4,
           mask_prob=0.5, mask_length=3, feature_grad_mult=0.1,
           attention_dropout=0.0, **NO_DROP)


def w2v_cfgs(cross=0, conv_pos=8, latent_vars=6):
    trunk = dict(TRUNK, conv_pos=conv_pos)
    kw = dict(W2V, cross_sample_negatives=cross, latent_vars=latent_vars)
    return (jw.Wav2Vec2Config(trunk=jh.HubertConfig(**trunk), **kw),
            pw.Wav2Vec2Config(trunk=ph.HubertConfig(**trunk), **kw))


def w2v_batch(seed):
    r = np.random.RandomState(seed)
    src = (0.1 * r.randn(3, 1200)).astype(np.float32)
    lens = np.array([1200, 1000, 700], np.int32)
    for i, n in enumerate(lens):
        src[i, n:] = 0.0
    return {"source": src, "source_lens": lens}


def jax_w2v_draws(jcfg, batch, rng):
    """The mask, negatives and Gumbel noise JAX's ``forward_pretrain``
    draws from ``rng`` (its key splits, :288, :335, gumbel_quantize)."""
    r_mask, _, _, r_q, r_neg, _ = jax.random.split(rng, 6)
    tc = jcfg.trunk
    t_out = tc.output_length(batch["source"].shape[1])
    out_lens = np.clip(tc.output_length(batch["source_lens"]), 0, t_out)
    b = batch["source"].shape[0]
    mask = jw.compute_span_mask(r_mask, jnp.asarray(out_lens), t_out,
                                jcfg.mask_prob, jcfg.mask_length,
                                jcfg.mask_min_masks)

    def bumped(key, high, n):
        idx = np.asarray(jax.random.randint(key, (b, t_out * n), 0,
                                            high - 1))
        tszs = np.repeat(np.arange(t_out), n)[None, :]
        return np.where(idx >= tszs, idx + 1, idx).reshape(b, t_out, n)

    r1, rng2 = jax.random.split(r_neg)
    own = bumped(r1, t_out, jcfg.num_negatives)
    cross = None
    if jcfg.cross_sample_negatives:
        r2, _ = jax.random.split(rng2)
        cross = t(bumped(r2, b * t_out, jcfg.cross_sample_negatives))
    gumbel = jax.random.gumbel(
        r_q, (b * t_out, jcfg.latent_groups, jcfg.latent_vars), jnp.float32)
    return {"mask": t(np.asarray(mask)), "negatives": (t(own), cross),
            "gumbel": t(np.asarray(gumbel))}


# A negative is a duplicate when it equals the positive exactly. In
# training the straight-through codes are one-hot only up to rounding
# ((1 + p) - p), which differs in the last bit between the two packages'
# softmaxes, so two frames of one code may be equal in one package and not
# the other: the training cases take a codebook of 1000 x 2 entries, where
# no drawn negative shares its anchor's code (asserted); eval's hard codes
# are exact, and there 6 x 2 entries give duplicates (asserted).
@pytest.mark.parametrize("cross,conv_pos,train,latent_vars", [
    (0, 8, True, 1000), (2, 7, True, 1000), (0, 8, False, 6)])
def test_wav2vec2_loss_and_grads_match_jax(cross, conv_pos, train,
                                           latent_vars):
    jcfg, pcfg = w2v_cfgs(cross, conv_pos, latent_vars)
    variables = jw.init_wav2vec2(jax.random.PRNGKey(9), jcfg)
    stats = {"num_updates": jnp.int32(7000)}
    model = pw.Wav2Vec2Model(pcfg)
    load_jax_variables(model, numpy_tree({"params": variables["params"],
                                          "stats": stats}))
    batch = w2v_batch(10)
    rng = jax.random.PRNGKey(11)
    lcfg = dict(prob_ppl_weight=0.1, features_pen_weight=10.0)

    def loss_fn(params):
        loss, ex = jl.wav2vec_loss(
            {"params": params, "stats": stats}, jcfg,
            jl.Wav2VecLossConfig(**lcfg),
            jax.tree_util.tree_map(jnp.asarray, batch), rng=rng, train=train)
        return loss, ex

    (j_loss, j_ex), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(variables["params"])
    j_net = jax.jit(lambda p: jw.forward_pretrain(
        p, jcfg, batch["source"], batch["source_lens"],
        stats["num_updates"], rng, train=train))(variables["params"])
    assert bool((np.asarray(j_net["logits"]) < -1e8).any()) == (not train)
    draws = jax_w2v_draws(jcfg, batch, rng)
    if not train:
        del draws["gumbel"]
    p_loss, p_ex = pl.wav2vec_loss(
        model, pl.Wav2VecLossConfig(**lcfg),
        {"source": t(batch["source"]),
         "source_lens": t(batch["source_lens"]).long()}, train=train,
        **draws)
    p_loss.backward()
    close(p_loss, j_loss, atol=0.0)
    j_log = j_ex["logging"]
    assert set(p_ex["logging"]) == set(j_log)
    for key, want in j_log.items():
        got = torch.as_tensor(p_ex["logging"][key]).float()
        if key in ("n_correct", "total", "ntokens", "sample_size",
                   "nsentences"):
            assert float(got) == float(want), key
        else:
            close(got, want, msg=key)
    assert float(j_log["temp"]) < 2.0
    check_grads(model, j_grads, float(j_log["sample_size"]))
    if train:
        assert int(p_ex["new_stats"]["num_updates"]) == \
            int(j_ex["new_stats"]["num_updates"]) == 7001
    else:
        assert p_ex["new_stats"] == {}


def test_grad_mult_is_jax():
    """``grad_mult``: JAX's forward value bit for bit and the gradient
    times c, c = 0 detaching."""
    x = np.random.RandomState(13).randn(7).astype(np.float32)
    for c in (0.0, 0.1, 1.0):
        want = np.asarray(jw._grad_mult(jnp.asarray(x), c))
        xt = t(x).requires_grad_()
        y = ph.grad_mult(xt, c)
        assert np.array_equal(y.detach().numpy(), want)
        assert y.requires_grad == (c != 0.0)
        if c:
            (y ** 2).sum().backward()
            close(xt.grad, 2 * c * x, atol=0.0, rtol=1e-6)


def test_wav2vec2_extract_features_matches_jax():
    jcfg, pcfg = w2v_cfgs()
    variables = jw.init_wav2vec2(jax.random.PRNGKey(14), jcfg)
    model = pw.Wav2Vec2Model(pcfg)
    load_jax_variables(model, numpy_tree({"params": variables["params"],
                                          "stats": {"num_updates": 0}}))
    batch = w2v_batch(15)
    ref, ref_lens = jax.jit(lambda p, s, n: jw.extract_features(
        p, jcfg, s, n))(variables["params"], batch["source"],
                        batch["source_lens"])
    with torch.no_grad():
        got, lens = model.extract_features(t(batch["source"]),
                                           t(batch["source_lens"]).long())
    close(got, ref)
    assert lens.tolist() == np.asarray(ref_lens).tolist()


def test_current_temp_is_jax_fp32():
    cfg, _ = w2v_cfgs()
    for n in (0, 1, 2, 1000, 10 ** 6):
        want = np.asarray(jw.current_temp(cfg, jnp.int32(n)))
        got = pw.current_temp(cfg, torch.tensor(n, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == float(want), n


def test_wav2vec2_pt_reader_matches_jax(tmp_path):
    jcfg, pcfg = w2v_cfgs()
    model = pw.Wav2Vec2Model(pcfg).init_weights(12)
    sd = {k: v for k, v in model.state_dict().items()
          if k != "stats.num_updates"}
    sd["quantizer.vars"] = sd["quantizer.vars"][None]
    w = sd.pop("encoder.pos_conv.0.weight")
    norm = w.pow(2).sum(dim=(0, 1), keepdim=True).sqrt()
    sd["encoder.pos_conv.0.weight_g"] = norm
    sd["encoder.pos_conv.0.weight_v"] = w
    path = str(tmp_path / "w2v.pt")
    torch.save({"model": sd}, path)
    got, _ = pw.load_torch_wav2vec2(path, pcfg)
    ref, _ = jw.load_torch_wav2vec2(path, jcfg)
    loaded = pw.Wav2Vec2Model(pcfg)
    loaded.load_state_dict(got, strict=True)
    mine = port_leaves(loaded)
    # JAX's trunk reader also copies mask_emb and final_proj under
    # params::trunk, where init_wav2vec2's tree has no such leaves
    theirs = {k: v for k, v in jax_leaves(ref["params"], "params").items()
              if not k.startswith(("params::trunk::mask_emb",
                                   "params::trunk::final_proj"))}
    theirs["stats::num_updates"] = np.zeros((), np.int32)
    assert set(mine) == set(theirs)
    for key, v in theirs.items():
        close(torch.from_numpy(mine[key]), v, atol=1e-6, rtol=1e-6, msg=key)


# --------------------------------------------------------------------------
# the arch defaults and the train CLI
# --------------------------------------------------------------------------

ARCH_CASES = [["--arch", a] for a in ("hubert", "wav2vec2", "wav2vec_ctc",
                                      "hubert_ctc")] + [
    ["--arch", "hubert", "--mask-prob", "0.3", "--dropout", "0.0"],
    ["--arch", "hubert_ctc", "--feature-grad-mult", "0.5",
     "--encoder-layers", "2"]]
ARCH_KEYS = ("encoder_layers", "encoder_embed_dim", "encoder_ffn_embed_dim",
             "encoder_attention_heads", "dropout", "attention_dropout",
             "activation_dropout", "dropout_input", "dropout_features",
             "feature_grad_mult", "mask_prob", "mask_length", "loss_weights",
             "quantize_targets", "infonce", "conv_feature_layers",
             "conv_pos", "conv_pos_groups", "final_dim", "latent_temp",
             "labels", "label_rate", "w2v_path", "freeze_finetune_updates",
             "zero_infinity", "blank_mode", "sample_rate",
             "max_sample_size", "min_sample_size")


@pytest.mark.parametrize("flags", ARCH_CASES, ids="-".join)
def test_arch_defaults_match_jax(flags, tmp_path):
    ref, got = both_args([str(tmp_path), *flags])
    for key in ARCH_KEYS:
        assert getattr(got, key) == getattr(ref, key), key


CLI_FLAGS = ["--train-subset", "train", "--encoder-layers", "2",
             "--encoder-embed-dim", "16", "--encoder-ffn-embed-dim", "32",
             "--encoder-attention-heads", "2",
             "--conv-feature-layers", "[(8,10,5),(8,3,2)]", "--conv-pos", "8",
             "--conv-pos-groups", "2", "--min-sample-size", "600",
             "--max-sample-size", "1600", "--max-tokens", "6000",
             "--optimizer", "adam", "--lr", "0.0005", "--seed", "1",
             "--log-interval", "1", "--required-batch-size-multiple", "1",
             "--valid-subset", "dev", "--validate-interval-updates", "2",
             "--final-dim", "8", "--mask-length", "2"]
TASKS = {
    "hubert": ["--task", "hubert_pretraining", "--arch", "hubert",
               "--criterion", "hubert", "--labels", "km",
               "--label-rate", "1600"],
    "wav2vec2": ["--task", "audio_pretraining", "--arch", "wav2vec2",
                 "--criterion", "wav2vec", "--latent-vars", "5",
                 "--num-negatives", "3"],
}


def jax_template_load(argv, path):
    """JAX's strict load of ``path`` into its own init's template."""
    from s2st_tpu.options import parse_training_args
    from s2st_tpu.registry import get_task
    from s2st_tpu.train import checkpoint as jckpt
    args = parse_training_args(argv)
    task = get_task(args.task).setup_task(args)
    _, init_fn, _ = task.build_model_and_loss()
    template = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    return jckpt.load_variables_any(str(path), template=template)


@pytest.mark.parametrize("name", sorted(TASKS))
def test_train_cli_runs_and_jax_loads_its_checkpoint(name, tmp_path):
    from s2st_tpu_torch.cli import train
    root = write_corpus(tmp_path / "data")
    save = tmp_path / "ckpt"
    argv = [str(root), *CLI_FLAGS, *TASKS[name]]
    log = save / "log"
    run = argv + ["--save-dir", str(save), "--log-file", str(log),
                  "--device", "cpu"]
    assert train.main(run + ["--max-update", "2"]) == 0
    if name == "wav2vec2":     # resume for a third update
        assert train.main(run + ["--max-update", "3"]) == 0
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    valid = [x["valid"] for x in lines if "valid" in x]
    lines = [x for x in lines if "valid" not in x]
    n = 3 if name == "wav2vec2" else 2
    assert [x["num_updates"] for x in lines] == list(range(1, n + 1))
    # validated at update 2 (and at the end of the resumed run's epoch)
    assert valid and all(np.isfinite(v["loss"]) for v in valid)
    assert all(np.isfinite(x["loss"]) for x in lines)
    if name == "wav2vec2":
        assert [x["temp"] for x in lines] == pytest.approx(
            [max(2 * 0.999995 ** k, 0.5) for k in range(n)], rel=1e-6)
    loaded = jax_template_load(argv, save / "checkpoint_last.npz")
    with np.load(save / "checkpoint_last.npz") as z:
        assert int(z["stats::num_updates"]) == (n if name == "wav2vec2"
                                                else 0)
    assert int(loaded["stats"]["num_updates"]) == (n if name == "wav2vec2"
                                                   else 0)
    top = {"trunk", "mask_emb", "quantizer", "project_q", "final_proj"} \
        if name == "wav2vec2" else {"mask_emb", "final_proj", "label_embs"}
    assert top <= set(loaded["params"])
