"""s2st_tpu_torch's search strategies, forced prefixes, prefix masks,
ensembles and lexical constraints against s2st_tpu's, on the CPU.

- the strategy steps (``_step_sampling`` with top-k, top-p, top-k >= V
  and the full support, ``_step_diverse_beam`` and
  ``_step_diverse_siblings`` at steps 0 and 1) on seeded log-probs: equal
  tokens and beams, scores within 1e-5. The sampler is given JAX's own
  Gumbel draws (``jax.random.gumbel`` under JAX's keys), since the port's
  default stream is a ``torch.Generator``'s;
- ``beam_search_aux`` on seeded models of ``tiny_cfg``'s shape (the aux ST
  decoder's EOS logit raised so that hypotheses end at different steps),
  both packages over the port encoder's taps, under each strategy, with a
  forced prefix, with ``prefix_allowed_fn`` and with a 2-model ensemble:
  tokens and lengths equal, scores and per-position scores within 1e-5;
- the constraint tables array for array, the ordered and unordered state
  machines on seeded token streams, and an ordered and an unordered
  constrained decode, as above.

fp32 on both sides, so only the order of sums differs (1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.generate import constrained as jc
from s2st_tpu.generate import sequence_generator as jsg
from s2st_tpu_torch.generate import constrained as pc
from s2st_tpu_torch.generate import sequence_generator as psg
from tests._torch_port import port_model, t

NO_DROPOUT = dict(dropout=0.0, attention_dropout=0.0, activation_dropout=0.0,
                  prenet_dropout=0.0, postnet_dropout=0.0)
TOL = dict(atol=1e-5, rtol=0)
WHICH = "aux_st_decoder"


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port.detach().float()),
                               np.asarray(ref, np.float32), **TOL)


def jax_gumbel(rng):
    """The Gumbel draws of JAX's sampler at step t: jax.random.categorical
    is the argmax of gumbel(key_b, (K, V)) plus the logits, with keys
    split(fold_in(rng, t), B)."""
    def noise(step, shape):
        b, k, v = shape
        keys = jax.random.split(jax.random.fold_in(rng, step), b)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(key, (k, v), jnp.float32))
            for key in keys]))
    return noise


# --------------------------------------------------------------------------
# the strategy steps
# --------------------------------------------------------------------------

def _step_inputs(seed, b=3, k=4, v=11):
    r = np.random.RandomState(seed)
    lp = np.log(r.dirichlet(np.ones(v) * 0.7, size=(b, k))).astype(np.float32)
    alive = (-r.rand(b, k) * 3).astype(np.float32)
    return lp, alive


STEP_CASES = [
    ("sampling", dict(topk=3, topp=-1.0), 0),
    ("sampling", dict(topk=11, topp=-1.0), 1),      # topk >= V: full support
    ("sampling", dict(topk=-1, topp=0.6), 2),
    ("diverse_beam", dict(num_groups=2, strength=0.5), 1),
    ("diverse_beam", dict(num_groups=4, strength=2.0), 3),
    ("diverse_siblings", dict(rate=0.5), 0),
    ("diverse_siblings", dict(rate=0.5), 1),
]


@pytest.mark.parametrize("strategy,opts,step", STEP_CASES,
                         ids=[f"{s}-{i}" for i, (s, _, _) in
                              enumerate(STEP_CASES)])
def test_strategy_step_matches_jax(strategy, opts, step):
    lp, alive = _step_inputs(step + 10 * len(opts))
    k = lp.shape[1]
    if strategy == "sampling":
        rng = jax.random.PRNGKey(5)
        ref = jsg._step_sampling(jnp.asarray(step), jnp.asarray(lp),
                                 jnp.asarray(alive), k, rng, **opts)
        got = psg._step_sampling(step, t(lp), t(alive), k, jax_gumbel(rng),
                                 **opts)
    elif strategy == "diverse_beam":
        ref = jsg._step_diverse_beam(step, jnp.asarray(lp),
                                     jnp.asarray(alive), k, **opts)
        got = psg._step_diverse_beam(step, t(lp), t(alive), k, **opts)
    else:
        ref = jsg._step_diverse_siblings(jnp.asarray(step), jnp.asarray(lp),
                                         jnp.asarray(alive), k, **opts)
        got = psg._step_diverse_siblings(step, t(lp), t(alive), k, **opts)
    close(got[0], ref[0])
    assert np.array_equal(got[1].numpy(), np.asarray(ref[1]))
    assert np.array_equal(got[2].numpy(), np.asarray(ref[2]))


def test_beam_config_checks_what_jax_checks():
    with pytest.raises(ValueError, match="mutually exclusive"):
        psg.BeamConfig(strategy="sampling", sampling_topk=3,
                       sampling_topp=0.5)
    with pytest.raises(ValueError, match="num_groups"):
        psg.BeamConfig(beam=5, strategy="diverse_beam",
                       diversity_num_groups=2)
    with pytest.raises(ValueError, match="unknown search strategy"):
        psg.BeamConfig(strategy="nucleus")


# --------------------------------------------------------------------------
# beam_search_aux
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup(tiny_cfg):
    """(JAX config, two seeded models with the aux ST decoder's EOS logit
    raised: their JAX variables, port models and the port's encodings of
    3 utterances). Both packages decode over the same taps, so the
    encoders (held against each other in test_torch_model) do not run in
    JAX here."""
    from s2st_tpu_torch.models.jax_bridge import jax_variables
    from s2st_tpu_torch.models.s2st_transformer import S2STTransformer
    from tests._torch_port import port_cfg
    cfg = tiny_cfg.replace(**NO_DROPOUT)
    r = np.random.RandomState(0)
    src = r.randn(3, 37, cfg.input_feat_per_channel).astype(np.float32)
    lens = np.array([37, 30, 12], np.int32)
    src[1, 30:] = 0.0
    src[2, 12:] = 0.0
    sets = []
    for seed in (1, 2):
        v = jax_variables(S2STTransformer(port_cfg(cfg)).init_weights(seed))
        w = v["params"][WHICH]["out_proj"]["w"]
        w[:, psg.EOS] = w[:, psg.EOS] * 8.0 + 0.5 * np.abs(w).mean()
        model = port_model(cfg, v)
        with torch.no_grad():
            enc = model.encode(t(src), t(lens).long())
        tap = enc["out_middle_layers"][1]
        pad = enc["encoder_padding_mask"]
        sets.append((jax.tree_util.tree_map(jnp.asarray, v),
                     (jnp.asarray(tap.numpy()), jnp.asarray(pad.numpy())),
                     model, (tap, pad)))
    return cfg, sets


def _allowed_mask(vocab):
    """A prefix mask both packages can run: after step 1, only tokens whose
    id has the parity of the last token's."""
    def jax_fn(step, tokens):
        last = jnp.take(tokens, step, axis=2)                   # (B, K)
        ok = (jnp.arange(vocab)[None, None, :] % 2) == (last[..., None] % 2)
        return ok | (step < 1) | (jnp.arange(vocab) == psg.EOS)

    def port_fn(step, tokens):
        last = tokens[:, :, step]
        ok = (torch.arange(vocab) % 2)[None, None, :] == (last[..., None] % 2)
        return ok | (step < 1) | (torch.arange(vocab) == psg.EOS)
    return jax_fn, port_fn


AUX_CASES = {
    "sampling": dict(strategy="sampling", sampling_topp=0.7),
    "diverse_beam": dict(strategy="diverse_beam", diversity_num_groups=2,
                         diversity_strength=0.7),
    "diverse_siblings": dict(strategy="diverse_siblings",
                             diversity_rate=0.6),
    "prefix": dict(),
    "prefix_allowed_fn": dict(),
    "ensemble": dict(),
}


@pytest.mark.parametrize("case", sorted(AUX_CASES))
def test_beam_search_aux_matches_jax(setup, case):
    cfg, sets = setup
    bs = dict(beam=4, max_len=10, **AUX_CASES[case])
    n = 2 if case.startswith("ensemble") else 1
    jv = [s[0] for s in sets[:n]]
    jtap = [s[1][0] for s in sets[:n]]
    jpad = [s[1][1] for s in sets[:n]]
    pdec = [getattr(s[2], WHICH) for s in sets[:n]]
    ptap = [s[3][0] for s in sets[:n]]
    ppad = [s[3][1] for s in sets[:n]]
    jkw, pkw = {}, {}
    if case == "prefix":
        prefix = np.array([[7, 9], [5, 1], [12, 4]], np.int32)   # 1 = PAD
        jkw["prefix_tokens"] = jnp.asarray(prefix)
        pkw["prefix_tokens"] = t(prefix).long()
    if case == "prefix_allowed_fn":
        jkw["prefix_allowed_fn"], pkw["prefix_allowed_fn"] = _allowed_mask(
            cfg.tgt_vocab_size)
    if case.startswith("sampling"):
        rng = jax.random.PRNGKey(3)
        jkw["rng"], pkw["noise"] = rng, jax_gumbel(rng)
    ref = jsg.beam_search_aux(jv if n > 1 else jv[0], cfg, WHICH,
                              jtap if n > 1 else jtap[0],
                              jpad if n > 1 else jpad[0],
                              jsg.BeamConfig(**bs), **jkw)
    got = psg.beam_search_aux(pdec if n > 1 else pdec[0],
                              ptap if n > 1 else ptap[0],
                              ppad if n > 1 else ppad[0],
                              psg.BeamConfig(**bs), **pkw)
    lengths = np.asarray(ref["lengths"])
    assert np.array_equal(got["lengths"].numpy(), lengths)
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    close(got["scores"], ref["scores"])
    close(got["pos_scores"], ref["pos_scores"])
    assert lengths.min() < 11 and len(set(lengths.ravel().tolist())) > 1
    if case == "prefix":
        toks = got["tokens"].numpy()
        assert (toks[0, :, 1:3] == [7, 9]).all() and (toks[1, :, 1] == 5).all()


# --------------------------------------------------------------------------
# lexical constraints
# --------------------------------------------------------------------------

CONSTRAINTS = [[[5, 6], [9]], [[5, 6, 7], [6, 8], [5, 6, 7]],
               [[4], [4, 5], [5, 4]], []]


@pytest.mark.parametrize("representation", ["ordered", "unordered"])
def test_constraint_tables_match_jax(representation):
    packed = pc.pack_constraints(CONSTRAINTS)
    assert np.array_equal(packed, jc.pack_constraints(CONSTRAINTS))
    for row, sent in zip(packed, CONSTRAINTS):
        assert pc.unpack_constraints(row) == jc.unpack_constraints(row)
    ref = jc.build_constraint_tables(packed, 13, representation)
    got = pc.build_constraint_tables(packed, 13, representation)
    assert (got.C, got.E, got.P) == (ref.C, ref.E, ref.P)
    assert sorted(got.arrays) == sorted(ref.arrays)
    for name, arr in ref.arrays.items():
        assert np.array_equal(got.arrays[name].numpy(), np.asarray(arr)), name


@pytest.mark.parametrize("representation", ["ordered", "unordered"])
def test_constraint_state_machines_match_jax(representation):
    """Every sentence's beams driven by the same seeded token streams (the
    constraint tokens and others) through both packages' advance, bank and
    finished, step by step."""
    packed = pc.pack_constraints(CONSTRAINTS)
    ref_tb = jc.build_constraint_tables(packed, 13, representation)
    got_tb = pc.build_constraint_tables(packed, 13, representation)
    b, k = len(CONSTRAINTS), 6
    r = np.random.RandomState(2)
    streams = r.choice([4, 5, 6, 7, 8, 9, 10], size=(12, b, k))
    jnode, jmet = jc.init_constraint_state(ref_tb, b, k)
    pnode, pmet = pc.init_constraint_state(got_tb, b, k)
    for tok in streams:
        if representation == "ordered":
            jnode = jax.vmap(jax.vmap(jc._advance_ordered, (None, 0, 0)))(
                ref_tb.arrays, jnode, jnp.asarray(tok))
            pnode = pc._advance_ordered(got_tb.arrays, pnode,
                                        t(tok).long())
            pbank = pnode + 1
            jbank = jnode + 1
        else:
            jnode, jmet = jax.vmap(jax.vmap(
                jc._advance_unordered, (None, 0, 0, 0)))(
                ref_tb.arrays, jnode, jmet, jnp.asarray(tok))
            pnode, pmet = pc._advance_unordered(got_tb.arrays, pnode, pmet,
                                                t(tok).long())
            jbank = jax.vmap(jax.vmap(lambda tb, n, m: jc._state_unordered(
                tb, n, m)[0], (None, 0, 0)))(ref_tb.arrays, jnode, jmet)
            pbank = pc._state_unordered(got_tb.arrays, pnode, pmet)[0]
            assert np.array_equal(pmet.numpy(), np.asarray(jmet))
        assert np.array_equal(pnode.numpy(), np.asarray(jnode))
        assert np.array_equal(pbank.numpy(), np.asarray(jbank))
        assert np.array_equal(
            pc.constraints_finished(got_tb, pnode, pmet).numpy(),
            np.asarray(jc.constraints_finished(ref_tb, jnode, jmet)))


@pytest.mark.parametrize("representation", ["ordered", "unordered"])
def test_constrained_decode_matches_jax(setup, representation):
    cfg, sets = setup
    v, (jtap, jpad), model, (ptap, ppad) = sets[0]
    cons = [[[7, 9], [12]], [[5]], [[12, 4, 6], [8]]]
    packed = pc.pack_constraints(cons)
    ref_tb = jc.build_constraint_tables(packed, cfg.tgt_vocab_size,
                                        representation)
    got_tb = pc.build_constraint_tables(packed, cfg.tgt_vocab_size,
                                        representation)
    bs = dict(beam=4, max_len=16)
    ref = jsg.beam_search_aux(v, cfg, WHICH, jtap, jpad,
                              jsg.BeamConfig(**bs), constraints=ref_tb)
    got = psg.beam_search_aux(getattr(model, WHICH), ptap, ppad,
                              psg.BeamConfig(**bs), constraints=got_tb)
    assert np.array_equal(got["lengths"].numpy(), np.asarray(ref["lengths"]))
    assert np.array_equal(got["tokens"].numpy(), np.asarray(ref["tokens"]))
    close(got["scores"], ref["scores"])
    close(got["pos_scores"], ref["pos_scores"])
    # EOS is banned until a beam's phrases are out: a hypothesis that
    # ended before the bound holds them
    toks, lens = got["tokens"].numpy(), got["lengths"].numpy()
    ended = 0
    for i, sent in enumerate(cons):
        for j in range(bs["beam"]):
            if lens[i, j] > bs["max_len"]:
                continue
            ended += 1
            hyp = " " + " ".join(map(str, toks[i, j, 1:1 + lens[i, j]])) + " "
            for c in sent:
                assert " " + " ".join(map(str, c)) + " " in hyp, (i, c, hyp)
    assert ended > 0
