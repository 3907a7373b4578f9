"""The HiFi-GAN vocoder of s2st_tpu_torch against s2st_tpu, fp32 on the CPU.

- One seeded torch checkpoint in fairseq's layout (``weight_g`` /
  ``weight_v`` on every conv; ``{"generator": sd}`` or a bare state dict),
  loaded by JAX's ``load_torch_generator`` and the port's: the waveforms
  agree within atol 1e-5 at a narrow width, for ResBlock "1" and "2".
- ``state_dict_from_jax`` inverts JAX's layout (the transposed conv's
  time flip included): JAX's parameters of that checkpoint give the
  port's state dict back exactly.
- Both packages' generate_waveform with ``--vocoder hifigan`` (config.yaml's
  ``vocoder:`` block) on rows that stop at different steps: the same
  features, and WAVs of hop * frames samples whose PCM16 values differ by
  at most one step (fp32 rounding before the 16-bit quantisation): both
  vocode the whole padded tensor, frames past each row's end included.
"""

import json
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2st_tpu.models import hifigan as jh
from s2st_tpu_torch.models import hifigan as ph
from tests._torch_port import one_thread  # noqa: F401
from tests.test_torch_serving_leftouts import (MAX_ITER, assert_same_features,
                                               run_both_clis, serving_setup,
                                               setup)  # noqa: F401

NARROW = dict(upsample_initial_channel=16, upsample_rates=[4, 2],
              upsample_kernel_sizes=[8, 4], resblock_kernel_sizes=[3, 5],
              resblock_dilation_sizes=[[1, 3], [1, 2]], num_mels=8,
              sampling_rate=16000)


def fairseq_checkpoint(path, model_cfg: dict, seed: int, bare=False):
    """A seeded HiFi-GAN state dict with every conv weight as weight_g /
    weight_v, saved with torch.save."""
    cfg = ph.HiFiGANConfig.from_json(model_cfg)
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, v in ph.HiFiGANGenerator(cfg).state_dict().items():
        if name.endswith(".weight"):
            sd[name[:-6] + "weight_v"] = torch.randn(
                v.shape, generator=gen) * 0.3
            sd[name[:-6] + "weight_g"] = torch.rand(
                (v.shape[0],) + (1,) * (v.dim() - 1), generator=gen) + 0.5
        else:
            sd[name] = torch.randn(v.shape, generator=gen) * 0.1
    torch.save(sd if bare else {"generator": sd}, path)
    return cfg


@pytest.mark.parametrize("resblock,bare", [("1", False), ("2", True)])
def test_generator_matches_jax(resblock, bare, tmp_path):
    model_cfg = dict(NARROW, resblock=resblock)
    cfg = fairseq_checkpoint(tmp_path / "g.pt", model_cfg, seed=7, bare=bare)
    jcfg = jh.HiFiGANConfig.from_json(model_cfg)
    jp = jh.load_torch_generator(str(tmp_path / "g.pt"), jcfg)
    model = ph.HiFiGANGenerator(cfg)
    sd = ph.load_torch_generator(str(tmp_path / "g.pt"), cfg)
    model.load_state_dict(sd)
    x = np.random.RandomState(1).randn(3, 13, 8).astype(np.float32)
    want = np.asarray(jh.synthesize(jp, jnp.asarray(x), jcfg))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 13 * 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    back = ph.state_dict_from_jax(jax.tree.map(np.asarray, jp), cfg)
    assert sorted(back) == sorted(sd)
    for name in sd:
        assert torch.equal(back[name], sd[name]), name


def test_cli_hifigan_matches_jax(setup, tmp_path):  # noqa: F811
    model_cfg = dict(NARROW, resblock="1")
    fairseq_checkpoint(tmp_path / "hifigan.pt", model_cfg, seed=9)
    (tmp_path / "hifigan.json").write_text(json.dumps(model_cfg))
    corpus, ckpt, _, thr = serving_setup(
        tmp_path, setup[0], seed=47, vocoder_block={
            "type": "hifigan", "checkpoint": tmp_path / "hifigan.pt",
            "config": tmp_path / "hifigan.json"})
    roots = run_both_clis(corpus, ckpt, tmp_path, "--vocoder", "hifigan",
                          "--max-iter", str(MAX_ITER),
                          "--eos-prob-threshold", str(thr))
    assert len(assert_same_features(roots)) > 1
    for path in sorted((roots["jax"] / "wav").iterdir()):
        frames = len(np.load(roots["jax"] / "feat" /
                             path.name.replace(".wav", ".npy")))
        pcm = []
        for root in (roots["jax"], roots["port"]):
            with wave.open(str(root / "wav" / path.name), "rb") as w:
                pcm.append(np.frombuffer(w.readframes(w.getnframes()),
                                         "<i2").astype(np.int32))
        assert len(pcm[0]) == len(pcm[1]) == 8 * frames, path.name
        assert np.abs(pcm[0] - pcm[1]).max() <= 1, path.name
        assert np.abs(pcm[0]).max() > 0


@pytest.mark.parametrize("chunk_frames,overlap", [(4, None), (5, 2)])
def test_streaming_matches_jax(chunk_frames, overlap, tmp_path):
    """``synthesize_streaming``: chunks padded by the receptive field (or
    a given overlap) and their interiors stitched, against JAX's on the
    same weights and mel, atol 1e-5; ``receptive_field_frames`` equal."""
    model_cfg = dict(NARROW, resblock="1")
    cfg = fairseq_checkpoint(tmp_path / "g.pt", model_cfg, seed=3)
    jcfg = jh.HiFiGANConfig.from_json(model_cfg)
    jp = jh.load_torch_generator(str(tmp_path / "g.pt"), jcfg)
    model = ph.HiFiGANGenerator(cfg)
    model.load_state_dict(ph.load_torch_generator(str(tmp_path / "g.pt"),
                                                  cfg))
    assert ph.receptive_field_frames(cfg) == jh.receptive_field_frames(jcfg)
    x = np.random.RandomState(5).randn(2, 13, 8).astype(np.float32)
    want = np.asarray(jh.synthesize_streaming(
        jp, jnp.asarray(x), jcfg, chunk_frames=chunk_frames,
        overlap=overlap))
    with torch.no_grad():
        got = ph.synthesize_streaming(model.eval(), torch.from_numpy(x),
                                      chunk_frames=chunk_frames,
                                      overlap=overlap).numpy()
    assert got.shape == want.shape == (2, 13 * 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
