"""The text-to-image slice from prompts: captions through the port's caption
encoder into the sampler (`pipelines/sample_lib.build_t2i_sample_fn`, the
sampler CLI's `--text_encoder`, the served worker's `text_encode_fn` and
`vae_decode_fn` hooks), against the JAX package's `DecoderTextEncoder.encode`
and `build_t2i_sample_fn` from the same noise.

Tiny pieces of the other port tests: Gemma (hidden 32) with the
character-level tokenizer, NextDiT (dim 64, 2 layers, caption dim 32,
qk-norm, perturbed weights). fp32 on the CPU; bar atol 2e-4 / rtol 2e-3.
"""

import numpy as np
import torch

from lumina_t2x_tpu_torch.codecs import text_encoders as tte
from lumina_t2x_tpu_torch.pipelines import demo as t_demo
from lumina_t2x_tpu_torch.pipelines import sample as t_sample
from lumina_t2x_tpu_torch.pipelines import sample_lib as t_sl

from test_torch_next_dit import _pair
from test_torch_sampler import _jax_trajectory, _port_trajectory
from test_torch_text_encoders import encoders, save_gemma_dir

ATOL, RTOL = 2e-4, 2e-3
PROMPTS = ["a red fox in the snow", "two boats on a lake at sunrise"]


def test_sampler_from_prompts_matches_jax():
    """Prompts plus as many empty captions (CFG's unconditional half), the
    sampler CLI's recipe, through both encoders and both samplers."""
    jmodel, params, tmodel = _pair()
    jenc, tenc = encoders("char", max_length=256)
    jcap, jmask = jenc.encode(PROMPTS + [""] * len(PROMPTS))
    tcap, tmask = tenc.encode(PROMPTS + [""] * len(PROMPTS))
    assert tmask.sum(dim=1).tolist() == [22, 31, 1, 1]  # <bos> + characters; <bos> alone
    assert tcap.shape == (4, 32, 32)
    z = np.random.default_rng(8).standard_normal((2, 4, 16, 16)).astype(np.float32)
    ref = _jax_trajectory(jmodel, params, z, np.asarray(jcap), np.asarray(jmask), 128, 128, 4)
    got = _port_trajectory(tmodel, z, tcap.numpy(), tmask.numpy(), 128, 128, 4)
    assert got.shape == (2, 4, 16, 16) and np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=RTOL)


def _capture_sampler_inputs(monkeypatch):
    seen = []
    build = t_sl.build_t2i_sample_fn

    def building(*args, **kwargs):
        fn = build(*args, **kwargs)

        def sample(z, cap_feats, cap_mask):
            seen.append((cap_feats.clone(), cap_mask.clone()))
            return fn(z, cap_feats, cap_mask)

        return sample

    monkeypatch.setattr(t_sl, "build_t2i_sample_fn", building)
    monkeypatch.setattr(t_sample, "build_t2i_sample_fn", building)
    return seen


def test_sample_cli_feeds_the_encoder_features(tmp_path, monkeypatch, capsys):
    path = save_gemma_dir(tmp_path / "gemma")
    captions = tmp_path / "prompts.txt"
    captions.write_text("\n".join(PROMPTS) + "\n")
    seen = _capture_sampler_inputs(monkeypatch)
    manifest = t_sample.main(["--model", "NextDiT_Tiny_patch2", "--qk_norm", "--text_encoder",
                              path, "--caption_path", str(captions), "--device", "cpu",
                              "--precision", "fp32", "--resolution", "1:128x128",
                              "--num_sampling_steps", "2", "--image_save_path",
                              str(tmp_path / "out")])
    assert "encoded 4 captions (32 tokens)" in capsys.readouterr().out
    assert manifest["args"]["cap_feat_dim"] == 32 and manifest["caption_tokens"] == [22, 31, 1, 1]
    assert len(manifest["items"]) == 2 and len(seen) == 1
    enc = tte.DecoderTextEncoder.from_pretrained(path, dtype=torch.float32, device="cpu")
    ref, ref_mask = enc.encode(PROMPTS + [""] * len(PROMPTS))
    assert torch.equal(seen[0][1], ref_mask) and torch.equal(seen[0][0], ref)
    # --debug ignores the encoder, as in JAX: random features of --cap_feat_dim
    seen.clear()
    t_sample.main(["--model", "NextDiT_Tiny_patch2", "--debug", "--text_encoder", path,
                   "--cap_feat_dim", "32", "--device", "cpu", "--precision", "fp32",
                   "--resolution", "1:128x128", "--num_sampling_steps", "2",
                   "--image_save_path", str(tmp_path / "debug")])
    assert seen[0][1].shape == (2, 32) and bool(seen[0][1].all())


def test_worker_hooks_reach_the_sampler(monkeypatch):
    _, _, tmodel = _pair()
    _, tenc = encoders("char", max_length=256)
    seen = _capture_sampler_inputs(monkeypatch)
    asked, decoded = [], []

    def text_encode_fn(captions):
        asked.append(list(captions))
        return tenc.encode(captions)

    def vae_decode_fn(latents):
        decoded.append(latents.shape)
        return torch.tanh(latents[:, :3].repeat_interleave(8, -1).repeat_interleave(8, -2))

    worker = t_demo.InferenceWorker(tmodel, text_encode_fn=text_encode_fn,
                                    vae_decode_fn=vae_decode_fn, cap_feat_dim=32, device="cpu")
    req = t_demo.InferenceRequest(cap="a red fox", neg_cap="", resolution="128x128",
                                  num_sampling_steps=2)
    out = worker.infer(req)
    assert not isinstance(out, t_demo.ModelFailure), out.error
    assert asked == [["a red fox", ""]] and decoded == [(1, 4, 16, 16)]
    ref, ref_mask = tenc.encode(["a red fox", ""])
    assert torch.equal(seen[-1][0], ref) and torch.equal(seen[-1][1], ref_mask)
    assert out["image"].shape == (1, 3, 128, 128) and out["image"].dtype == np.uint8
    assert t_demo.result_to_image(out).shape == (128, 128, 3)
    # without hooks: the hashed pseudo-features and a latent preview
    plain = t_demo.InferenceWorker(tmodel, cap_feat_dim=32, device="cpu").infer(req)
    assert "image" not in plain and seen[-1][1].shape == (2, 32)
