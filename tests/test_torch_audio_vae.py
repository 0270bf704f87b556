"""The port's 1-D mel VAE (`lumina_t2x_tpu_torch/codecs/vae1d.py`) against
the JAX package's (`lumina_t2x_tpu/codecs/vae1d.py`): both layouts at ch 32
(the app's random VAE: ch_mult (1, 2), kernel 3, one resnet, every level
but the last downsampling; Make-An-Audio-2's: kernel 5, downsampling only at
level 0, two resnets, here with per-level attention at level 1 as well),
the VQ variant, and the reference-layout importers. The port's modules are
built from a seed with every parameter perturbed by 0.05 * N(0, 1) (biases
and norm gains off their initial values); their state dicts, which are in
the reference's CompVis layout, reach the JAX models through the JAX
package's importers, and `core/checkpoint.vae1d_state_dict_from_jax` must
carry the JAX trees back unchanged.

fp32 on the CPU, inputs from numpy. Bar: atol 2e-4 / rtol 2e-3.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lumina_t2x_tpu.codecs import vae1d as jv
from lumina_t2x_tpu_torch.codecs import vae1d as tv
from lumina_t2x_tpu_torch.core.checkpoint import vae1d_state_dict_from_jax

ATOL, RTOL = 2e-4, 2e-3
MEL, EMBED, Z, T = 16, 4, 4, 12
LAYOUTS = {
    "app": dict(ch=32, ch_mult=(1, 2), num_res_blocks=1),
    "maa2": dict(ch=32, ch_mult=(1, 2), num_res_blocks=2, kernel_size=5, down_layers=(0,),
                 attn_layers=(1,)),
}


def _perturbed(model, seed):
    torch.manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape))
    return model.eval()


def _importer_arch(layout):
    arch = LAYOUTS[layout]
    return dict(ch_mult=arch["ch_mult"], num_res_blocks=arch["num_res_blocks"],
                attn_layers=arch.get("attn_layers", ()), down_layers=arch.get("down_layers"))


@functools.lru_cache(maxsize=None)
def _kl_pair(layout):
    arch = dict(mel_bins=MEL, embed_dim=EMBED, z_channels=Z, **LAYOUTS[layout])
    tmodel = _perturbed(tv.AutoencoderKL1D(**arch), 3)
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params = jv.import_autoencoder_kl_1d_weights(sd, **_importer_arch(layout))
    return jv.AutoencoderKL1D(**arch), params, tmodel


def _mel(seed, b=2, t=T):
    return np.random.default_rng(seed).standard_normal((b, MEL, t)).astype(np.float32)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_kl_encode_decode_and_sample_match_jax(layout):
    jmodel, params, tmodel = _kl_pair(layout)
    x = _mel(4)
    v = {"params": params}
    ref_moments = np.asarray(jax.jit(functools.partial(jmodel.apply, method=jmodel.encode_moments))(
        v, jnp.asarray(x)))
    rng = jax.random.PRNGKey(9)
    ref_rec = jax.jit(lambda v, x, r: jmodel.apply(v, x, r)[0])(v, jnp.asarray(x), rng)
    noise = jax.random.normal(rng, (2, EMBED, ref_moments.shape[-1]))
    with torch.no_grad():
        moments = tmodel.encode_moments(torch.from_numpy(x))
        rec, posterior = tmodel(torch.from_numpy(x), torch.from_numpy(np.array(noise)))
        decoded = tmodel.decode(posterior.mode())
    assert moments.shape == (2, 2 * EMBED, T // 2)
    np.testing.assert_allclose(moments.numpy(), ref_moments, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_rec), atol=ATOL, rtol=RTOL)
    ref_decoded = jax.jit(functools.partial(jmodel.apply, method=jmodel.decode))(
        v, jnp.asarray(ref_moments[:, :EMBED]))
    assert decoded.shape == x.shape
    np.testing.assert_allclose(decoded.numpy(), np.asarray(ref_decoded), atol=ATOL, rtol=RTOL)


def test_vq_model_matches_jax():
    arch = dict(mel_bins=MEL, embed_dim=EMBED, n_embed=24, ch=32, ch_mult=(1, 2),
                num_res_blocks=1, z_channels=Z)
    tmodel = _perturbed(tv.VQModel1D(**arch), 5)
    # a codebook on the encoder's scale, so that the nearest codes differ per frame
    with torch.no_grad():
        tmodel.quantize.embedding.weight.copy_(torch.randn(24, EMBED))
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    params = jv.import_vq_model_1d_weights(sd, ch_mult=(1, 2), num_res_blocks=1)
    back = vae1d_state_dict_from_jax(params)
    assert all(torch.equal(back[k], v) for k, v in tmodel.state_dict().items())
    jmodel = jv.VQModel1D(**arch)
    x = _mel(7)
    ref_rec, ref_idx, ref_loss = jax.jit(jmodel.apply)({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        rec, idx, loss = tmodel(torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    assert len(np.unique(idx.numpy())) > 1
    np.testing.assert_allclose(float(loss), float(ref_loss), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(rec.numpy(), np.asarray(ref_rec), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("kind", ["kl", "vq"])
def test_reference_importers_round_trip_the_jax_importers(kind):
    """The reference (CompVis) state dict that the JAX importers read loads
    into the port through its importers (an LDM checkpoint's
    `first_stage_model.` prefix and loss entries are dropped), and the JAX
    trees come back through `vae1d_state_dict_from_jax` unchanged."""
    _, params, tmodel = _kl_pair("maa2")
    sd = {k: v.numpy() for k, v in tmodel.state_dict().items()}
    arch = _importer_arch("maa2")
    if kind == "vq":
        sd["quantize.embedding.weight"] = np.ones((24, EMBED), np.float32)
        jtree = jv.import_vq_model_1d_weights(sd, **arch)
        tsd = tv.import_vq_model_1d_weights(sd)
        assert torch.equal(tsd.pop("quantize.embedding.weight"), torch.ones(24, EMBED))
    else:
        ldm = {f"first_stage_model.{k}": v for k, v in sd.items()}
        ldm["first_stage_model.loss.logvar"] = np.zeros(())
        ldm["model.diffusion_model.proj_in.weight"] = np.zeros((2, 2), np.float32)
        jtree = jv.import_autoencoder_kl_1d_weights(ldm, **arch)
        tsd = tv.import_autoencoder_kl_1d_weights(ldm)
    assert set(tsd) == set(tmodel.state_dict())
    back = vae1d_state_dict_from_jax(jtree)
    for key, value in tsd.items():
        assert torch.equal(value, back[key]), key


def test_make_an_audio_2_vae_is_the_shipped_config():
    """Every weight of the port's Make-An-Audio-2 VAE is one that the JAX
    importer reads for the shipped config, and nothing is left over."""
    vae = tv.make_an_audio_2_vae()
    ref = jv.make_an_audio_2_vae()
    sd = {k: v.numpy() for k, v in vae.state_dict().items()}
    tree = jv.import_autoencoder_kl_1d_weights(
        sd, ch_mult=ref.ch_mult, num_res_blocks=ref.num_res_blocks,
        attn_layers=ref.attn_layers, down_layers=ref.down_layers)
    assert sum(v.size for v in jax.tree.leaves(tree)) == sum(v.size for v in sd.values())
    assert vae.encoder.conv_in.kernel_size == (5,) and len(vae.encoder.down) == 3
    assert hasattr(vae.encoder.down[0], "downsample")
    assert not hasattr(vae.encoder.down[1], "downsample")
    assert hasattr(vae.decoder.up[1], "upsample") and not hasattr(vae.decoder.up[0], "upsample")
