"""The port's SD-VAE (`lumina_t2x_tpu_torch/codecs/vae.py`) against the JAX
package's (`lumina_t2x_tpu/codecs/vae.py`): one diffusers-layout state dict,
built with numpy from a seed, goes to both, to JAX through
`import_autoencoder_kl_weights` and to the port through `load_state_dict`
and `load_vae` (`.safetensors` and `.pth`). Tiny configs of
`tests/test_vae.py` (ch 32, ch_mult (1, 2) and the factor-8 (1, 1, 2, 2), one
resnet per level), fp32 on the CPU. Bar: atol 2e-4 / rtol 2e-3.

The `cuda` test holds the card's decode against the CPU's; JAX is imported
at first use, so that it also runs where JAX is absent
(`pytest --noconftest -m cuda tests/test_torch_vae.py`).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

from lumina_t2x_tpu_torch.codecs import vae as tv
from lumina_t2x_tpu_torch.core.checkpoint import save_safetensors, vae_state_dict_from_jax

ATOL, RTOL = 2e-4, 2e-3
CONFIGS = {"f2": dict(ch_mult=(1, 2)), "f8": dict(ch_mult=(1, 1, 2, 2))}
# (image H, W) per shape kind; latents are the image over the config's factor
SHAPES = {"square": (32, 32), "non-square": (24, 40), "odd": (27, 19)}


class _Lazy:
    def __init__(self, module):
        self._module = module

    def __getattr__(self, name):
        return getattr(importlib.import_module(self._module), name)


jax = _Lazy("jax")
jnp = _Lazy("jax.numpy")
jv = _Lazy("lumina_t2x_tpu.codecs.vae")


def diffusers_sd(ch_mult, ch=32, num_res=1, z=4, quant=True, conv_attn=False, seed=0):
    """A diffusers-format AutoencoderKL state dict of numpy arrays: every
    tensor (GroupNorm gains and biases too) random from `seed`; attention
    projections as (c, c) linear or, with `conv_attn`, (c, c, 1, 1) conv
    weights."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, shape, scale):
        sd[name] = (scale * rng.standard_normal(shape)).astype(np.float32)

    def conv(name, i, o, k=3):
        put(f"{name}.weight", (o, i, k, k), 1.0 / np.sqrt(i * k * k))
        put(f"{name}.bias", (o,), 0.05)

    def gn(name, c):
        sd[f"{name}.weight"] = (1.0 + 0.1 * rng.standard_normal(c)).astype(np.float32)
        put(f"{name}.bias", (c,), 0.1)

    def resnet(pre, i, o):
        gn(f"{pre}.norm1", i)
        conv(f"{pre}.conv1", i, o)
        gn(f"{pre}.norm2", o)
        conv(f"{pre}.conv2", o, o)
        if i != o:
            conv(f"{pre}.conv_shortcut", i, o, k=1)

    def attn(pre, c):
        gn(f"{pre}.group_norm", c)
        for p in ("to_q", "to_k", "to_v", "to_out.0"):
            put(f"{pre}.{p}.weight", (c, c, 1, 1) if conv_attn else (c, c), 1.0 / np.sqrt(c))
            put(f"{pre}.{p}.bias", (c,), 0.05)

    def mid(pre, c):
        resnet(f"{pre}.resnets.0", c, c)
        attn(f"{pre}.attentions.0", c)
        resnet(f"{pre}.resnets.1", c, c)

    conv("encoder.conv_in", 3, ch)
    prev = ch
    for i, mult in enumerate(ch_mult):
        for j in range(num_res):
            resnet(f"encoder.down_blocks.{i}.resnets.{j}", prev, ch * mult)
            prev = ch * mult
        if i != len(ch_mult) - 1:
            conv(f"encoder.down_blocks.{i}.downsamplers.0.conv", prev, prev)
    mid("encoder.mid_block", prev)
    gn("encoder.conv_norm_out", prev)
    conv("encoder.conv_out", prev, 2 * z)
    if quant:
        conv("quant_conv", 2 * z, 2 * z, k=1)
        conv("post_quant_conv", z, z, k=1)
    conv("decoder.conv_in", z, prev)
    mid("decoder.mid_block", prev)
    for bi, i in enumerate(reversed(range(len(ch_mult)))):
        for j in range(num_res + 1):
            resnet(f"decoder.up_blocks.{bi}.resnets.{j}", prev, ch * ch_mult[i])
            prev = ch * ch_mult[i]
        if i != 0:
            conv(f"decoder.up_blocks.{bi}.upsamplers.0.conv", prev, prev)
    gn("decoder.conv_norm_out", prev)
    conv("decoder.conv_out", prev, 3)
    return sd


def _pair(cfg="f2", z=4, quant=True, conv_attn=False):
    """(JAX module, its params, the port's module) holding one state dict."""
    ch_mult = CONFIGS[cfg]["ch_mult"]
    sd = diffusers_sd(ch_mult, z=z, quant=quant, conv_attn=conv_attn)
    jmodel = jv.AutoencoderKL(ch=32, ch_mult=ch_mult, num_res_blocks=1, z_channels=z,
                              use_quant_conv=quant)
    params = jv.import_autoencoder_kl_weights(sd, ch_mult=ch_mult, num_res_blocks=1, ch=32)
    tmodel = tv.AutoencoderKL(ch=32, ch_mult=ch_mult, num_res_blocks=1, z_channels=z,
                              use_quant_conv=quant).eval()
    tmodel.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return jmodel, params, tmodel


def _apply(jmodel, params, method, *args):
    """A JAX VAE method, jitted (op-by-op dispatch costs seconds per shape)."""
    fn = jax.jit(functools.partial(jmodel.apply, method=getattr(jmodel, method)))
    return fn({"params": params}, *map(jnp.asarray, args))


def _factor(cfg):
    return 2 ** (len(CONFIGS[cfg]["ch_mult"]) - 1)


def _assert_close(got, ref):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_encode_moments_and_decode_match_jax(cfg, shape):
    jmodel, params, tmodel = _pair(cfg)
    h, w = SHAPES[shape]
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 3, h, w)).astype(np.float32)
    ref = _apply(jmodel, params, "encode_moments", x)
    with torch.no_grad():
        got = tmodel.encode_moments(torch.from_numpy(x))
    assert got.shape == ref.shape
    _assert_close(got, ref)
    f = _factor(cfg)
    z = rng.standard_normal((2, 4, h // f, w // f)).astype(np.float32)
    ref = _apply(jmodel, params, "decode", z)
    with torch.no_grad():
        got = tmodel.decode(torch.from_numpy(z))
    assert got.shape == (2, 3, (h // f) * f, (w // f) * f) == ref.shape
    _assert_close(got, ref)


@pytest.mark.parametrize("vae_type", ["ema", "sdxl", "sd3"])
def test_latents_match_jax(vae_type):
    """`encode_to_latent` with JAX's posterior noise handed over, and
    `decode_from_latent`; sd3 is the z=16 layout without quant convs."""
    sd3 = vae_type == "sd3"
    z_channels = 16 if sd3 else 4
    jmodel, params, tmodel = _pair("f2", z=z_channels, quant=not sd3)
    x = np.random.default_rng(2).uniform(-1, 1, (2, 3, 40, 24)).astype(np.float32)
    variables = {"params": params}
    rng = jax.random.PRNGKey(3)
    ref = jax.jit(functools.partial(jv.encode_to_latent, jmodel, vae_type=vae_type))(
        variables, jnp.asarray(x), rng)
    # the posterior's draw inside the JAX function: normal(rng, mean.shape)
    noise = np.array(jax.random.normal(rng, (2, z_channels, 20, 12)))
    with torch.no_grad():
        got = tv.encode_to_latent(tmodel, torch.from_numpy(x), torch.from_numpy(noise), vae_type)
    assert got.shape == (2, z_channels, 20, 12)
    _assert_close(got, ref)
    ref_img = jax.jit(functools.partial(jv.decode_from_latent, jmodel, vae_type=vae_type))(
        variables, ref)
    with torch.no_grad():
        got_img = tv.decode_from_latent(tmodel, got, vae_type)
    _assert_close(got_img, ref_img)


@pytest.mark.parametrize("dim", [1, -1])
def test_diagonal_gaussian_matches_jax(dim):
    """Mode, the clip of the log variance to [-30, 20], std, kl, and a
    sample with handed-over noise."""
    rng = np.random.default_rng(4)
    moments = rng.standard_normal((2, 8, 3, 8)).astype(np.float32) * 3
    moments[0, 4, 0, :2] = (-50.0, 50.0)  # log variances beyond the clip
    moments[1, 1, 1, 4:6] = (-50.0, 50.0)
    ref = jv.DiagonalGaussian(jnp.asarray(moments), axis=dim)
    got = tv.DiagonalGaussian(torch.from_numpy(moments), dim=dim)
    noise = rng.standard_normal(got.mean.shape).astype(np.float32)
    assert got.logvar.max().item() == 20.0 and got.logvar.min().item() == -30.0
    for name in ("mean", "logvar", "std"):
        _assert_close(getattr(got, name), getattr(ref, name))
    _assert_close(got.mode(), ref.mode())
    _assert_close(got.kl(), ref.kl())
    _assert_close(got.sample(torch.from_numpy(noise)),
                  ref.mean + ref.std * jnp.asarray(noise))
    g = torch.Generator().manual_seed(0)
    drawn = got.sample(g)
    assert drawn.shape == got.mean.shape
    assert torch.equal(drawn, got.sample(torch.Generator().manual_seed(0)))


@pytest.mark.parametrize("layout", ["linear", "conv1x1"])
def test_attention_weights_load_as_linear_or_1x1_conv(layout):
    jmodel, params, tmodel = _pair("f2", conv_attn=layout == "conv1x1")
    assert tmodel.decoder.mid_block.attentions[0].to_q.weight.shape == (64, 64)
    z = np.random.default_rng(5).standard_normal((1, 4, 6, 5)).astype(np.float32)
    ref = _apply(jmodel, params, "decode", z)
    with torch.no_grad():
        _assert_close(tmodel.decode(torch.from_numpy(z)), ref)


@pytest.mark.parametrize("fmt", ["safetensors", "pth"])
def test_load_vae_reads_the_architecture_and_weights(tmp_path, fmt):
    """`load_vae` reads the architecture off the file and loads every
    parameter; its decode equals the JAX package's."""
    sd = diffusers_sd(CONFIGS["f8"]["ch_mult"], seed=6)
    tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
    path = str(tmp_path / f"vae.{fmt}")
    if fmt == "safetensors":
        save_safetensors(tensors, path)
    else:
        torch.save({"state_dict": tensors}, path)
    vae = tv.load_vae(path)
    assert tv.architecture(tensors) == dict(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1,
                                            z_channels=4, out_channels=3, use_quant_conv=True)
    assert not vae.training and vae.use_quant_conv
    for k, v in vae.state_dict().items():
        assert torch.equal(v, tensors[k]), k
    jmodel = jv.AutoencoderKL(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1)
    params = jv.import_autoencoder_kl_weights(sd, ch_mult=(1, 1, 2, 2), num_res_blocks=1, ch=32)
    z = np.random.default_rng(7).standard_normal((1, 4, 4, 6)).astype(np.float32)
    ref = jax.jit(functools.partial(jv.decode_from_latent, jmodel, vae_type="sdxl"))(
        {"params": params}, jnp.asarray(z))
    with torch.no_grad():
        _assert_close(tv.decode_from_latent(vae, torch.from_numpy(z), "sdxl"), ref)


def test_load_vae_reads_the_sd3_layout(tmp_path):
    sd = diffusers_sd((1, 2), z=16, quant=False, seed=8)
    path = str(tmp_path / "sd3.safetensors")
    save_safetensors({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    vae = tv.load_vae(path)
    assert vae.z_channels == 16 and not vae.use_quant_conv
    assert not hasattr(vae, "quant_conv") and not hasattr(vae, "post_quant_conv")


@pytest.mark.parametrize("layout", ["f2", "f8", "sd3"])
def test_vae_state_dict_from_jax_round_trip(layout):
    """diffusers dict -> `import_autoencoder_kl_weights` ->
    `vae_state_dict_from_jax` gives the dict back exactly."""
    sd3 = layout == "sd3"
    ch_mult = CONFIGS["f2" if sd3 else layout]["ch_mult"]
    sd = diffusers_sd(ch_mult, z=16 if sd3 else 4, quant=not sd3, seed=9)
    params = jv.import_autoencoder_kl_weights(sd, ch_mult=ch_mult, num_res_blocks=1, ch=32)
    back = vae_state_dict_from_jax(jax.tree.map(np.asarray, params))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(back[k].numpy(), v, err_msg=k)


def test_bf16_vae_keeps_fp32_islands():
    """With dtype bf16, convolutions compute in bf16 while GroupNorm returns
    fp32 (flax promotes to its fp32 params); the decode stays close to
    JAX's bf16 decode."""
    _, params, t32 = _pair("f2")
    jmodel = jv.AutoencoderKL(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype=jnp.bfloat16)
    t16 = tv.AutoencoderKL(ch=32, ch_mult=(1, 2), num_res_blocks=1, dtype=torch.bfloat16).eval()
    t16.load_state_dict(t32.state_dict())
    assert all(p.dtype == torch.float32 for p in t16.parameters())
    x = torch.randn(1, 64, 4, 4).to(torch.bfloat16)
    assert t16.decoder.mid_block.resnets[0].norm1(x).dtype == torch.float32
    z = np.random.default_rng(10).standard_normal((1, 4, 6, 6)).astype(np.float32)
    ref = np.asarray(_apply(jmodel, params, "decode", z), np.float32)
    with torch.no_grad():
        got = t16.decode(torch.from_numpy(z))
    assert got.dtype == torch.bfloat16
    rel = np.linalg.norm(got.float().numpy() - ref) / np.linalg.norm(ref)
    assert rel < 2e-2


def test_profile_groups_sort_the_decode_kernels():
    """`pipelines/profile_class_cond.py` files the decode's kernels (names
    from a card profile) under their groups."""
    from lumina_t2x_tpu_torch.pipelines.profile_class_cond import VAE_GROUPS
    from lumina_t2x_tpu_torch.pipelines.profile_train_step import _group

    for name, group in (
            ("sm80_xmma_fprop_implicit_gemm_f32f32_f32f32_f32_nchwkcrs_nchw", "cuDNN convolutions"),
            ("sm90_xmma_fprop_implicit_gemm_f32f32_tf32f32_f32_nhwckrsc_nhwc", "cuDNN convolutions"),
            ("void cudnn::engines_precompiled::nchwToNhwcKernel<float, float, float>",
             "cuDNN layout transforms"),
            ("void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float>(long)",
             "GroupNorm statistics"),
            ("sm80_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x8", "cuBLAS GEMMs"),
            ("void at::native::vectorized_elementwise_kernel<4, silu_kernel>", "elementwise")):
        assert _group(name, VAE_GROUPS) == group, name


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card's decode with the CPU's")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_decode_matches_cpu(cuda_device):
    """fp32 decode and encode on the card against the CPU's, cuDNN's TF32
    convolutions off (fp32 sums in another order only)."""
    sd = {k: torch.from_numpy(v) for k, v in diffusers_sd((1, 1, 2, 2), seed=11).items()}
    cpu = tv.AutoencoderKL(**tv.architecture(sd)).eval()
    cpu.load_state_dict(sd)
    card = tv.AutoencoderKL(**tv.architecture(sd), device=cuda_device).eval()
    card.load_state_dict(sd)
    g = torch.Generator().manual_seed(0)
    z = torch.randn(2, 4, 12, 10, generator=g)
    x = torch.rand(2, 3, 64, 48, generator=g) * 2 - 1
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            pairs = [(card.decode(z.to(cuda_device)).cpu(), cpu.decode(z)),
                     (card.encode_moments(x.to(cuda_device)).cpu(), cpu.encode_moments(x))]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    for got, ref in pairs:
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=ATOL, rtol=RTOL)
