"""Codecs between pixels and the model's latents (counterpart of
`lumina_t2x_tpu/codecs`): the SD-VAE (`vae.py`)."""
