"""Codecs between pixels or text and the model's inputs (counterpart of
`lumina_t2x_tpu/codecs`): the SD-VAE (`vae.py`) and the caption encoder
(`text_encoders.py`)."""
