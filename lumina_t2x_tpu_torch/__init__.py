"""PyTorch + CUDA port of `lumina_t2x_tpu` for NVIDIA Hopper (H100).

Keeps the JAX package's module layout and public names so that each module's
counterpart is easy to find: `ops/`, `models/`, `core/checkpoint.py`,
`codecs/`, `data/`, `transport/`, `pipelines/`, `cli/`, `utils/`. The
attention kernels are hand-written CUDA C++ in `csrc/`, built at first use
(`ops/flash_attention.py`); the image decoder's C++ is in `native/`. This
package never imports JAX.
"""
