"""PyTorch + CUDA port of `lumina_t2x_tpu` for NVIDIA Hopper (H100).

Keeps the JAX package's module layout and public names so that each module's
counterpart is easy to find: `ops/`, `models/`, `core/checkpoint.py`,
`transport/`, `pipelines/`, `cli/`, `utils/`. The attention kernels are hand-written CUDA C++
in `csrc/`, built at first use (`ops/flash_attention.py`). This package
never imports JAX.
"""
