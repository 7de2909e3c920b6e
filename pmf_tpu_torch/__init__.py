"""pmf_tpu_torch — the PyTorch and CUDA port of pmf_tpu for NVIDIA Hopper.

The package mirrors pmf_tpu's layout (models/, ops/, data/, metrics/,
tools/, config/). It imports torch and never jax, flax or pmf_tpu; the two
Pallas kernels of pmf_tpu are hand-written CUDA kernels here (csrc/), each
with a plain PyTorch version beside it in ops/.
"""
