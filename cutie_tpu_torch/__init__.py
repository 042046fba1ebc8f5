"""cutie_tpu_torch: the PyTorch/CUDA port of cutie_tpu for NVIDIA Hopper.

The package mirrors cutie_tpu's module layout so that each port module can be
read beside its JAX counterpart. It imports torch and numpy only.
"""
