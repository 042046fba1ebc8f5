"""The plain reference of the benchmark: Cutie's streaming inference in plain
PyTorch (stream.py) over a frozen copy of the network (network/). It
imports nothing of the port (cutie_tpu_torch) and nothing of JAX."""
