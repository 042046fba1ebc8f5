"""The offline dataset tools (the port's counterparts of scripts/data/*.py):
each runs as python -m cutie_tpu_torch.scripts.data.<name> with the
reference script's arguments, and reads and writes images through
utils/image_io.py instead of PIL."""
