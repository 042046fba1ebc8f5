"""The benchmark of cutie_tpu_torch (see vosbench/README.md)."""
