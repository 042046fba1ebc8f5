"""The interactive GUI: the port's counterpart of cutie_tpu/gui/."""
