"""Losses (counterpart of ``nerfstyle_tpu/losses``)."""
