"""Model presets of the port (counterpart of cmtcoop_tpu/configs)."""
