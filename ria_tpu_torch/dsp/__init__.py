"""dsp stage of the port (mirrors ria_tpu.dsp)."""
