"""sim stage of the port (mirrors ria_tpu.sim): the Watterson channel and the
dual-station simulator."""
