"""sim stage of the port (mirrors ria_tpu.sim): the Watterson channel, the
dual-station simulator and the threaded continuous simulator."""
