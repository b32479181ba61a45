"""runtime stage of the port (mirrors ria_tpu.runtime): the headless monitor,
the TCP host interface, the native runtime library, audio, CAT and the
operator console."""
