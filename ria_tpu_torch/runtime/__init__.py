"""runtime stage of the port (mirrors ria_tpu.runtime): the headless monitor."""
