"""protocol stage of the port (mirrors ria_tpu.protocol): host copies of the
ARQ, the connection state machine and the file-transfer controller."""
