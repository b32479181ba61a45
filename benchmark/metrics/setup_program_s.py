"""Seconds of set-up inside the program's ``setup.*`` spans (pipelines,
decoders and their tables, K1's library with any compile), their union so
that nested spans count once: the part of ``setup_s`` that the port holds."""

from benchmark import spans


def read(trace):
    return spans.union_s(trace, "setup.")
