"""Device ms a call inside the span ``sync.coarse`` (in the light
preamble's LTS search: the complex cast, the correlation's FFT pair and
product, the sliding energy and the normalised correlation).  Nothing where
the trace holds no such span."""


def read(trace):
    s = trace.span_device_s("sync.coarse")
    return None if s is None else s * 1e3
