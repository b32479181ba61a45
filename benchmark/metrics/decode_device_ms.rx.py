"""Device ms a call inside the span ``rx.decode`` (in a HARQ round, the
decode of every copy alone: one launch of the decoder).  Nothing where the
trace holds no such span."""


def read(trace):
    s = trace.span_device_s("rx.decode")
    return None if s is None else s * 1e3
