"""Device ms a call inside the span ``rx.chase`` (a HARQ round's sums of the
failed copies' LLRs, their decodes and each codeword's pick).  Nothing where
the trace holds no such span: a program without the round."""


def read(trace):
    s = trace.span_device_s("rx.chase")
    return None if s is None else s * 1e3
