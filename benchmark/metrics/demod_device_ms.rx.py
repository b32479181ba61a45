"""Device ms a call inside the span ``rx.demod`` (frame slice, demodulation,
deinterleave)."""


def read(trace):
    s = trace.span_device_s("rx.demod")
    return None if s is None else s * 1e3
