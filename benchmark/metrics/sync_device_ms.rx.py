"""Device ms a call inside the span ``rx.sync`` (the chirp or Schmidl-Cox
search)."""


def read(trace):
    s = trace.span_device_s("rx.sync")
    return None if s is None else s * 1e3
