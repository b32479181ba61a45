"""Device ms a call inside the span ``sync.fine``, the part of ``rx.sync``
after the coarse argmax (peak refinement, CFAR median, down-chirp window and
decision; LTS correlation and fine CFO in the Schmidl-Cox search)."""


def read(trace):
    s = trace.span_device_s("sync.fine")
    return None if s is None else s * 1e3
