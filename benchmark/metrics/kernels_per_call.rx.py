"""Device kernels, copies and memsets a call of an RX chain: the work of the
host's dispatch.  Nothing where the trace holds no RX span."""


def read(trace):
    if "rx.sync" not in trace.spans or not trace.ops:
        return None
    return len(trace.ops) / trace.calls
