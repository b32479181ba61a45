"""Device ms a call inside the span ``demod.demap`` (the per-carrier EMA
instability chain and the soft demapper, to the demodulator's LLRs)."""


def read(trace):
    s = trace.span_device_s("demod.demap")
    return None if s is None else s * 1e3
