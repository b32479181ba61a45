"""Device ms a call inside the span ``demod.equalize`` (the LTS channel
estimate, the noise variance, pilot tracking where the configuration has it,
and the MMSE equaliser with each carrier's noise variance)."""


def read(trace):
    s = trace.span_device_s("demod.equalize")
    return None if s is None else s * 1e3
