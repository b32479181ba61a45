"""Host ms a call inside the span ``demod.equalize`` (the LTS estimate to
the equalised symbols and their noise variance): its dispatch at the served
pace, the median over the span's ring, which ends on the untraced window's
calls."""

from benchmark import spans


def read(trace):
    s = spans.host_median_s(trace, "demod.equalize")
    return None if s is None else s * 1e3
