"""Host us a call inside the span ``ldpc.decode_batch`` (input conversion,
the cached decoder's look-up, checks, output allocation and K1's launch),
the median over the span's ring, which ends on the untraced window's
calls."""

from benchmark import spans


def read(trace):
    s = spans.host_median_s(trace, "ldpc.decode_batch")
    return None if s is None else s * 1e6
