"""K1's share of its roofline: the least time its launches could take
(``roofline.py``, on the traced calls' own codeword-iterations) over the
time the profiler gives K1 (kernel ``ldpc_bp_kernel``), in %.  Nothing
where the trace holds no K1 launch or the card is not in the table of
peaks."""

from benchmark import roofline


def read(trace):
    launches = trace.ops_named("ldpc_bp_kernel")
    peak = roofline.peaks(trace.kind)
    if not launches or peak is None or len(launches) != len(trace.iterations):
        return None
    w = trace.work
    bound = sum(roofline.decode_bound_s(w["codewords"], its, w["n"], w["k"], w["m"],
                                        w["edges"], peak)[0] for its in trace.iterations)
    kernel = sum(e - s for _, s, e in launches) / 1e6
    return 100.0 * bound / kernel
