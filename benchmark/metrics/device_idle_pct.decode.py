"""Share of the served loop's time in which no kernel, copy or memset
runs: the traced calls' device-busy seconds a call against the seconds a
call of the untraced window, in %."""


def read(trace):
    if not trace.ops or not trace.served_call_s:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.calls / trace.served_call_s)
