"""A simulated session does not depend on the host's speed: the chase
cache's 30 s TTL runs on the station's protocol time.

The reference's chase cache ages its entries on ``time.monotonic``.  In the
goodput session Moderate 20 dB seed 100 on the reference's keys, bravo
takes frame 17's codewords into its cache at tick 161 and frame 6's at tick
176, which prunes entries idle for over 30 s; frame 17's retransmission is
chase-combined at tick 245 only if its entry survived that prune.  So the
two packages part at tick 245 (bravo's ring 5,920 against 5,912 samples)
when one host takes over 2 s a block between ticks 161 and 176 and the
other does not, and every decode before agrees (the diagnosis at the end
of this file).  Every other timer of the station runs on the protocol's
time (``Station._now_ms``, the sum of ``tick``'s elapsed ms), and so does
the port's chase cache.  Against the reference the tests here give its
chase cache the same clock (its module's ``time.monotonic`` read from the
simulated stations), which makes the two tick-equal to the end.
"""

import types

import numpy as np
import pytest
import torch

import test_torch_jax_draws as D
from ria_tpu_torch.fec import chase as T
from ria_tpu_torch.phy.station import Station
from ria_tpu_torch.tools import goodput
from ria_tpu_torch.tools import session_paths as S

torch.set_num_threads(1)


class SlowHostClock:
    """``time.monotonic`` of a host that takes 100 s between two readings."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        self.now += 100.0
        return self.now


def test_station_chase_ttl_runs_on_protocol_time(monkeypatch):
    """A station's chase entry lives 30 s of protocol time (150 ticks of
    200 ms), however slow the host: on a host whose clock moves 100 s a
    reading it is still combinable after 20 s of ticks, and expires only
    once 30 s have passed."""
    monkeypatch.setattr(T.time, "monotonic", SlowHostClock())
    st = Station("BRAVO", device="cpu")
    soft = np.ones(648, np.float32)
    first, key = T.ChaseKey(17, 1, 2), T.ChaseKey(18, 1, 2)
    st.chase.store(first, 0, soft, 4, 0x30)
    for _ in range(100):                        # 20 s
        st.tick(200, poll=False)
    st.chase.store(key, 0, soft, 4, 0x30)       # a new entry prunes the stale ones
    assert st.chase.get_combine_count(first, 0) == 1
    assert st.chase.store(first, 0, soft, 4, 0x30)
    assert st.chase.get_combine_count(first, 0) == 2
    for _ in range(151):                        # 30.2 s since the last access
        st.tick(200, poll=False)
    st.chase.store(T.ChaseKey(19, 1, 2), 0, soft, 4, 0x30)
    assert st.chase.get_combine_count(first, 0) == 0
    assert st.chase.stats.entries_expired == 2


def test_chase_cache_alone_keeps_the_wall_clock(monkeypatch):
    """A cache built without a clock ages on ``time.monotonic``, as the
    reference's does."""
    clock = SlowHostClock()
    monkeypatch.setattr(T.time, "monotonic", clock)
    cache = T.ChaseCache()
    soft = np.ones(648, np.float32)
    cache.store(T.ChaseKey(1, 0, 0), 0, soft, 1, 0x30)
    cache.store(T.ChaseKey(2, 0, 0), 0, soft, 1, 0x30)   # 100 s later: the first expired
    assert len(cache) == 1 and cache.stats.entries_expired == 1


def protocol_time_chase(ref_sim, monkeypatch):
    """``ria_tpu``'s chase caches, in this test, age on ``ref_sim``'s
    protocol time as the port's stations' do.  ALPHA ticks first in a
    block, so its time is the polling station's."""
    from ria_tpu.fec import chase as J

    monkeypatch.setattr(J, "time", types.SimpleNamespace(
        monotonic=lambda: ref_sim.alpha._now_ms / 1000.0))


@pytest.mark.slow
def test_moderate_20db_seed_100_in_lock_step_with_the_reference(monkeypatch):
    """The goodput session Moderate 20 dB seed 100 on the reference's keys,
    the reference's chase cache on protocol time: every tick equal to the
    end, and the same result dict."""
    from ria_tpu.protocol.connection import ConnectionState as JState
    from ria_tpu.sim.channel import PRESETS as J_PRESETS
    from ria_tpu.sim.simulator import DualStationSim as JSim
    from ria_tpu_torch.protocol.connection import ConnectionState as TState

    s = goodput.session("moderate", 20.0, 100)
    ref = JSim(J_PRESETS[s.channel](s.snr_db), seed=s.seed)
    protocol_time_chase(ref, monkeypatch)
    port = goodput.make_sim(s.channel, s.snr_db, s.seed, "cpu", D.sim_draws(s.seed))
    run = S.lock_step([ref, port], s, [JState, TState])
    ref_out, out = run["outs"]
    keys = ("connected", "goodput_bps", "delivered", "air_s", "connect_s", "link",
            "retransmits")
    assert {k: out.get(k) for k in keys} == {k: ref_out.get(k) for k in keys}
    assert run["ticks"] > 245
    print(f"{s.name}: {run['ticks']} ticks equal, max |snr err| {run['max_snr_err']:.3g} dB; "
          + ", ".join(f"{k} {out.get(k)}" for k in keys))


# ------------------------------------------------------------ the diagnosis
# ``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_session_clock.py
# [REF_S PORT_S]`` (from the root of the checkout; ~5 min) shows where the
# session parts when each package's chase cache ages on the clock of its own
# host: each package alone on the reference's keys, its cache on the host's
# wall clock (no arguments; the seconds each took a block are reported), or
# on a clock that reads REF_S and PORT_S seconds a simulated block (a
# deterministic run); every tick's snapshot and every decode recorded; then
# the first differing tick, the decodes before it, bravo's chase entries just
# before that tick with their ages, and the ticks at which each side's bravo
# took a chase entry in or dropped one.

def _host_clock(now_ms, s_per_tick):
    """Seconds on a host that takes ``s_per_tick`` for each 200 ms block."""
    return lambda: now_ms() / 200.0 * s_per_tick


def _record(sim, ConnectionState, clock, max_ticks):
    """Run the goodput session on ``sim`` to its end or ``max_ticks``;
    returns (snapshots, {tick: bravo's chase entries, {seq: (age in s on
    ``clock``, combines)}}, wall seconds a tick)."""
    import time

    s = goodput.session("moderate", 20.0, 100)
    out, snaps, chase = {}, [], {}
    t0 = time.perf_counter()
    for _ in S.script(sim, s, out, ConnectionState):
        snaps.append(S.snapshot(sim, out))
        now = clock()
        chase[sim.ticks] = {k.seq: (round(now - e.last_access, 2), dict(e.cw_combines))
                            for k, e in sim.bravo.chase._cache.items()}
        if sim.ticks >= max_ticks:
            break
    return snaps, chase, (time.perf_counter() - t0) / len(snaps)


def diagnose(ref_s_per_tick: float | None = None, port_s_per_tick: float | None = None,
             max_ticks: int = 3000) -> dict:
    import time

    import ria_tpu.fec.chase as JC
    import ria_tpu.fec.ldpc as JL
    from ria_tpu.protocol.connection import ConnectionState as JState
    from ria_tpu.sim.channel import PRESETS as J_PRESETS
    from ria_tpu.sim.simulator import DualStationSim as JSim
    from ria_tpu_torch.fec.ldpc import LDPCDecoder
    from ria_tpu_torch.protocol.connection import ConnectionState as TState

    ref_calls, port_calls = [], []
    ref = JSim(J_PRESETS["moderate"](20.0), seed=100)
    emulated = ref_s_per_tick is not None
    ref_clock = (_host_clock(lambda: ref.alpha._now_ms, ref_s_per_tick) if emulated
                 else time.monotonic)
    inner, wall = JL.make_decoder_vf, JC.time

    def logged_vf(rate, max_iters=None, precision="f32"):
        f = inner(rate, max_iters, precision)

        def dec(llrs, factors):
            r = f(llrs, factors)
            ref_calls.append((ref.ticks, np.asarray(llrs), np.asarray(r.success),
                              np.asarray(r.iterations)))
            return r
        return dec

    JL.make_decoder_vf, JC.time = logged_vf, types.SimpleNamespace(monotonic=ref_clock)
    try:
        ref_snaps, ref_chase, ref_wall = _record(ref, JState, ref_clock, max_ticks)
    finally:
        JL.make_decoder_vf, JC.time = inner, wall
    port = goodput.make_sim("moderate", 20.0, 100, "cpu", D.sim_draws(100))
    for st in (port.alpha, port.bravo):
        st.chase.clock = (_host_clock(lambda st=st: st._now_ms, port_s_per_tick) if emulated
                          else None)                # None: the wall clock
    port_clock = port.bravo.chase.clock or time.monotonic
    plain = LDPCDecoder.plain

    def logged_plain(self, llrs, factors):
        r = plain(self, llrs, factors)
        port_calls.append((port.ticks, llrs.numpy(), r.success.numpy(), r.iterations.numpy()))
        return r

    LDPCDecoder.plain = logged_plain
    try:
        port_snaps, port_chase, port_wall = _record(port, TState, port_clock, len(ref_snaps))
    finally:
        LDPCDecoder.plain = plain
    first = next(((a["tick"], S.first_difference(a, b)) for a, b in zip(ref_snaps, port_snaps)
                  if S.first_difference(a, b)), None)
    tick = first[0] if first else None
    before = [(a, b) for a, b in zip(ref_calls, port_calls) if tick is None or a[0] < tick - 1]
    same = all(a[1].shape == b[1].shape and np.array_equal(a[2], b[2])
               and np.array_equal(a[3][a[2]], b[3][b[2]]) for a, b in before)
    llr_err = max((float(np.abs(a[1] - b[1]).max()) for a, b in before
                   if a[1].shape == b[1].shape), default=0.0)
    def changes(chase):
        """[(tick, sequences taken in, sequences dropped)] of bravo's cache."""
        out, last = [], set()
        for t in sorted(chase):
            now = set(chase[t])
            if now != last:
                out.append((t, sorted(now - last), sorted(last - now)))
            last = now
        return out

    return {
        "chase_clock": "emulated" if emulated else "wall",
        "s_per_tick": {"reference": ref_s_per_tick or ref_wall,
                       "port": port_s_per_tick or port_wall},
        "ref_ticks": len(ref_snaps), "first_difference": first,
        "decodes_before": len(before), "decodes_before_equal": same,
        "max_llr_err_before": llr_err,
        "bravo_chase_before": None if tick is None else {
            "reference": ref_chase.get(tick - 1), "port": port_chase.get(tick - 1)},
        "bravo_chase_changes": {"reference": changes(ref_chase),
                                "port": changes(port_chase)},
    }


if __name__ == "__main__":
    import json
    import sys

    import jax

    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(2)
    print(json.dumps(diagnose(*map(float, sys.argv[1:3])), default=str))
