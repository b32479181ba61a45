"""Replays of ``jax.random``'s keys as the port's channel draws, and the
reference's simulator fed given draws; with the tests of both.

``ria_tpu.sim`` draws its channel noise from ``jax.random`` keys, which
torch cannot reproduce; the port's channel takes its standard normals from
outside (``ria_tpu_torch.sim.channel``).  These helpers split the keys as
the reference does and hand the port the same normals as numpy arrays, so a
test holds the port's channel, and a whole session, to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)


def _normal(key, shape) -> np.ndarray:
    return np.array(jax.random.normal(key, tuple(shape), jnp.float32))


def init_draws(key, batch_shape=()) -> dict:
    """The normals ``init_channel_state(cfg, key, batch_shape)`` draws."""
    k1, k2 = jax.random.split(key)
    return {"h1": _normal(k1, tuple(batch_shape) + (2,)),
            "h2": _normal(k2, tuple(batch_shape) + (2,))}


def stream_draws(key, shape) -> dict:
    """The normals ``apply_channel_stream(x, key, ...)`` draws, x of ``shape``."""
    k1, k2, kn = jax.random.split(key, 3)
    shape = tuple(shape)
    return {"fade1": _normal(k1, shape + (2,)), "fade2": _normal(k2, shape + (2,)),
            "noise": _normal(kn, shape)}


def oneshot_draws(key, shape) -> dict:
    """The normals ``apply_channel(x, key, ...)`` draws, x of ``shape``."""
    shape = tuple(shape)
    out = {}
    for tap, k in zip(("1", "2"), jax.random.split(key, 3)[:2]):
        k_init, k_noise = jax.random.split(k)
        out["init" + tap] = _normal(k_init, shape[:-1] + (2,))
        out["fade" + tap] = _normal(k_noise, shape + (2,))
    out["noise"] = _normal(jax.random.split(key, 3)[2], shape)
    return out


class SimDraws:
    """One direction of ``ria_tpu.sim.simulator.DualStationSim``'s keys:
    ``PRNGKey(seed)``, one split for the initial state, then one split per
    block — the draw source the port's ``DualStationSim`` takes."""

    def __init__(self, seed: int):
        self.key = jax.random.PRNGKey(seed)

    def init(self, batch_shape=()) -> dict:
        self.key, k_init = jax.random.split(self.key)
        return init_draws(k_init, batch_shape)

    def stream_block(self, shape, cfg) -> dict:
        self.key, sub = jax.random.split(self.key)
        return stream_draws(sub, shape)


def sim_draws(seed: int) -> tuple:
    """The (A->B, B->A) sources of the reference simulator seeded ``seed``."""
    return SimDraws(seed), SimDraws(seed + 1)


# ------------------------------------------------ the other way round
# The reference's simulator fed the port's numbers: a draw stream that the
# port's sessions meet (a torch generator's) can be run through ria_tpu to
# tell the reference's own behaviour from a port fault.

import functools

from ria_tpu.sim import channel as _JC
from ria_tpu.sim.simulator import DualStationSim as _JSim


@functools.partial(jax.jit, static_argnames=("cfg",))
def _stream_given(x, fade1, fade2, noise, cfg, state):
    """``ria_tpu.sim.channel.apply_channel_stream`` with its normals given
    instead of drawn from a key (the same operations in the same order)."""
    n = x.shape[-1]
    nz = (jnp.abs(x) > 1e-6).astype(jnp.float32)
    count = jnp.maximum(jnp.sum(nz, axis=-1, keepdims=True), 1.0)
    power = jnp.sum(jnp.square(x) * nz, axis=-1, keepdims=True) / count
    has_signal = jnp.sum(nz, axis=-1, keepdims=True) > 0.1 * n
    input_rms = jnp.where(has_signal, jnp.sqrt(power), state.last_rms)
    new_last_rms = jnp.where(has_signal, jnp.sqrt(power), state.last_rms)
    noise_std = input_rms * (10.0 ** (-cfg.snr_db / 20.0))
    out = x
    new_h1, new_h2, new_x_tail = state.h1, state.h2, state.x_tail
    if cfg.fading_enabled:
        alpha = cfg.fading_alpha
        scale = float(np.sqrt(1.0 / alpha))

        def fade(nr, carry):
            nr = nr * scale
            y = _JC._ar1_scan(jax.lax.complex(nr[..., 0], nr[..., 1]), alpha, carry)
            return y, y[..., -1]

        h1, new_h1 = fade(fade1, state.h1)
        h1_mag = jnp.abs(h1)
        if cfg.multipath_enabled and cfg.delay_samples > 0:
            h2, new_h2 = fade(fade2, state.h2)
            d = cfg.delay_samples
            xx = jnp.concatenate([state.x_tail[..., -d:], x], axis=-1)
            out = x * cfg.path1_gain * h1_mag + xx[..., :n] * cfg.path2_gain * jnp.abs(h2)
            new_x_tail = xx[..., n:]
        else:
            out = x * h1_mag
    elif cfg.multipath_enabled and cfg.delay_samples > 0:
        d = cfg.delay_samples
        xx = jnp.concatenate([state.x_tail[..., -d:], x], axis=-1)
        out = x * cfg.path1_gain + xx[..., :n] * cfg.path2_gain
        new_x_tail = xx[..., n:]
    if cfg.noise_enabled:
        out = out + noise_std * noise
    i_tail, q_tail, cfo_phase, mix_phase = (state.i_tail, state.q_tail, state.cfo_phase,
                                            state.mix_phase)
    if cfg.cfo_enabled and abs(cfg.cfo_hz) > 1e-3:
        out, i_tail, q_tail, cfo_phase, mix_phase = _JC._cfo_shift_block(
            out, cfg, i_tail, q_tail, cfo_phase, mix_phase)
    return out, _JC.ChannelState(new_h1, new_h2, new_x_tail, i_tail, q_tail, cfo_phase,
                                 mix_phase, new_last_rms)


class SharedDraws:
    """One direction's draw source served to two simulators: each gets the
    same sequence of draws, made once by ``source`` (any object with
    ``init(batch_shape)`` and ``stream_block(shape, cfg)``), as numpy."""

    def __init__(self, source):
        self.source = source
        self.queues = ([], [])

    def side(self, i: int):
        shared = self

        class Side:
            def init(self, batch_shape=()):
                return shared._next(i, lambda: shared.source.init(batch_shape))

            def stream_block(self, shape, cfg):
                return shared._next(i, lambda: shared.source.stream_block(shape, cfg))

        return Side()

    def _next(self, i, make):
        if self.queues[i]:
            return self.queues[i].pop(0)
        d = {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v, np.float32)
             for k, v in make().items()}
        self.queues[1 - i].append(d)
        return d


class GivenDrawsSim(_JSim):
    """``ria_tpu.sim.simulator.DualStationSim`` whose two channels take their
    normals from ``sources`` (A->B, B->A; ``init`` once, then one
    ``stream_block`` a block, as the port's simulator asks for them) and
    ``port_cfg``, the port's ChannelConfig of the same preset (which draws
    a configuration needs)."""

    def __init__(self, cfg, seed: int, sources, port_cfg):
        super().__init__(cfg, seed=seed)
        self.sources = {"ab": sources[0], "ba": sources[1]}
        self.port_cfg = port_cfg
        alpha = cfg.fading_alpha if cfg.fading_enabled else 0.5
        init_std = np.float32(np.sqrt(1.0 / (2.0 - alpha)))
        for d, src in self.sources.items():
            init = src.init()
            h1, h2 = ((init[k] * init_std).astype(np.float32) for k in ("h1", "h2"))
            st = getattr(self, f"state_{d}")
            setattr(self, f"state_{d}", st._replace(
                h1=jax.lax.complex(h1[0], h1[1]), h2=jax.lax.complex(h2[0], h2[1])))

    def _channel(self, x, direction):
        d = self.sources[direction].stream_block(x.shape, self.port_cfg)
        zeros2 = np.zeros(x.shape + (2,), np.float32)
        st = getattr(self, f"state_{direction}")
        out, st = _stream_given(jnp.asarray(x), jnp.asarray(d.get("fade1", zeros2)),
                                jnp.asarray(d.get("fade2", zeros2)),
                                jnp.asarray(d.get("noise", np.zeros(x.shape, np.float32))),
                                self.channel_cfg, st)
        setattr(self, f"state_{direction}", st)
        return np.asarray(out, np.float32)


def test_replayed_keys_give_the_reference_channel():
    """``sim_draws`` replays ``ria_tpu``'s simulator keys: its initial states
    and first blocks equal the reference simulator's own."""
    from ria_tpu_torch.sim.channel import PRESETS as T_PRESETS
    from ria_tpu_torch.sim.channel import apply_channel_stream, init_channel_state

    cfg = _JC.poor(10.0)
    tcfg = T_PRESETS["poor"](10.0)
    ref = _JSim(cfg, seed=5)
    src = sim_draws(5)[0]
    state = init_channel_state(tcfg, src.init(), device="cpu")
    np.testing.assert_array_equal(state.h1.numpy(), np.asarray(ref.state_ab.h1))
    rng = np.random.default_rng(0)
    for _ in range(2):
        x = (rng.normal(size=9600) * 0.2).astype(np.float32)
        want = ref._channel(x, "ab")
        got, state = apply_channel_stream(x, tcfg, state, src.stream_block(x.shape, tcfg),
                                          device="cpu")
        assert np.max(np.abs(got.samples.numpy() - want)) <= 1e-5


def test_given_draws_sim_is_the_reference_channel():
    """``GivenDrawsSim`` fed the replay of the reference's own keys produces
    the reference simulator's audio and states to the last float32 place
    (XLA folds the draw's own scaling into the reference's arithmetic;
    given normals arrive already scaled to unit variance): its channel is
    the reference's, only the source of the normals differs."""
    from ria_tpu_torch.sim.channel import PRESETS as T_PRESETS

    cfg = _JC.poor(10.0)
    ref = _JSim(cfg, seed=9)
    given = GivenDrawsSim(cfg, 9, sim_draws(9), T_PRESETS["poor"](10.0))
    np.testing.assert_array_equal(np.asarray(given.state_ba.h2), np.asarray(ref.state_ba.h2))
    rng = np.random.default_rng(1)
    for _ in range(2):
        x = (rng.normal(size=9600) * 0.2).astype(np.float32)
        for d in ("ab", "ba"):
            got, want = given._channel(x, d), ref._channel(x, d)
            assert np.max(np.abs(got - want)) <= 2.5e-7
            for a, b in zip(getattr(given, f"state_{d}"), getattr(ref, f"state_{d}")):
                assert np.max(np.abs(np.asarray(a) - np.asarray(b))) <= 2.5e-7
