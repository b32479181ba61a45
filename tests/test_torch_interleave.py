"""The port's interleavers against ``ria_tpu.fec.interleave``: every
permutation and every apply/undo function equal (integers, exact)."""

import numpy as np
import pytest
import torch

from ria_tpu.fec import interleave as J
from ria_tpu_torch.fec import interleave as T

torch.set_num_threads(1)


@pytest.mark.parametrize("rows,cols", [(1, 1), (4, 162), (18, 36), (27, 24), (7, 5)])
def test_block_perm(rows, cols):
    assert np.array_equal(T.block_perm(rows, cols), J.block_perm(rows, cols))


@pytest.mark.parametrize("bps", [1, 2, 3, 4, 5, 6, 8, 118, 306, 400])
@pytest.mark.parametrize("total", [648, 2592, 30])
def test_channel_perm(bps, total):
    """Includes the fallbacks: a target past the block, and blocks where the
    step search starts above every coprime."""
    got = T.channel_perm(bps, total)
    assert np.array_equal(got, J.channel_perm(bps, total))
    assert np.array_equal(np.sort(got), np.arange(total))


def test_frame_perm_and_round_trip():
    assert np.array_equal(T.frame_perm(), J.frame_perm())
    rng = np.random.default_rng(0)
    cw = rng.integers(0, 2, (3, 4, 648)).astype(np.uint8)
    inter = T.frame_interleave(cw)
    assert np.array_equal(inter, J.frame_interleave(cw))
    soft = rng.normal(size=(3, 2592)).astype(np.float32)
    assert np.array_equal(T.frame_deinterleave(soft), J.frame_deinterleave(soft))
    assert np.array_equal(T.frame_deinterleave(inter), cw)


@pytest.mark.parametrize("num_cw", [1, 2, 4, 5, 9])
def test_stripe(num_cw):
    assert np.array_equal(T.stripe_perm(num_cw), J.stripe_perm(num_cw))
    rng = np.random.default_rng(num_cw)
    cw = rng.integers(0, 2, (2, num_cw, 648)).astype(np.uint8)
    assert np.array_equal(T.stripe_interleave(cw), J.stripe_interleave(cw))
    soft = rng.normal(size=(2, num_cw * 648)).astype(np.float32)
    assert np.array_equal(T.stripe_deinterleave(soft, num_cw),
                          J.stripe_deinterleave(soft, num_cw))
    assert np.array_equal(T.stripe_deinterleave(T.stripe_interleave(cw), num_cw), cw)


@pytest.mark.parametrize("num_frames", [1, 2, 3, 4])
def test_burst(num_frames):
    assert np.array_equal(T.burst_perm(num_frames), J.burst_perm(num_frames))
    rng = np.random.default_rng(num_frames)
    frames = rng.integers(0, 256, (num_frames, 324)).astype(np.uint8)
    assert np.array_equal(T.burst_interleave_bytes(frames), J.burst_interleave_bytes(frames))
    soft = rng.normal(size=(num_frames, 2592)).astype(np.float32)
    assert np.array_equal(T.burst_deinterleave_soft(soft), J.burst_deinterleave_soft(soft))


@pytest.mark.parametrize("inverse", [False, True])
def test_apply_perm(inverse):
    rng = np.random.default_rng(3)
    perm = rng.permutation(648)
    x = rng.normal(size=(5, 648)).astype(np.float32)
    got = T.apply_perm(x, perm, inverse)
    assert np.array_equal(got, J.apply_perm(x, perm, inverse))
    assert np.array_equal(T.apply_perm(got, perm, not inverse), x)
