"""The multi-process helpers of ``ria_tpu_torch.parallel`` on the CPU.

``initialize`` as the reference's single-process no-op; the mesh, the
collectives and ``put_stream_rows`` on 4 gloo ranks; and ``launch`` when a
rank raises, exits without a result or never reaches a collective.  Each
launch has a deadline, so no test can hang.
"""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from ria_tpu.parallel import distributed as JD
from ria_tpu.parallel.stream import make_stream_mesh as j_stream_mesh
from ria_tpu_torch.parallel import _collectives as C
from ria_tpu_torch.parallel import distributed as D
from ria_tpu_torch.parallel.launch import launch
from ria_tpu_torch.parallel.stream import make_stream_mesh
from ria_tpu_torch.tools import parallel_paths as P

torch.set_num_threads(1)

DEADLINE_S = 60.0


def test_initialize_single_process_is_a_no_op():
    """One process: ``initialize`` returns 1 as the reference's does, starts
    no process group, and the hybrid mesh is the 1 x 1 mesh whose blocks
    are the whole stream."""
    assert D.initialize(device="cpu") == JD.initialize() == 1
    assert not torch.distributed.is_initialized()
    mesh = D.make_hybrid_mesh(device="cpu")
    assert mesh.shape == {"ch": 1, "t": 1} and mesh.groups == {"ch": None, "t": None}
    audio = np.arange(8 * 1024, dtype=np.float32)
    block = D.put_stream(make_stream_mesh(1, device="cpu"), audio)
    want = np.asarray(JD.put_stream(j_stream_mesh(8), audio))
    assert np.array_equal(block.numpy(), want)
    rows = D.put_stream_rows(mesh, audio.reshape(2, -1))
    assert np.array_equal(rows.numpy(), audio.reshape(2, -1))


def test_collectives_on_one_rank_move_nothing():
    """A mesh of one rank: the halo is zeros, a gather adds the rank axis,
    a sum is the tensor itself."""
    mesh = make_stream_mesh(1, device="cpu")
    x = torch.arange(4.0)
    assert torch.equal(C.from_right(x, mesh, "t"), torch.zeros(4))
    assert torch.equal(C.from_left(x, mesh, "t"), torch.zeros(4))
    assert torch.equal(C.all_gather(x > 1, mesh, "t"), (x > 1)[None])
    z = torch.tensor([1 + 2j], dtype=torch.complex64)
    assert torch.equal(C.psum(z, mesh, "t"), z)
    # A bool before a float32 packs the float at an odd byte offset.
    flag, value = C.gather_fields([torch.tensor([True]), torch.tensor([2.5, -1.0])], mesh, "t")
    assert flag.tolist() == [[True]] and value.tolist() == [[2.5, -1.0]]


def test_mesh_and_collectives_on_four_ranks():
    """4 gloo ranks: the (ch=2, t=2) hybrid mesh lays each host's ranks on
    one t line; each rank keeps its column block of its host's row; the row
    sums cross both axes (host h: (h + 1) x 4,096, as the reference's
    2-process test asserts); the halo is the neighbour's block with zeros at
    the edges; gathers keep dtypes and order; a sum of slabs is exact."""
    outs = launch(P.mesh_selftest, 4, device="cpu", timeout_s=DEADLINE_S)
    for r, out in enumerate(outs):
        h, j = divmod(r, 2)
        assert tuple(out["coords"]) == (h, j)
        assert tuple(out["peers"]) == (2 * h, 2 * h + 1, j)
        assert out["rows"].shape == (1, 2048) and (out["rows"] == h + 1).all()
        assert out["sums"].tolist() == [4096.0, 8192.0]
        assert out["right"].tolist() == ([float(r + 2)] * 3 if r < 3 else [0.0] * 3)
        assert out["left"].tolist() == ([float(r)] * 3 if r > 0 else [0.0] * 3)
        assert out["t_line"].tolist() == [2 * h, 2 * h + 1]
        assert out["bools"].tolist() == [True, False, True, False]
        scores, ranks, late = out["fields"]
        assert scores.dtype == np.float32 and scores.tolist() == [0.0, 1.5, 3.0, 4.5]
        assert ranks.dtype == np.int32 and ranks.tolist() == [0, 1, 2, 3]
        assert late.dtype == np.bool_ and late.tolist() == [False, False, True, True]
        want = np.array([complex(i + 0.25, -i) for i in range(4)], np.complex64)
        assert np.array_equal(out["psum"], want)


def test_rank_exception_is_raised_in_the_parent():
    """A rank that raises: its exception reaches the caller with the rank's
    traceback, and every rank is ended (the others wait in a collective)."""
    t0 = time.monotonic()
    with pytest.raises(ValueError, match="rank 2 fails on purpose") as info:
        launch(P.fail_on, 4, args=(2,), device="cpu", timeout_s=DEADLINE_S)
    assert any("raised on rank 2 of 4" in note for note in info.value.__notes__)
    assert time.monotonic() - t0 < DEADLINE_S


def test_rank_that_exits_without_a_result():
    """A rank that exits with no result and no exception is reported with
    its exit code."""
    with pytest.raises(RuntimeError, match="rank 1 exited with code 3"):
        launch(P.die_on, 4, args=(1,), device="cpu", timeout_s=DEADLINE_S)


def test_rank_that_never_reaches_a_collective():
    """A rank that never reaches the collective its peers wait in: the
    parent's deadline ends all four and names them."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1, 2, 3\] of 4 did not finish within 8 s"):
        launch(P.stall_on, 4, args=(1, 600.0), device="cpu", timeout_s=8.0)
    assert time.monotonic() - t0 < 8.0 + 30.0


def test_launch_checks_its_arguments():
    with pytest.raises(ValueError, match="3 rank_args for 2 ranks"):
        launch(P.where, 2, rank_args=[(), (), ()], device="cpu")
    assert launch(P.where, 2, device="cpu") == [torch.device("cpu")] * 2


def test_reference_single_process_helpers_agree():
    """The reference's degenerate hybrid mesh spans its one process's
    devices on t; the port's spans its one rank: both put ch = 1."""
    assert JD.make_hybrid_mesh().shape["ch"] == D.make_hybrid_mesh(device="cpu").shape["ch"]
    assert len(jax.devices()) == 8
