"""Scale-out on ``torch.distributed``: the port of ``ria_tpu.parallel``.

One process per rank, explicit collectives (:mod:`._collectives`), the ranks
started by :func:`~.launch.launch`.  ``mesh`` holds the (ch x cw) batch mesh,
``stream`` the time-block stream RX with its halo exchange, ``distributed``
the multi-host helpers.
"""

from .mesh import make_mesh, make_sharded_rx

__all__ = ["make_mesh", "make_sharded_rx"]
