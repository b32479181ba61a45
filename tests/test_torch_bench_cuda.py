"""bench.py's twin, ``ria_tpu_torch.tools.bench``, on the card (needs a GPU).

Imports no JAX, so it runs on a GPU host that has none:

    python -m pytest -q -m cuda tests/test_torch_bench_cuda.py

Without a card every test skips.  The twin runs on bench.py's batches with
its counts lowered: bench.py's sanity checks hold, the line names the card,
each chain call and each ``k1`` and serving call launches K1's float32 build
once, each ``k1_bf16`` call its bf16 build once, and the ``plain`` row and
K2 launch nothing.
"""

import pytest
import torch

from ria_tpu_torch.entry import bench_batches
from ria_tpu_torch.tools import bench as BT
from ria_tpu_torch.utils import cuda_kernels

torch.set_num_threads(1)

# The build each part launches once a call.
LAUNCHED = {"mc_dpsk": "k1", "ofdm": "k1", "coherent": "k1", "plain": None, "k1": "k1",
            "k1_bf16": "k1_bf16", "serving": "k1"}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the decoder rows and chains launch K1, which is CUDA C++")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_twin_on_the_card_launches_each_build_once_a_call(cuda_device):
    batches = bench_batches(cuda_device)
    cuda_kernels.reset_launches()
    line, launches = BT.run(BT.build_chains(batches, cuda_device), batches.ldpc.variants,
                            batches.ldpc.clean.cpu().numpy(), cuda_device, iters=3, trials=1,
                            windows=2, window_calls=2, serving_calls=2)
    d = line["detail"]
    assert d["device"] == torch.cuda.get_device_name(cuda_device)
    assert isinstance(d["power_limit_w"], (float, str))
    assert d["batch"] == 64 and d["window_samples"] == 207328 and d["cw_decode_rate"] > 0.95
    assert d["ofdm"]["detected"] == d["coherent"]["detected"] == 64
    calls = {"mc_dpsk": 5, "ofdm": 5, "coherent": 5, "plain": 5, "k1": 5, "k1_bf16": 5,
             "serving": 3}
    for part, n in launches.items():
        want = {k: (calls[part] if k == LAUNCHED[part] else 0) for k in ("k1", "k1_bf16", "k2")}
        assert n == {"calls": calls[part], **want}, part
    assert cuda_kernels.launches("ldpc_bp_decode") == sum(n["k1"] for n in launches.values())
    assert cuda_kernels.launches("ldpc_bp_bf16_decode") == launches["k1_bf16"]["calls"]
    assert (cuda_kernels.launches("ldpc_bp_v1_decode")
            == cuda_kernels.launches("ldpc_bp_v1_bf16_decode") == 0)
    for row in ("plain", "k1", "k1_bf16"):
        assert d["ldpc"][f"{row}_cw_per_s"] > 0 and d["ldpc"][f"{row}_decode_ok"] > 0.5
    # K1 computes what the plain decoder computes, so both decide alike.
    assert d["ldpc"]["k1_decode_ok"] == d["ldpc"]["plain_decode_ok"]
