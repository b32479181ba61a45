"""The PyTorch port imports without JAX."""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import ria_tpu_torch, ria_tpu_torch.convert, ria_tpu_torch.entry\n"
        "import ria_tpu_torch.utils.mt19937, ria_tpu_torch.utils.bits\n"
        "import ria_tpu_torch.fec.ldpc_matrix, ria_tpu_torch.fec.ldpc\n"
        "import ria_tpu_torch.fec.ldpc_kernel, ria_tpu_torch.fec.ldpc_cuda\n"
        "import ria_tpu_torch.tools.ldpc_bench, ria_tpu_torch.sync.chirp\n"
        "import ria_tpu_torch.tools.kernel_compare, ria_tpu_torch.utils.timing\n"
        "import ria_tpu_torch.wave.mc_dpsk, ria_tpu_torch.phy.pipeline\n"
        "import ria_tpu_torch.fec.interleave, ria_tpu_torch.phy.frame_v2\n"
        "import ria_tpu_torch.dsp.hilbert, ria_tpu_torch.wave.ofdm\n"
        "import ria_tpu_torch.fec.chase, ria_tpu_torch.sync.zc, ria_tpu_torch.sync.css\n"
        "import ria_tpu_torch.wave.dpsk, ria_tpu_torch.wave.mfsk, ria_tpu_torch.wave.otfs\n"
        "import ria_tpu_torch.tools.waveform_paths\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'ria_tpu.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
