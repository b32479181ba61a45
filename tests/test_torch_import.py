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
        "import ria_tpu_torch.dsp.snr, ria_tpu_torch.phy.channel_probe, ria_tpu_torch.phy.modem\n"
        "import ria_tpu_torch.wave.selection, ria_tpu_torch.wave.api, ria_tpu_torch.wave.afdm\n"
        "import ria_tpu_torch.cli\n"
        "import ria_tpu_torch.dsp.fir, ria_tpu_torch.dsp.windows, ria_tpu_torch.dsp.util\n"
        "import ria_tpu_torch.dsp.nco, ria_tpu_torch.sim.channel, ria_tpu_torch.sim.simulator\n"
        "import ria_tpu_torch.utils.logging, ria_tpu_torch.protocol.arq\n"
        "import ria_tpu_torch.protocol.connection, ria_tpu_torch.protocol.file_transfer\n"
        "import ria_tpu_torch.phy.adaptive, ria_tpu_torch.phy.legacy_v1, ria_tpu_torch.phy.station\n"
        "import ria_tpu_torch.runtime.monitor, ria_tpu_torch.tools.cli_simulator\n"
        "import ria_tpu_torch.tools.session_paths\n"
        "import ria_tpu_torch.protocol, ria_tpu_torch.protocol.crypto\n"
        "import ria_tpu_torch.protocol.engine, ria_tpu_torch.runtime.native\n"
        "import ria_tpu_torch.runtime.cat, ria_tpu_torch.runtime.audio, ria_tpu_torch.config\n"
        "import ria_tpu_torch.runtime.host_interface, ria_tpu_torch.runtime.tui\n"
        "import ria_tpu_torch.sim.continuous, ria_tpu_torch.tools.dual_modem_tcp\n"
        "import ria_tpu_torch.tools.host_paths\n"
        "import ria_tpu_torch.dsp.resampler, ria_tpu_torch.dsp.biquad\n"
        "import ria_tpu_torch.parallel, ria_tpu_torch.parallel.distributed\n"
        "import ria_tpu_torch.parallel._collectives, ria_tpu_torch.parallel.launch\n"
        "import ria_tpu_torch.parallel.stream, ria_tpu_torch.parallel.mesh\n"
        "import ria_tpu_torch.tools.parallel_paths, ria_tpu_torch.tools.scaling_bench\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'cryptography', 'tools')\n"
        "             or m.startswith(('jax.', 'ria_tpu.', 'cryptography.', 'tools.')))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_cli_runs_without_jax():
    """``python -m ria_tpu_torch.cli info --device cpu`` with JAX made
    unimportable: the command line needs none of it."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ria_tpu'] = None\n"
        "sys.argv = ['ria', 'info', '--device', 'cpu']\n"
        "import runpy\n"
        "runpy.run_module('ria_tpu_torch.cli', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "MC-DPSK" in proc.stdout and "device cpu" in proc.stdout


def test_simulator_cli_runs_without_jax():
    """``python -m ria_tpu_torch.tools.cli_simulator --device cpu`` with JAX
    made unimportable: a full session needs none of it."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ria_tpu'] = None\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "sys.argv = ['cli_simulator', '--device', 'cpu', '--snr', '12', '--seed-base', '7']\n"
        "import runpy\n"
        "runpy.run_module('ria_tpu_torch.tools.cli_simulator', run_name='__main__')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert "RESULT: 1/1 seeds passed" in proc.stdout, proc.stdout + proc.stderr


def _blocked(code: str) -> str:
    """``code`` run with ``jax``, ``ria_tpu`` and ``cryptography`` made
    unimportable."""
    return ("import sys\n"
            "for name in ('jax', 'ria_tpu', 'cryptography'):\n"
            "    sys.modules[name] = None\n" + code)


def test_host_control_plane_imports_without_jax_or_cryptography():
    """The protocol engine (with its own AES), the host interface, the
    threaded simulator and the console import where neither ``jax`` nor
    ``cryptography`` can be imported, and the cipher runs there."""
    code = _blocked(
        "import ria_tpu_torch.protocol.engine, ria_tpu_torch.runtime.host_interface\n"
        "import ria_tpu_torch.sim.continuous, ria_tpu_torch.runtime.tui\n"
        "import ria_tpu_torch.tools.dual_modem_tcp, ria_tpu_torch.tools.host_paths\n"
        "from ria_tpu_torch.protocol.crypto import AES256\n"
        "aes = AES256(bytes(range(32)))\n"
        "ct = aes.encrypt(bytes.fromhex('00112233445566778899aabbccddeeff'), bytes(16))\n"
        "assert ct[16:32].hex() == '8ea2b7ca516745bfeafc49904b496089', ct.hex()\n"
        "assert aes.decrypt(aes.encrypt(b'x' * 100)) == b'x' * 100\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_dual_modem_tool_runs_without_jax_or_cryptography():
    """``python -m ria_tpu_torch.tools.dual_modem_tcp --device cpu
    --self-test`` with ``jax`` and ``cryptography`` unimportable."""
    code = _blocked(
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "sys.argv = ['dual_modem_tcp', '--device', 'cpu', '--self-test']\n"
        "import runpy\n"
        "runpy.run_module('ria_tpu_torch.tools.dual_modem_tcp', run_name='__main__')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert "data A->B: OK" in proc.stdout, proc.stdout + proc.stderr
    assert proc.returncode == 0, proc.stderr
