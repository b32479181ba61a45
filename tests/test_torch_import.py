"""The PyTorch port imports without JAX, and keeps the reference's names."""

import ast
import importlib
import inspect
import subprocess
import sys
from pathlib import Path

import pytest
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
        "import ria_tpu_torch.tools.verify_cfo_chain, ria_tpu_torch.tools.profile_acquisition\n"
        "import ria_tpu_torch.tools.acceptance_sweep, ria_tpu_torch.tools.otfs_mode_sweep\n"
        "import ria_tpu_torch.tools.throughput_test, ria_tpu_torch.tools.goodput\n"
        "import ria_tpu_torch.tools.adaptive_session_sweep, ria_tpu_torch.tools.bench\n"
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


# ------------------------------------------------ the reference's names
# Every package and module of ``ria_tpu`` (and every root tool) is read with
# ``ast``, so no JAX is imported, and held against its twin in the port.
PACKAGES = ["", "sim", "dsp", "sync", "wave", "phy", "fec", "utils", "protocol", "parallel",
            "runtime"]
# Reference names the port does not carry, each with its reason: none is left.
NAME_GAPS: dict[str, str] = {}
# Root programs of the reference and their twins in the port.
ROOT_PROGRAMS = {"bench": "tools.bench"}
# Reference modules without a twin of the same name, each with its reason.
MODULE_GAPS = {
    "fec.ldpc_pallas": "its two Pallas kernels are csrc/ldpc_bp.cu and csrc/ldpc_bp_v1.cu, "
                       "behind fec/ldpc_cuda.py",
    "utils.platform": "selects a JAX backend; utils.device.resolve_device and --device take "
                      "its place",
    "tools.pallas_bench": "twinned by tools/ldpc_bench.py (K1, K2 and the plain decoder)",
}


def _reference_file(name: str) -> Path:
    if name in ROOT_PROGRAMS:
        return ROOT / (name + ".py")
    if name.startswith("tools."):
        return ROOT / "tools" / (name.split(".", 1)[1] + ".py")
    path = ROOT / "ria_tpu" / Path(*name.split(".")) if name else ROOT / "ria_tpu"
    return path / "__init__.py" if path.is_dir() else path.with_suffix(".py")


def _port_module(name: str):
    name = ROOT_PROGRAMS.get(name, name)
    return importlib.import_module("ria_tpu_torch" + ("." + name if name else ""))


def _top_level(name: str) -> tuple[list | None, dict]:
    """(the reference module's ``__all__`` or None, {each public name it
    defines or assigns at top level: the literal assigned, else None})."""
    tree = ast.parse(_reference_file(name).read_text())
    exported, names = None, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)) and not node.name.startswith("_"):
            names[node.name] = None
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    exported = ast.literal_eval(node.value)
                elif isinstance(t, ast.Name) and (not t.id.startswith("_")
                                                  or t.id == "__version__"):
                    try:
                        names[t.id] = ast.literal_eval(node.value)
                    except ValueError:
                        names[t.id] = None
    return exported, names


def _package_modules() -> list[str]:
    return [".".join(p.relative_to(ROOT / "ria_tpu").with_suffix("").parts)
            for p in sorted((ROOT / "ria_tpu").rglob("*.py")) if p.name != "__init__.py"]


def _reference_modules() -> list[str]:
    return (_package_modules() + ["tools." + p.stem for p in sorted((ROOT / "tools").glob("*.py"))]
            + list(ROOT_PROGRAMS))


@pytest.mark.parametrize("package", PACKAGES, ids=lambda p: p or "ria_tpu")
def test_package_exports_the_reference_names(package):
    """The port's package re-exports the reference's ``__all__`` in the
    reference's order (the port may add names of its own between them);
    every name of its ``__all__`` resolves; the reference's top-level
    constants (``SAMPLE_RATE``, ``__version__``) carry the same values; and
    the only names missing are those of ``NAME_GAPS``."""
    exported, names = _top_level(package)
    port = _port_module(package)
    prefix = package + "." if package else ""
    port_all = list(getattr(port, "__all__", []))
    for n in port_all:
        assert hasattr(port, n), f"{package}: __all__ names {n!r}, which does not resolve"
    if exported is not None:
        want = [n for n in exported if prefix + n not in NAME_GAPS]
        remaining = iter(port_all)
        assert all(n in remaining for n in want), (
            f"{package}: the reference's __all__ {want} is not in the port's {port_all} "
            f"in order")
        for n in exported:
            assert (prefix + n in NAME_GAPS) != hasattr(port, n), (package, n)
    for n, value in names.items():
        if value is not None:
            assert getattr(port, n) == value, (package, n)


@pytest.mark.parametrize("module", _reference_modules())
def test_module_keeps_the_reference_names(module):
    """Every public function, class and top-level name of a reference module
    (or root tool, or root program) exists in its twin, but for
    ``NAME_GAPS``; a module without a twin is one of ``MODULE_GAPS``."""
    if module in MODULE_GAPS:
        with pytest.raises(ModuleNotFoundError):
            _port_module(module)
        return
    port = _port_module(module)
    _, names = _top_level(module)
    missing = sorted(n for n in names if not hasattr(port, n))
    assert missing == sorted(n for n in names if f"{module}.{n}" in NAME_GAPS), missing


# Parameters of the reference that the port leaves out on purpose, each with
# its reason.  The reference's positional parameters after the first of them
# keep their order in the port but not their places.
JAX_ONLY_PARAMETERS = {
    "key": "a jax.random key: the port's channel takes its normals from outside, and "
           "``draws`` takes the key's place (sim/channel.py)",
    "pallas_interpret": "runs a Pallas kernel in the interpreter: K1 has no interpreted "
                        "mode, and its plain version serves CPU tensors (fec/ldpc.py, "
                        "parallel/)",
    "devices": "a list of JAX devices for a mesh: a rank holds one torch device, "
               "``device`` (parallel/mesh.py, parallel/stream.py)",
}


def _signature(obj) -> inspect.Signature:
    """``obj``'s signature, a ``functools.lru_cache`` unwrapped through
    ``__wrapped__``."""
    while not inspect.isclass(obj) and hasattr(obj, "__wrapped__"):
        obj = obj.__wrapped__
    return inspect.signature(obj)


def _public_callables(module) -> dict:
    """{name: object} of the public functions and classes ``module`` defines
    and, as ``"Class.method"``, each public method its classes define."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != module.__name__:
            continue
        if inspect.isclass(obj):
            out[name] = obj
            out.update({f"{name}.{m}": getattr(obj, m) for m, v in vars(obj).items()
                        if not m.startswith("_") and (callable(v) or isinstance(
                            v, (staticmethod, classmethod)))})
        elif callable(obj):
            out[name] = obj
    return out


def _parameter_faults(ref: inspect.Signature, port: inspect.Signature) -> list[str]:
    """How ``port`` fails to take the calls ``ref`` takes: a parameter name
    missing, or a positional parameter out of its place or order."""
    def names(sig, positional):
        kinds = ((inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
                 if positional else (inspect.Parameter.VAR_POSITIONAL,
                                     inspect.Parameter.VAR_KEYWORD))
        return [p.name for p in sig.parameters.values() if (p.kind in kinds) == positional]

    faults = [f"no parameter {n!r}" for n in names(ref, False)
              if n not in JAX_ONLY_PARAMETERS and n not in port.parameters]
    ref_pos, port_pos = names(ref, True), names(port, True)
    cut = next((i for i, n in enumerate(ref_pos) if n in JAX_ONLY_PARAMETERS), len(ref_pos))
    if port_pos[:cut] != ref_pos[:cut]:
        faults.append(f"positional parameters {port_pos[:cut]}, the reference's {ref_pos[:cut]}")
    later = iter(port_pos[cut:])
    if not all(n in later for n in ref_pos[cut:] if n not in JAX_ONLY_PARAMETERS):
        faults.append(f"positional parameters {port_pos[cut:]} out of the reference's order "
                      f"{ref_pos[cut:]}")
    return faults


@pytest.mark.parametrize("module", [m for m in _package_modules() if m not in MODULE_GAPS])
def test_module_takes_the_reference_signatures(module):
    """Each public function, class and public method of a ``ria_tpu``
    module, and its twin: the twin takes every parameter name of the
    reference, its positional parameters in the reference's places, but for
    ``JAX_ONLY_PARAMETERS``.  So a call written for the reference, positional
    or by keyword, reaches the same parameters in the port."""
    ref = importlib.import_module("ria_tpu." + module)
    port = _port_module(module)
    faults = {}
    for name, obj in _public_callables(ref).items():
        twin = port
        for part in name.split("."):
            twin = getattr(twin, part)
        found = _parameter_faults(_signature(obj), _signature(twin))
        if found:
            faults[name] = found
    assert not faults, faults


def test_subpackages_import_with_jax_blocked():
    """Every subpackage, imported first in a process where ``jax`` and
    ``ria_tpu`` cannot be imported, with the reference's package-level
    names taken from it."""
    code = _blocked(
        "import importlib\n"
        "for sub in ('sim', 'dsp', 'sync', 'wave', 'phy', 'fec', 'utils', 'protocol',\n"
        "            'parallel', 'runtime', 'tools'):\n"
        "    importlib.import_module('ria_tpu_torch.' + sub)\n"
        "from ria_tpu_torch import SAMPLE_RATE\n"
        "from ria_tpu_torch.sim import PRESETS, apply_channel, ChannelConfig, awgn\n"
        "from ria_tpu_torch.dsp import hann, fir_filter, analytic_signal, freq_shift_real, rms\n"
        "from ria_tpu_torch.sync import ChirpConfig, ChirpSyncResult, detect_dual_chirp, generate\n"
        "from ria_tpu_torch.wave import MCDPSKConfig, demodulate, modulate, preamble\n"
        "from ria_tpu_torch.phy import DataFrame, make_fixed_data_frame, MCDPSKModem, RxFrame\n"
        "assert SAMPLE_RATE == 48000.0 and sorted(PRESETS) == ['awgn', 'flutter', 'good', "
        "'moderate', 'poor']\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_sync_imports_neither_fec_nor_wave():
    """The layers point one way (utils <- dsp <- sync <- wave): every module
    of ``ria_tpu_torch.sync``, imported in a fresh process, loads no module
    of ``fec`` and none of ``wave``, only the package's, ``sync``'s, ``dsp``'s
    and ``utils``'."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import ria_tpu_torch.sync as sync\n"
        "for m in pkgutil.iter_modules(sync.__path__):\n"
        "    importlib.import_module('ria_tpu_torch.sync.' + m.name)\n"
        "print(' '.join(sorted(n for n in sys.modules if n.startswith('ria_tpu_torch'))))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    loaded = proc.stdout.split()
    assert "ria_tpu_torch.sync.sc_kernel" in loaded and "ria_tpu_torch.sync.zc" in loaded
    assert not [n for n in loaded if n.startswith(("ria_tpu_torch.fec", "ria_tpu_torch.wave"))]
    assert all(n == "ria_tpu_torch" or n.split(".")[1] in ("sync", "dsp", "utils")
               for n in loaded), loaded


@pytest.mark.parametrize("tool,argv,expect", [
    ("verify_cfo_chain", ["--device", "cpu"], "PASS"),
    ("throughput_test", ["--device", "cpu", "--assert"], "PASS: every operating point"),
])
def test_root_tool_twins_run_without_jax(tool, argv, expect):
    """``python -m ria_tpu_torch.tools.<tool> --device cpu`` where ``jax``,
    ``ria_tpu`` and ``cryptography`` cannot be imported."""
    code = _blocked(
        "import runpy, torch\n"
        "torch.set_num_threads(1)\n"
        f"sys.argv = ['{tool}'] + {argv!r}\n"
        "try:\n"
        f"    runpy.run_module('ria_tpu_torch.tools.{tool}', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert expect in proc.stdout, proc.stdout


def test_bits_helpers_match_the_reference():
    """``utils.jnp_bits_to_bytes_array`` and ``utils.jnp_bytes_to_bits`` on
    tensors against the reference's on JAX arrays: the same random bits and
    bytes, batched, MSB first, equal exactly."""
    import numpy as np

    from ria_tpu.utils import bits as J
    from ria_tpu_torch.utils import jnp_bits_to_bytes_array, jnp_bytes_to_bits

    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (3, 5, 64)).astype(np.uint8)
    data = rng.integers(0, 256, (4, 17)).astype(np.uint8)
    got = jnp_bits_to_bytes_array(torch.as_tensor(bits))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.jnp_bits_to_bytes_array(bits)))
    got = jnp_bytes_to_bits(torch.as_tensor(data))
    np.testing.assert_array_equal(got.numpy(), np.asarray(J.jnp_bytes_to_bits(data)))
    np.testing.assert_array_equal(jnp_bits_to_bytes_array(got).numpy(), data)


@pytest.mark.parametrize("name,flag", [("stream_main", "--stream"),
                                       ("ofdm_stream_main", "--ofdm-stream")])
def test_scaling_bench_entry_functions_forward_to_run(name, flag, monkeypatch):
    """The reference's ``stream_main``/``ofdm_stream_main`` exist in the
    port's ``scaling_bench`` and call its ``run`` with their mode's flag,
    then any options given."""
    from ria_tpu_torch.tools import scaling_bench

    seen = []
    monkeypatch.setattr(scaling_bench, "run", lambda argv=None: seen.append(argv) or ["rows"])
    assert getattr(scaling_bench, name)() == ["rows"]
    assert getattr(scaling_bench, name)(["--device", "cpu"]) == ["rows"]
    assert seen == [[flag], [flag, "--device", "cpu"]]
