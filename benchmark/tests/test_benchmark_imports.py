"""What the benchmark loads: no module whose top-level name is ``jax``,
``jaxlib``, ``flax`` or ``ria_tpu`` (names compared whole: ``ria_tpu_torch``
is the port and allowed), and, for the reference, nothing of the port."""

import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "benchmark"


def _loaded(code: str) -> set[str]:
    """Top-level names of the modules a fresh interpreter holds after ``code``."""
    probe = code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                         text=True, check=True, timeout=300)
    return set(out.stdout.split())


def test_harness_and_every_file_it_loads():
    files = [p for sub in ("entries", "generators", "metrics")
             for p in sorted((HERE / sub).glob("*.py"))]
    code = ("import sys; sys.path.insert(0, '.')\n"
            "from benchmark import harness, calibrate, roofline, tracing\n"
            "from benchmark.reference import chains, ldpc_plain\n"
            + "".join(f"harness.load_module(__import__('pathlib').Path({str(p)!r}))\n"
                      for p in files)
            + "from ria_tpu_torch.phy import pipeline\nfrom ria_tpu_torch.fec import ldpc\n")
    tops = _loaded(code)
    assert not tops & {"jax", "jaxlib", "flax", "ria_tpu"}, tops
    assert "ria_tpu_torch" in tops


def test_reference_imports_nothing_of_the_port():
    mods = [p.stem for p in sorted((HERE / "reference").glob("*.py")) if p.stem != "__init__"]
    tops = _loaded("import sys; sys.path.insert(0, '.')\n"
                   + "".join(f"import benchmark.reference.{m}\n" for m in mods)
                   + "from benchmark.generators import air, llr\n")
    assert not tops & {"jax", "jaxlib", "flax", "ria_tpu", "ria_tpu_torch"}, tops


def test_forbidden_names_compare_whole(monkeypatch):
    from benchmark import harness

    for name in ("ria_tpu_torch", "ria_tpu_torch.fec", "jaxlib_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ria_tpu.fec", sys)
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert harness.forbidden_modules() == ["flax", "ria_tpu"]
