"""The kernel comparison tool, ``python -m ria_tpu_torch.tools.kernel_compare``, on a host with no card.

The tool itself runs only on a CUDA host (tests/test_torch_ldpc_cuda.py and
chip_smoke.py cover the kernels there); here it must import, parse its
arguments, and refuse what it cannot compare before it builds anything.
"""

import pytest
import torch

from ria_tpu_torch.fec import ldpc_kernel
from ria_tpu_torch.tools import kernel_compare

torch.set_num_threads(1)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("kernel_compare built a library")

    monkeypatch.setattr(ldpc_kernel, "compile_libraries", refuse)


@pytest.mark.parametrize("argv", [["--kernel", "k3", "build/x.cu"], ["build/x.cu"],
                                  ["--kernel", "k2"]])
def test_rejects_bad_arguments_before_building(argv, no_build, capsys):
    with pytest.raises(SystemExit) as e:
        kernel_compare.run(argv)
    assert e.value.code == 2
    assert "usage" in capsys.readouterr().err


def test_parses_kernel_and_defines():
    args = kernel_compare._parse(["--kernel", "k2", "--define", "K2_SPECULATE=0",
                                  "--define", "K2_SENTINELS=0", "build/before.cu"])
    assert args.kernel == "k2" and args.define == ["K2_SPECULATE=0", "K2_SENTINELS=0"]
    assert set(kernel_compare.KERNELS) == {"k1", "k2"}


def test_defines_build_a_library_of_their_own():
    src = ldpc_kernel._SOURCE_V1
    plain = ldpc_kernel.library_path(src)
    variant = ldpc_kernel.library_path(src, ("-DK2_SPECULATE=0",))
    assert plain == ldpc_kernel.library_path(src, ()) != ldpc_kernel.library_path()
    assert variant != plain and variant.parent == plain.parent


def test_every_k2_switch_defaults_to_the_design():
    """Each K2_* switch the tool's --define names is a macro of K2's source
    that defaults to the design (1, or 4 blocks per SM)."""
    text = ldpc_kernel._SOURCE_V1.read_text()
    for name, default in (("K2_SPECULATE", 1), ("K2_SENTINELS", 1), ("K2_V2C_REGS", 1),
                          ("K2_TABLES_RESIDENT", 1), ("K2_MIN_BLOCKS", 4)):
        assert f"#ifndef {name}" in text and f"#define {name} {default}\n" in text
