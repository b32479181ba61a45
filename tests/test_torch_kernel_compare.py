"""The kernel comparison tool, ``python -m ria_tpu_torch.tools.kernel_compare``, on a host with no card.

The tool itself runs only on a CUDA host (tests/test_torch_ldpc_cuda.py and
chip_smoke.py cover the kernels there); here it must import, parse its
arguments, and refuse what it cannot compare before it builds anything.
"""

import pytest
import torch

from ria_tpu_torch.tools import kernel_compare
from ria_tpu_torch.utils import cuda_kernels

torch.set_num_threads(1)


@pytest.fixture
def no_build(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("kernel_compare built a library")

    monkeypatch.setattr(cuda_kernels, "compile_libraries", refuse)


@pytest.mark.parametrize("argv", [["--kernel", "k3", "build/x.cu"], ["build/x.cu"],
                                  ["--kernel", "k2"],
                                  ["--kernel", "k1", "--precision", "bf16", "build/x.cu"],
                                  ["--kernel", "k1", "--precision", "fp16", "--interface",
                                   "tables", "build/x.cu"],
                                  ["--kernel", "k2", "--interface", "packed", "build/x.cu"]])
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
    src = cuda_kernels.LIBRARIES["ldpc_bp_v1"][0]
    plain = cuda_kernels.library_path(src)
    variant = cuda_kernels.library_path(src, ("-DK2_SPECULATE=0",))
    assert plain == cuda_kernels.library_path(src, ()) != cuda_kernels.library_path(
        cuda_kernels.LIBRARIES["ldpc_bp"][0])
    assert variant != plain and variant.parent == plain.parent


def test_every_k2_switch_defaults_to_the_design():
    """Each K2_* switch the tool's --define names is a macro of K2's source
    that defaults to the design (1, or 4 blocks per SM)."""
    text = cuda_kernels.LIBRARIES["ldpc_bp_v1"][0].read_text()
    for name, default in (("K2_SPECULATE", 1), ("K2_SENTINELS", 1), ("K2_V2C_REGS", 1),
                          ("K2_TABLES_RESIDENT", 1), ("K2_MIN_BLOCKS", 4)):
        assert f"#ifndef {name}" in text and f"#define {name} {default}\n" in text


def test_parses_interface_and_precision():
    args = kernel_compare._parse(["--kernel", "k1", "--interface", "tables", "--precision",
                                  "bf16", "build/ldpc_bp_before.cu"])
    assert (args.kernel, args.interface, args.precision) == ("k1", "tables", "bf16")
    args = kernel_compare._parse(["--kernel", "k2", "build/before.cu"])
    assert (args.interface, args.precision) == ("lists", "f32")


@pytest.mark.parametrize("kernel", ["k1", "k2"])
def test_bf16_compares_the_earlier_source_built_as_before_with_the_checkouts_bf16_source(kernel):
    """--precision bf16 builds the earlier source with -DRIA_BF16_OPERANDS (the
    bf16 builds up to commit 137700e) and the checkout's bf16 library of the
    kernel, which is a source of its own with no define."""
    name, libraries, _ = kernel_compare.KERNELS[kernel]
    assert kernel_compare.BEFORE_DEFINES == {"f32": (), "bf16": ("-DRIA_BF16_OPERANDS",)}
    f32_src, f32_defs = cuda_kernels.LIBRARIES[libraries["f32"]]
    bf16_src, bf16_defs = cuda_kernels.LIBRARIES[libraries["bf16"]]
    assert f32_src.stem == name and bf16_src.stem == f"{name}_bf16"
    assert f32_defs == bf16_defs == () and bf16_src.exists()
    before = cuda_kernels.library_path(f32_src, kernel_compare.BEFORE_DEFINES["bf16"])
    assert before not in (cuda_kernels.library_path(f32_src), cuda_kernels.library_path(bf16_src))


def test_sass_instructions_drop_names_and_headers():
    listing = """
\tcode for sm_90a
\t\tFunction : _ZN48_INTERNAL_abc_ldpc_bp_kernelEv
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;       /* 0x00000a00ff017b82 */
                                                                /* 0x000fe40000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;           /* 0x0000000000007919 */
"""
    got = kernel_compare.instructions(listing)
    assert len(got) == 2 and got[0].startswith("/*0000*/") and "Function" not in "".join(got)
    renamed = listing.replace("_ZN48_INTERNAL_abc_", "_ZN48_INTERNAL_xyz_")
    assert kernel_compare.instructions(renamed) == got
