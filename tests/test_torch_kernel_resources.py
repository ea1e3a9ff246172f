"""tools/kernel_resources.py: the parser of ``nvcc -Xptxas -v`` output that
the register counts in the kernel sources' notes come from (the compile
itself needs the CUDA toolkit and runs on the card's machine)."""

import pytest

from audio_style_transfer_tpu_torch.tools import kernel_resources

LOG = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN1a15gram_bwd_kernelIfLi32EEEvv' for 'sm_90a'
ptxas info    : Function properties for _ZN1a15gram_bwd_kernelIfLi32EEEvv
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 186 registers, used 1 barriers
ptxas info    : Compile time = 210.114 ms
ptxas info    : Compiling entry function '_ZN1a18gram_reduce_kernelEPKfPfiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN1a18gram_reduce_kernelEPKfPfiiii
    24 bytes stack frame, 20 bytes spill stores, 24 bytes spill loads
ptxas info    : Used 32 registers, used 0 barriers, 4096 bytes smem
"""


def test_parse_ptxas_reads_registers_spills_and_shared_memory():
    assert kernel_resources.parse_ptxas(LOG) == [
        ("_ZN1a15gram_bwd_kernelIfLi32EEEvv", 186, 0, 0, 0),
        ("_ZN1a18gram_reduce_kernelEPKfPfiiii", 32, 20, 24, 4096),
    ]


@pytest.mark.parametrize("log", ["", "ptxas info    : Used 12 registers\n"])
def test_parse_ptxas_ignores_lines_outside_an_entry_function(log):
    assert kernel_resources.parse_ptxas(log) == []
