"""The trunk kernels' CUDA function names, read from the sources on the CPU.

The benchmark's trace reader (``portbench/trace.py``) finds K1 and K2's two
phases by fragments of these names, and sorts every kernel into the port's
own (``OWN_WORDS``) or a matrix product (``PRODUCT_WORDS``) by words in its
name. A renamed kernel, or a library type among a kernel's template
arguments, would move the trunk's time out of ``trunk_roofline`` or into the
decoder's products without a failing card test; these tests catch it here.
"""

import re
from pathlib import Path

import pytest

from portbench import trace

CSRC = Path(__file__).resolve().parents[1] / "audio_style_transfer_tpu_torch" / "csrc"
GLOBAL = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(")


def kernel_names(source: str) -> list:
    """The ``__global__`` functions declared in csrc/<source>."""
    return GLOBAL.findall((CSRC / source).read_text())


TENSOR_CORE = kernel_names("trunk_mma.cu")
FMA = kernel_names("trunk.cu")


def test_the_sources_declare_the_trunk_kernels():
    assert {"trunk_fwd_mma_kernel", "trunk_bwd_dy_mma_kernel", "trunk_bwd_dx_mma_kernel",
            "encoder_bwd_dy_mma_kernel"} <= set(TENSOR_CORE)
    assert len(TENSOR_CORE) == len(set(TENSOR_CORE)) == 4


@pytest.mark.parametrize("key", ["K1", "K2", "K2dx"])
def test_each_trunk_fragment_of_the_trace_reader_names_a_kernel(key):
    """Every fragment names a kernel of the tensor-core file or of the FMA
    file; the tensor-core fragment names one of the tensor-core file."""
    frags = trace.KERNELS[key]
    for frag in frags:
        assert any(frag in name for name in TENSOR_CORE + FMA), (key, frag)
    assert any(frag in name for frag in frags if "mma" in frag for name in TENSOR_CORE), key


@pytest.mark.parametrize("name", TENSOR_CORE)
def test_trunk_kernel_names_are_the_ports_own_and_no_product(name):
    assert any(name.startswith(word) for word in trace.OWN_WORDS), name
    assert trace.is_own(name) and not trace.is_product(name), name
