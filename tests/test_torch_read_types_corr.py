"""The corrected overlay (`--nano-corr`: w = 5 minimizers, base-level
alignment, the r94 matrix) end to end on the CPU, byte-identical to
`flye_tpu` (see test_torch_read_types.py).  A small input: the
base-level alignment is the CPU path's cost."""

import pytest

from test_torch_read_types import (OUTPUTS, assert_same, cpu_runtime,  # noqa: F401
                                   read_type_runs)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return read_type_runs(tmp_path_factory.mktemp("nano_corr"),
                          ["--nano-corr"], 14000, 16, 6000, 0.01)


@pytest.mark.parametrize("rel", OUTPUTS)
def test_nano_corr_byte_identical(runs, rel):
    assert_same(runs, rel)
