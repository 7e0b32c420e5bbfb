"""Three steps of the port's ``make_train_step`` with ``DisketchCompressor``
(the launcher's settings: width D // 64, depth 4, 2 subepochs, 5%
recovered a step) against the reference's jitted step with its
compressor, for every arch at ``reduced``: ``three_steps`` of
``tests/test_torch_train_step.py``, whose docstring states the
tolerances.  A module of its own so that a parallel test run can hold
the two halves on two workers (each compiles ten reference steps).
"""
import pytest

from repro.configs import list_configs as ref_list_configs
from test_torch_train_step import three_steps
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("name", ref_list_configs())
def test_three_compressed_steps_match_reference(name):
    three_steps(name, compress=True)
