"""The reduction of a profiler trace, on a hand-made one: busy time is
the union of the device's intervals inside the window, idle time is split
by the span the host was in, and the profiler's own events do not count."""
import pytest
from torch.autograd import DeviceType

from perfbench.trace import WINDOW_SPAN, reduce_profile


class Ev:
    def __init__(self, name, dev, a, b, annotation=False):
        self._n, self._d, self._a, self._b = name, dev, a, b
        self._ann = annotation

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def is_user_annotation(self):
        return self._ann


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_reduce_profile():
    evs = [Ev(WINDOW_SPAN, CPU, 0, 1000),
           Ev("pack_streams", CPU, 0, 200),
           Ev("run_window", CPU, 200, 900),
           Ev("run_window", GPU, 200, 900, annotation=True),
           Ev("Activity Buffer Request", GPU, 0, 1000),
           Ev("aten::add", CPU, 300, 310),
           Ev("fleet_ragged_kernel(...)", GPU, 300, 400),
           Ev("fill", GPU, 350, 450),
           Ev("Memcpy DtoH (Device -> Pageable)", GPU, 800, 850),
           Ev("late", GPU, 990, 1100)]
    r = reduce_profile(evs, {"pack_streams", "run_window"})
    assert r["window_s"] == pytest.approx(1000e-9)
    # [300, 450) + [800, 850) + [990, 1000)
    assert r["busy_s"] == pytest.approx(210e-9)
    assert r["d2h"] == 1
    assert r["kernel_s"]["fill"] == pytest.approx(100e-9)
    assert r["kernel_s"]["late"] == pytest.approx(10e-9)
    idle = dict(r["idle_gaps"])
    assert idle["pack_streams"] == pytest.approx(200e-9)
    assert idle["run_window"] == pytest.approx(100e-9 + 350e-9 + 50e-9)
    assert idle["harness"] == pytest.approx(90e-9)
    assert r["device_ops"][0][0] == "fill" or \
        r["device_ops"][0][0].startswith("fleet_ragged_kernel")


def test_a_trace_without_its_window_is_refused():
    with pytest.raises(RuntimeError, match="window"):
        reduce_profile([Ev("x", GPU, 0, 1)], set())
