"""The trace's reduction to the seconds in which the device ran anything."""

from __future__ import annotations

from torch.autograd import DeviceType

from benchmark import trace_summary


class _Event:
    """A stand-in for the profiler's raw event."""

    def __init__(self, device, start_ns, duration_ns, annotation=False):
        self._d, self._s, self._n, self._a = (device, start_ns, duration_ns,
                                              annotation)

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._n

    def is_user_annotation(self):
        return self._a


def test_device_busy_counts_overlaps_once_and_device_events_alone():
    cuda, cpu = DeviceType.CUDA, DeviceType.CPU
    events = [
        _Event(cuda, 0, 1_000_000_000),            # 0.0-1.0 s
        _Event(cuda, 500_000_000, 1_000_000_000),  # 0.5-1.5 s, overlaps
        _Event(cuda, 3_000_000_000, 250_000_000),  # 3.0-3.25 s
        _Event(cpu, 0, 9_000_000_000),             # the host's, not counted
        _Event(cuda, 0, 9_000_000_000, True),      # an annotation
    ]
    assert abs(trace_summary.device_busy_s(events) - 1.75) < 1e-12


def test_device_busy_of_no_device_activity_is_zero():
    assert trace_summary.device_busy_s(
        [_Event(DeviceType.CPU, 0, 10)]) == 0.0
