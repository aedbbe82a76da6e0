"""The trace reduction on a synthetic profile: busy time is the union of
device intervals inside the window (overlaps once), and each idle gap
goes to the host span under it."""
import types

import pytest
from torch.autograd import DeviceType

from bench import trace as T


class Ev:
    def __init__(self, name, dev, s_us, e_us):
        self._n, self._d, self._s, self._e = name, dev, s_us, e_us

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return int(self._s * 1000)

    def duration_ns(self):
        return int((self._e - self._s) * 1000)


def fake_prof(events):
    res = types.SimpleNamespace(events=lambda: events)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=res))


CPU, GPU = DeviceType.CPU, DeviceType.CUDA


def test_union_and_gaps():
    evs = [Ev("gemm", GPU, 990, 1002), Ev("gemm", GPU, 1010, 1040),
           Ev("varlen_flash_kernel", GPU, 1030, 1050),
           Ev("gemm", GPU, 1095, 1120), Ev("cudaLaunchKernel", CPU, 1, 2)]
    spans = [("runner.dispatch", 1000e-6, 1030e-6),
             ("scheduler.schedule", 1060e-6, 1090e-6)]
    data = T.reduce(fake_prof(evs), spans, (1000e-6, 1100e-6))
    assert data.window_s == pytest.approx(100e-6)
    # device busy [1000, 1002], [1010, 1050] and [1095, 1100] (clipped)
    assert data.busy_s == pytest.approx(47e-6)
    assert data.kernel_seconds("varlen_flash_kernel") == pytest.approx(20e-6)
    b = T.breakdown(data)
    ops = dict(b["device_ops"])
    assert set(ops) == {"gemm", "varlen_flash_kernel"}
    assert ops["gemm"] == pytest.approx(37e-6)
    idle = dict(b["idle_gaps"])
    # gaps [1002, 1010] under dispatch, [1050, 1095] under schedule
    assert idle["runner.dispatch"] == pytest.approx(8e-6)
    assert idle["scheduler.schedule"] == pytest.approx(45e-6)
    assert set(idle) == {"runner.dispatch", "scheduler.schedule"}
