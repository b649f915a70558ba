"""The reduction of a trace to busy time, idle gaps and device time by kernel."""

import pytest
import torch

from perfbench import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, dev=CPU, annotation=False):
        self._n, self._s, self._d, self._dev, self._a = name, start, dur, dev, annotation

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return self._a


def test_summary_of_a_small_trace():
    evs = [Ev(trace.WINDOW, 0, 1000), Ev(trace.WINDOW, 0, 1000, CUDA, True),
           Ev("epoch", 100, 800), Ev("cudaLaunchKernel", 150, 30),
           Ev("void sgd::(anonymous namespace)::head_step_resident<__nv_bfloat16, 1>(HeadArgs)", 200, 200, CUDA),
           Ev("coo_forward", 300, 150, CUDA), Ev("Memcpy HtoD", 700, 100, CUDA)]
    s = trace.summarize(evs)
    assert s.window_s == pytest.approx(1e-6)
    assert s.busy_s == pytest.approx(3.5e-7)  # [200, 450) and [700, 800)
    assert len(s.kernels()) == 2
    assert s.device_seconds(("head_step_resident", "sum_partials")) == pytest.approx(2e-7)
    b = s.breakdown()
    assert b["device_ops"][0] == ["sgd::head_step_resident", pytest.approx(2e-7)]
    gaps = dict(b["idle_gaps"])
    assert gaps == {"epoch": pytest.approx(6.5e-7)}  # [0, 200), [450, 700), [800, 1000)


def test_short_name():
    assert trace.short_name("void sgd::(anonymous namespace)::head_corr_streamed<__nv_bfloat16, 4>(StreamArgs)") \
        == "sgd::head_corr_streamed"
    assert trace.short_name("std::enable_if<!(false), void>::type internal::gemvx::kernel<int, float>(int)") \
        == "internal::gemvx::kernel"
    assert trace.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD"
    assert trace.short_name("nvjet_tss_128x8_64x12_2x1_v_bz_NNT") == "nvjet_tss_128x8_64x12_2x1_v_bz_NNT"
