"""The traced window's reduction: spans, the harness's or the program's,
are annotations over the device's timeline and never device work."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
import torch

from h100bench import trace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


def event(name, start, end, device, **kind):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start, end=end),
                           **kind)


HOST = [event("aten::mm", 0, 50, CPU, is_user_annotation=False),
        event("calciumgan_tpu_torch/step", 0, 1000, CPU,
              is_user_annotation=True)]
KERNELS = [event("gemm", 0, 100, CUDA, is_user_annotation=False),
           event("Memcpy DtoH", 300, 400, CUDA, is_user_annotation=False)]


def test_a_program_span_leaves_busy_time_as_it_was():
    alone = trace.summarize(HOST + KERNELS, 1e-3)
    spans = [event("calciumgan_tpu_torch/step", 0, 1000, CUDA,
                   is_user_annotation=True),
             event("h100bench/train_step", 0, 1000, CUDA,
                   is_user_annotation=True)]
    spanned = trace.summarize(HOST + KERNELS + spans, 1e-3)
    assert alone["busy_s"] == spanned["busy_s"] == pytest.approx(200e-6)
    assert alone["device_ops"] == spanned["device_ops"]
    assert [n for n, _ in spanned["device_ops"]] == ["gemm", "Memcpy DtoH"]


def test_without_a_recorded_kind_a_host_name_marks_a_span():
    span = event("calciumgan_tpu_torch/step", 0, 1000, CUDA)
    kernel = event("gemm", 0, 100, CUDA)
    assert trace.device_work(HOST + [span, kernel]) == [kernel]


def test_the_profiler_records_a_span_as_an_annotation():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("calciumgan_tpu_torch/phase"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    events = list(prof.events())
    span, = [e for e in events if e.name == "calciumgan_tpu_torch/phase"]
    assert trace.is_annotation(span)
    assert not any(trace.is_annotation(e) for e in events
                   if e.name == "aten::matmul")
