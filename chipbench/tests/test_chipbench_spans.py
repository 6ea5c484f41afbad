"""CPU tests of the device time by program span (``chipbench.spans``):
events built as torch gives them, with correlation ids, sequence numbers
and threads; and one end-to-end case, a small model under the CPU
profiler, whose host ops stand in for the kernels they would launch."""

from __future__ import annotations

import dataclasses
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from chipbench import spans, trace

US = 1000
MAIN, ENGINE = 1, 2  # the profiler's thread ids: the caller's, the autograd engine's


def _event(name, kind, start, dur, tid=MAIN, corr=0, linked=0, seq=-1, fwd=0):
    cuda = kind in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
    dev = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=lambda: name, device_type=lambda: dev,
                           is_user_annotation=lambda: kind.endswith("user_annotation"),
                           start_ns=lambda: start, duration_ns=lambda: dur, start_thread_id=lambda: tid,
                           correlation_id=lambda: corr, linked_correlation_id=lambda: linked,
                           sequence_nr=lambda: seq, fwd_thread_id=lambda: fwd)


def _range(name, start, dur, corr, tid=MAIN):
    return _event(name, "user_annotation", start, dur, tid=tid, corr=corr)


def _bare(e):
    """``e`` without the correlation fields (the events of the older tests)."""
    return SimpleNamespace(name=e.name, device_type=e.device_type, is_user_annotation=e.is_user_annotation,
                           start_ns=e.start_ns, duration_ns=e.duration_ns)


def _step():
    """One microbatch: forward (attention with rope inside, an MLP), the
    backward pass on the engine's thread with one layer recomputed, and the
    optimizer; each kernel runs 10 us after its launch."""
    ev = [
        _range(trace.WINDOW, 0, 10_000 * US, 1),
        _range("chipbench.step", 10 * US, 9_900 * US, 2),
        _range("train.forward", 100 * US, 2_000 * US, 3),
        _range("model.attention", 200 * US, 800 * US, 4),
        _event("aten::mm", "cpu_op", 250 * US, 50 * US, corr=5, seq=40),  # q projection, makes node 40
        _event("k_qproj", "kernel", 260 * US, 100 * US, corr=900, linked=5),
        _range("model.rope", 400 * US, 200 * US, 6),
        _event("aten::mul", "cpu_op", 450 * US, 20 * US, corr=7, seq=41),
        _event("k_rope", "kernel", 460 * US, 30 * US, corr=901, linked=7),
        _range("model.mlp", 1_100 * US, 500 * US, 8),
        _event("aten::slice", "cpu_op", 1_050 * US, 10 * US, corr=9, seq=42),  # same number, no node
        _event("aten::mm", "cpu_op", 1_150 * US, 50 * US, corr=10, seq=42),  # makes node 42
        _event("k_mlp", "kernel", 1_160 * US, 300 * US, corr=902, linked=10),
        _range("train.backward", 3_000 * US, 4_000 * US, 11),
        _event(spans.BACKWARD + "MmBackward0", "cpu_op", 3_100 * US, 900 * US, tid=ENGINE, corr=12, seq=42, fwd=MAIN),
        _range("model.mlp", 3_150 * US, 200 * US, 13, tid=ENGINE),  # the recompute, inside the node
        _event("aten::mm", "cpu_op", 3_160 * US, 50 * US, tid=ENGINE, corr=14, seq=90),
        _event("k_recompute", "kernel", 3_170 * US, 150 * US, corr=903, linked=14),
        _event("aten::mm", "cpu_op", 3_500 * US, 50 * US, tid=ENGINE, corr=15),
        _event("k_mlp_grad", "kernel", 3_510 * US, 400 * US, corr=904, linked=15),
        _event(spans.BACKWARD + "MulBackward0", "cpu_op", 4_100 * US, 300 * US, tid=ENGINE, corr=16, seq=41, fwd=MAIN),
        _event("aten::mul", "cpu_op", 4_150 * US, 50 * US, tid=ENGINE, corr=17),
        _event("k_rope_grad", "kernel", 4_160 * US, 60 * US, corr=905, linked=17),
        _range("train.optimizer", 7_500 * US, 1_000 * US, 18),
        _event("aten::add_", "cpu_op", 7_600 * US, 20 * US, corr=19),
        _event("k_adamw", "kernel", 7_610 * US, 80 * US, corr=906, linked=19),
        # the flash kernel launched by the runtime inside model.attention with no op around it
        _event("cudaLaunchKernel", "cuda_runtime", 700 * US, 10 * US, corr=907),
        _event("flash_fwd_sm90_kernel", "kernel", 710 * US, 200 * US, corr=907),
        # the loss's copy to the host, in the harness's range only
        _event("aten::copy_", "cpu_op", 9_000 * US, 100 * US, corr=20),
        _event("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 9_010 * US, 5 * US, corr=908, linked=20),
        # an unlinked kernel, and one past the window (clipped away)
        _event("k_orphan", "kernel", 9_500 * US, 7 * US, corr=909, linked=777),
        _event("k_late", "kernel", 10_500 * US, 7 * US, corr=910, linked=19),
    ]
    return ev


def test_a_kernel_is_charged_to_the_innermost_program_range_of_its_launch():
    got = spans.by_span(_step())
    assert got["model.attention"] == pytest.approx((100 + 200) * 1e-6)  # q projection and flash (by the runtime call)
    assert got["model.rope"] == pytest.approx(30e-6)
    assert got["model.mlp"] == pytest.approx(300e-6)
    assert got["train.optimizer"] == pytest.approx(80e-6)
    assert got["chipbench.step"] == pytest.approx(5e-6)
    assert got["none"] == pytest.approx(7e-6)
    assert sum(got.values()) == pytest.approx(trace.reduce(_step()).busy_s)


def test_a_recompute_kernel_goes_to_recompute():
    got = spans.by_span(_step())
    assert got["recompute/model.mlp"] == pytest.approx(150e-6)
    assert "recompute/model.attention" not in got


def test_a_backward_kernel_goes_to_the_forward_span_of_its_sequence_number():
    got = spans.by_span(_step())
    # node 42 was made by the mm inside model.mlp, not by the slice that carried the number first
    assert got["backward/model.mlp"] == pytest.approx(400e-6)
    assert got["backward/model.rope"] == pytest.approx(60e-6)
    assert spans.coverage(got)["backward_model"] == pytest.approx(1.0)


def test_the_reduction_is_the_same_with_and_without_the_new_fields():
    full, bare = trace.reduce(_step()), trace.reduce([_bare(e) for e in _step()])
    assert (full.window_s, full.busy_s, full.by_op, full.gaps) == (bare.window_s, bare.busy_s, bare.by_op, bare.gaps)
    assert set(spans.by_span([_bare(e) for e in _step()])) == {"none"}  # no fields: nothing to tie


def test_readings():
    got = spans.by_span(_step())
    assert spans.reading("attention_ms.train", got, 2) == pytest.approx(1e3 * 300e-6 / 2)
    assert spans.reading("recompute_ms.train", got, 1) == pytest.approx(0.15)
    assert spans.reading("head_ms.score", got, 1) is None  # no such span: left out
    assert spans.reading("optimizer_ms.train", got, 0) is None
    assert spans.reading("mlp_ms.score", None, 1) is None  # a trace without by_span (a program without spans)
    assert spans.reading("mlp_ms.score", got, 1) == pytest.approx(0.3)


def _as_kernels(events):
    """The host ops of a CPU trace as the kernels they would launch: one
    device event an ``aten::`` op, over its interval, linked to it."""
    out = []
    for e in events:
        if not e.is_user_annotation() and e.name().startswith("aten::"):
            out.append(SimpleNamespace(name=lambda n=e.name(): "k:" + n, device_type=lambda: torch.autograd.DeviceType.CUDA,
                                       is_user_annotation=lambda: False, start_ns=e.start_ns, duration_ns=e.duration_ns,
                                       linked_correlation_id=e.correlation_id, correlation_id=lambda: 0))
    return list(events) + out


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(trace.WINDOW):
            with record_function("chipbench.step"):
                fn()
    return spans.by_span(_as_kernels(prof.profiler.kineto_results.events()))


def test_a_small_model_gives_every_metric_a_positive_time():
    from repro_torch.configs import get_arch
    from repro_torch.models import model as model_lib
    from repro_torch.optim import adamw
    from repro_torch.train import steps

    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(), n_layers=2, d_model=64,
                              param_dtype="float32", activation_dtype="float32")
    batch = model_lib.synthetic_batch(cfg, 4, 16, seed=5, device="cpu")
    score = model_lib.build_model(cfg, impl="kernel")
    params = score.init(3, "cpu")
    prefill = steps.make_prefill_step(score)
    got = {"score": _profiled(lambda: prefill(params, batch))}
    train = model_lib.build_model(cfg, impl="torch", remat="block")
    step = steps.make_train_step(train, adamw.AdamWConfig(), microbatches=2)
    state = adamw.init(params)
    got["train"] = _profiled(lambda: step(params, state, batch))
    for name in spans.METRICS:
        value = spans.reading(name, got[name.split(".")[1]], 1)
        assert value is not None and value > 0, name
    cover = spans.coverage(got["train"])
    assert cover["program"] > 0.9 and cover["backward_model"] > 0.9
    assert {k.split("/")[0] for k in got["train"]} >= {"recompute", "backward", "model.attention", "train.optimizer"}


def test_attribution_is_linear_enough_for_a_window():
    """30,000 launches (a train cell's window holds about 10^5) take well
    under a second a ten thousand."""
    events = [_range(trace.WINDOW, 0, 10**10, 1), _range("model.mlp", 0, 10**10, 2)]
    for i in range(30_000):
        events += [_event("aten::mm", "cpu_op", 10 + i * 1000, 100, corr=10 + i),
                   _event("k", "kernel", 20 + i * 1000, 500, corr=10**6 + i, linked=10 + i)]
    t = time.perf_counter()
    got = spans.by_span(events)
    assert time.perf_counter() - t < 10.0
    assert got == {"model.mlp": pytest.approx(30_000 * 500e-9)}
