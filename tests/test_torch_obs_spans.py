"""The port's spans (``repro_torch.obs.trace``) on the model path, on the
CPU: a shared no-op with the tracer and the profiler off, a
``torch.profiler`` range of the same name while a profiler is active,
stamped on the profiler's clock while the tracer records; every span of
the transformer, the train step and AdamW opens where it should (block
remat's recompute inside ``train.backward``), and a profiled step gives
the same numbers bit for bit."""

from __future__ import annotations

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import obs, tree  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.obs.trace import _NOOP  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.train import steps  # noqa: E402

MODEL_SPANS = {"model.embed", "model.norm", "model.attention", "model.rope", "model.mlp", "model.residual",
               "model.head", "model.loss"}
TRAIN_SPANS = {"train.forward", "train.backward", "train.accumulate", "train.optimizer"}


@pytest.fixture(autouse=True)
def _tracer_off():
    obs.disable_tracing()
    obs.TRACER.clear()
    yield
    obs.disable_tracing()
    obs.TRACER.clear()


def _ranges(prof):
    """(name, thread, start_ns, end_ns) of every user range the profiler saw."""
    return [(e.name(), e.start_thread_id(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def _inside(inner, outer) -> bool:
    return inner[1] == outer[1] and outer[2] <= inner[2] and inner[3] <= outer[3]


def _small(arch: str = "granite-3-8b", **kw):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, n_layers=2, d_model=64, param_dtype="float32", activation_dtype="float32", **kw)


def test_both_off_gives_the_shared_noop_and_nothing_is_recorded():
    span = obs.trace("model.norm")
    assert span is _NOOP and obs.TRACER.span("x") is _NOOP
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span:
            torch.ones(3).sum()
    assert not [r for r in _ranges(prof) if r[0] == "model.norm"]
    assert obs.TRACER.events() == []


def test_profiler_alone_opens_a_range_of_the_name():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace("model.attention") as span:
            torch.ones(3).sum()
    assert span is not _NOOP
    assert [r[0] for r in _ranges(prof)] == ["model.attention"]
    assert obs.TRACER.events() == []  # the tracer stays off


def test_tracer_and_profiler_share_a_clock():
    obs.enable_tracing(clear=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.trace("train.optimizer"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    obs.disable_tracing()
    (event,) = obs.TRACER.events()
    (rng,) = [r for r in _ranges(prof) if r[0] == "train.optimizer"]
    assert abs(event["ts"] * 1e3 - rng[2]) < 1e6  # within 1 ms, both in ns since the Unix epoch
    assert abs(event["dur"] * 1e3 - (rng[3] - rng[2])) < 1e6


def test_timer_measures_on_the_monotonic_clock_and_stamps_on_the_profilers():
    obs.enable_tracing(clear=True)
    with obs.timer("phase") as t:
        torch.ones(8).sum()
    obs.disable_tracing()
    (event,) = obs.TRACER.events()
    assert event["dur"] == pytest.approx(t.elapsed * 1e6, abs=1e-3)
    assert event["ts"] > 1.6e15  # microseconds on the Unix clock (after 2020)


def _one_step(profiled: bool):
    cfg = _small()
    model = model_lib.build_model(cfg, impl="torch", remat="block")
    params = model.init(7, "cpu")
    step = steps.make_train_step(model, adamw.AdamWConfig(warmup_steps=0), microbatches=2)
    batch = model_lib.synthetic_batch(cfg, 4, 16, seed=3, device="cpu")
    state = adamw.init(params)
    if not profiled:
        return step(params, state, batch), None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(params, state, batch)
    return out, prof


def test_train_step_opens_every_span_and_gives_the_same_numbers():
    (p_on, s_on, m_on), prof = _one_step(True)
    (p_off, s_off, m_off), _ = _one_step(False)
    ranges = _ranges(prof)
    names = {r[0] for r in ranges}
    assert MODEL_SPANS | TRAIN_SPANS <= names
    by = lambda n: [r for r in ranges if r[0] == n]
    attention = by("model.attention")
    assert all(any(_inside(r, a) for a in attention) for r in by("model.rope"))
    backward = by("train.backward")
    assert len(backward) == 2 and len(by("train.forward")) == 2  # one a microbatch
    # block remat reruns each layer's spans inside the backward pass
    during = lambda n: [r for r in by(n) if any(b[2] <= r[2] < b[3] for b in backward)]
    # (the layer's last add is not: the checkpoint stops once the saved tensors are back)
    for name, per_layer in (("model.attention", 1), ("model.rope", 1), ("model.mlp", 1), ("model.norm", 2),
                            ("model.residual", 1)):
        assert len(during(name)) == 2 * 2 * per_layer, name  # microbatches x layers x spans a layer
    assert not during("model.head") and not during("model.embed")
    assert torch.equal(m_on["loss"], m_off["loss"])
    for a, b in zip(tree.leaves(p_on) + tree.leaves(s_on.m), tree.leaves(p_off) + tree.leaves(s_off.m)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,ffn", [("granite-3-8b", "model.mlp"), ("mixtral-8x7b", "model.moe")])
def test_forward_spans_by_block_kind(arch, ffn):
    cfg = dataclasses.replace(get_arch(arch).reduced(), n_layers=2)
    model = model_lib.build_model(cfg, impl="torch")
    params = model.init(1, "cpu")
    batch = model_lib.synthetic_batch(cfg, 2, 16, seed=2, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        steps.make_prefill_step(model)(params, batch)
    names = [r[0] for r in _ranges(prof)]
    assert names.count("model.attention") == names.count("model.rope") == names.count(ffn) == 2
    assert names.count("model.norm") == 5 and names.count("model.residual") == 4
    assert names.count("model.head") == 1 and names.count("model.embed") == 1
    assert not {"model.mlp", "model.moe"} - {ffn} & set(names)


def test_the_residual_span_frees_the_attention_output_before_the_mlp(monkeypatch):
    """The block's ``model.residual`` add leaves no reference to the
    attention sublayer's output: at full width it is a whole activation
    (2.4 GB of granite's 72 x 4096 batch), and held through the MLP it
    raised the prompt forward's peak by as much."""
    import weakref

    from repro_torch.models import transformer

    cfg = dataclasses.replace(get_arch("granite-3-8b").reduced(), n_layers=1)
    params = model_lib.build_model(cfg).init(1, "cpu")
    refs, alive = [], []
    run_attention, ffn = transformer.run_attention, transformer._ffn

    def attention(*args):
        out = run_attention(*args)
        refs.append(weakref.ref(out))
        return out

    def mlp(*args):
        alive.append(refs[-1]() is not None)
        return ffn(*args)

    monkeypatch.setattr(transformer, "run_attention", attention)
    monkeypatch.setattr(transformer, "_ffn", mlp)
    batch = model_lib.synthetic_batch(cfg, 2, 16, seed=2, device="cpu")
    with torch.inference_mode():
        transformer.forward(params, cfg, batch, impl="torch")
    assert alive == [False]
