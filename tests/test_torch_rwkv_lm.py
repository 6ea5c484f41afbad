"""RWKV-family parity: the port's rwkv6 LM (time mix through the RWKV6
scan) against the JAX package's ``rwkv_lm`` on the reduced config."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from torch_parity import (
    cfg_pair,
    check_decode_matches_prefill,
    check_decode_steps,
    check_forward,
    check_param_tree,
    check_serve_on_cpu,
)

ARCH = "rwkv6-3b"


def test_param_tree_matches_jax():
    check_param_tree(ARCH)


@pytest.mark.parametrize("reduced", [False, True])
def test_config_matches_jax(reduced):
    jcfg, tcfg = cfg_pair(ARCH, reduced=reduced)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_forward_matches_jax(impl):
    check_forward(ARCH, impl)


def test_forward_bf16_matches_jax():
    check_forward(ARCH, "kernel", f32=False, seed=1)


def test_decode_step_matches_jax_step_by_step():
    check_decode_steps(ARCH)


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_decode_matches_prefill(impl):
    check_decode_matches_prefill(ARCH, impl)


def test_serve_runs_on_cpu(capsys):
    check_serve_on_cpu(ARCH, capsys)


@pytest.mark.parametrize("fn,chunk", [("apply_rwkv_block", 32), ("apply_time_mix", 128)])
def test_chunk_defaults_match_jax(fn, chunk):
    """The block scans in chunks of 32 while ``apply_time_mix`` defaults to
    128 (repro/models/rwkv.py:133,192); the port keeps both."""
    import inspect

    from repro.models import rwkv as jr
    from repro_torch.models import rwkv as tr

    for mod in (jr, tr):
        assert inspect.signature(getattr(mod, fn)).parameters["chunk"].default == chunk
