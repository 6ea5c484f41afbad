"""Hybrid-family parity: the port's zamba2 model (Mamba2 layers through the
SSD scan, the shared attention block through flash) against the JAX
package's ``zamba`` on the reduced config."""

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

ARCH = "zamba2-2.7b"


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
