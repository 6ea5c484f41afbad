"""Strassen-Winograd and the CAPS model (the paper's Experiment B): the
port's ``repro_torch.core.strassen`` against the JAX package's
``repro.core.strassen`` on the same numpy inputs."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import bgq as jax_bgq
from repro.core import strassen as jax_strassen
from repro_torch.core import strassen

F32_TOL = 2e-4


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_strassen_winograd_matches_jax(depth):
    """n = 64, float32: the port against JAX's recursion within 2e-4
    relative to max |JAX|, and both against the float64 product."""
    rng = np.random.default_rng(depth)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    want = np.asarray(jax_strassen.strassen_winograd(jnp.asarray(a), jnp.asarray(b), depth))
    got = strassen.strassen_winograd(torch.from_numpy(a), torch.from_numpy(b), depth).numpy()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() / scale < F32_TOL
    exact = a.astype(np.float64) @ b.astype(np.float64)
    assert np.abs(got - exact).max() / np.abs(exact).max() < 1e-5


def test_strassen_rectangular_matches_the_product():
    """(32, 16) x (16, 48) at depth 2 against the float64 product."""
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((32, 16)), rng.standard_normal((16, 48))
    got = strassen.strassen_winograd(torch.from_numpy(a), torch.from_numpy(b), 2).numpy()
    np.testing.assert_allclose(got, a @ b, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape_a,shape_b", [((63, 64), (64, 64)), ((64, 63), (63, 64)), ((64, 64), (64, 65))])
def test_odd_dimensions_raise(shape_a, shape_b):
    with pytest.raises(ValueError, match="even"):
        strassen.strassen_winograd(torch.zeros(shape_a), torch.zeros(shape_b), 1)
    # JAX asserts the same
    with pytest.raises(AssertionError):
        jax_strassen.strassen_winograd(jnp.zeros(shape_a), jnp.zeros(shape_b), 1)


@pytest.mark.parametrize("n,depth", [(64, 0), (64, 2), (512, 3), (16384, 2), (9408, 1)])
def test_strassen_flops_equal_jax(n, depth):
    assert strassen.strassen_flops(n, depth) == jax_strassen.strassen_flops(n, depth)


def _jax_mira_cells():
    """benchmarks/matmul_scaling.py:42-47, priced through the JAX package."""
    p = jax_bgq.partition_bisection_links
    return [
        (4, p((4, 1, 1, 1)), p((2, 2, 1, 1))),
        (8, p((4, 2, 1, 1)), p((2, 2, 2, 1))),
        (16, p((4, 4, 1, 1)), p((2, 2, 2, 2))),
        (24, p((4, 3, 2, 1)), p((3, 2, 2, 2))),
    ]


def test_mira_cells_equal_the_benchmarks():
    assert strassen.mira_caps_cells() == _jax_mira_cells()


@pytest.mark.parametrize("phi,comm_over_comp", [(0.45, 0.5), (0.37, 0.5), (0.52, 1.0)])
def test_caps_comm_model_equals_jax(phi, comm_over_comp):
    cells = strassen.mira_caps_cells()
    got = strassen.caps_comm_model(cells, phi=phi, comm_over_comp=comm_over_comp)
    want = jax_strassen.caps_comm_model(_jax_mira_cells(), phi=phi, comm_over_comp=comm_over_comp)
    assert [dataclasses.astuple(p) for p in got] == [dataclasses.astuple(p) for p in want]


def test_caps_model_lands_in_the_papers_bands():
    """matmul_scaling.py:65-67: the three x2-bisection cells."""
    preds = strassen.caps_comm_model(strassen.mira_caps_cells(), phi=0.45, comm_over_comp=0.5)
    for p in preds[:3]:
        assert p.bisection_ratio == 2.0
        assert 1.37 <= p.comm_ratio <= 1.52
        assert 1.08 <= p.wallclock_ratio <= 1.22
