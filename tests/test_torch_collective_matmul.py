"""Collective-matmul rings: the port's ``torch.distributed`` rings on a
one-rank gloo group against JAX's one-device mesh, and on 8 spawned gloo
processes against the float64 product, with the exchanges they trace
(counterpart of tests/test_collective_matmul.py)."""

import os
import re
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro.distributed.collective_matmul import allgather_matmul as jax_allgather_matmul
from repro.distributed.collective_matmul import matmul_reducescatter as jax_matmul_reducescatter
from repro_torch.analysis.roofline import CollectiveTrace
from repro_torch.distributed.collective_matmul import allgather_matmul, matmul_reducescatter

SRC = Path(__file__).resolve().parents[1] / "src"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture
def one_rank_group():
    """A one-rank gloo default group, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_single_rank_matches_jax_one_device_mesh(one_rank_group):
    """rtol 1e-5, as tests/test_collective_matmul.py:16-29."""
    mesh = jax.make_mesh((1,), ("model",))
    rng = np.random.default_rng(0)
    x, w = rng.standard_normal((8, 4), dtype=np.float32), rng.standard_normal((4, 6), dtype=np.float32)
    want = np.asarray(jax_allgather_matmul(jnp.asarray(x), jnp.asarray(w), mesh, "model"))
    got = allgather_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    x2, w2 = rng.standard_normal((8, 16), dtype=np.float32), rng.standard_normal((16, 6), dtype=np.float32)
    want2 = np.asarray(jax_matmul_reducescatter(jnp.asarray(x2), jnp.asarray(w2), mesh, "model"))
    got2 = matmul_reducescatter(torch.from_numpy(x2), torch.from_numpy(w2))
    np.testing.assert_allclose(got2.numpy(), want2, rtol=1e-5)


def test_single_rank_traces_no_exchange(one_rank_group):
    with CollectiveTrace() as trace:
        allgather_matmul(torch.zeros(8, 16), torch.zeros(16, 6))
        matmul_reducescatter(torch.zeros(8, 16), torch.zeros(16, 6))
    assert trace.ops == []


RING_PROG = textwrap.dedent(
    """
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    N = 8

    def rank_main(rank, port):
        dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank, world_size=N)
        from repro_torch.analysis.roofline import CollectiveTrace
        from repro_torch.distributed.collective_matmul import allgather_matmul, matmul_reducescatter
        rng = np.random.default_rng(0)
        x = rng.standard_normal((32, 16)).astype(np.float32)
        w = rng.standard_normal((16, 24)).astype(np.float32)
        x2 = rng.standard_normal((32, 64)).astype(np.float32)
        w2 = rng.standard_normal((64, 24)).astype(np.float32)
        m, k = 32 // N, 64 // N
        with CollectiveTrace() as trace:
            y = allgather_matmul(torch.from_numpy(x[rank * m:(rank + 1) * m]), torch.from_numpy(w))
            y2 = matmul_reducescatter(torch.from_numpy(x2[:, rank * k:(rank + 1) * k]),
                                      torch.from_numpy(w2[rank * k:(rank + 1) * k]))
        np.testing.assert_allclose(y.numpy(), x.astype(np.float64) @ w, rtol=1e-5, atol=1e-5)
        want2 = (x2.astype(np.float64) @ w2)[rank * m:(rank + 1) * m]
        np.testing.assert_allclose(y2.numpy(), want2, rtol=1e-4, atol=1e-4)
        stats = trace.stats()
        assert stats["collective-permute"]["count"] == 2 * (N - 1), stats
        assert stats["collective-permute"]["bytes"] == (N - 1) * (m * 16 + m * 24) * 4, stats
        assert all(stats[k]["count"] == 0 for k in stats if k != "collective-permute"), stats
        assert {op.group_ranks for op in trace.ops} == {tuple(range(N))}
        dist.barrier()
        dist.destroy_process_group()
        print(f"OK rank {rank}", flush=True)

    if __name__ == "__main__":
        mp.spawn(rank_main, args=(int(sys.argv[1]),), nprocs=N, join=True)
    """
)


def test_eight_rank_ring_spawned_gloo(tmp_path):
    """8 gloo processes: allgather_matmul against the float64 product at
    rtol 1e-5 (atol 1e-5), matmul_reducescatter at rtol 1e-4 (atol 1e-4),
    as tests/test_collective_matmul.py:42-46; each ring makes n - 1
    exchanges (result bytes: one block each) and no gather or scatter."""
    script = tmp_path / "ring8.py"
    script.write_text(RING_PROG)
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    out = subprocess.run([sys.executable, str(script), str(_free_port())], capture_output=True, text=True,
                         timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert sorted(int(r) for r in re.findall(r"OK rank (\d+)", out.stdout)) == list(range(8)), out.stdout
