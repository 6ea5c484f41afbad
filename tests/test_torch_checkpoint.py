"""The port's training substrate against the JAX package: checkpoints that
move between the two packages, the data pipeline's batches (bit-equal),
gradient compression (int8 codes, top-k masks), and the fault-tolerance
runtime (mirroring tests/test_substrate.py)."""

import functools
import json
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import get_arch as jax_get_arch
from repro.data import DataConfig as JaxDataConfig
from repro.data import DataPipeline as JaxDataPipeline
from repro.data import make_batch as jax_make_batch
from repro.models import build_model as jax_build_model
from repro.optim import adamw as jax_adamw
from repro.optim import compression as jax_comp
from repro_torch import tree
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_arch
from repro_torch.data import DataConfig, DataPipeline, host_slice, make_batch
from repro_torch.optim import adamw
from repro_torch.optim import compression as comp
from repro_torch.runtime import (
    ElasticPlan,
    HeartbeatMonitor,
    StragglerTracker,
    TrainingSupervisor,
    plan_mesh,
)
from torch_parity import cfg_pair, to_torch


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _jax_train_state(name="zamba2-2.7b", steps=2):
    """(params, opt_state) of the JAX package after ``steps`` updates with
    random gradients: bf16 parameters, float32 moments, an int32 step."""
    jcfg, _ = cfg_pair(name)
    jparams = jax.jit(jax_build_model(jcfg).init)(jax.random.key(0))
    state = jax_adamw.init(jparams)
    rng = np.random.default_rng(0)
    update = jax.jit(lambda g, s, p: jax_adamw.update(jax_adamw.AdamWConfig(warmup_steps=0), g, s, p))
    for _ in range(steps):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), jparams)
        jparams, state, _ = update(grads, state, jparams)
    return jparams, state


def _to_port(jtree):
    params, state = jtree
    return to_torch(params), adamw.AdamWState(torch.tensor(int(state.step), dtype=torch.int32),
                                              to_torch(state.m), to_torch(state.v))


def _assert_equal_trees(got, want):
    """Every leaf equal, bit for bit, with the same dtype and shape."""
    g, w = tree.leaves_with_path(got), jax.tree_util.tree_leaves_with_path(want)
    assert len(g) == len(w)
    for (path, a), (_, b) in zip(g, w):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, path
        assert str(a.dtype).removeprefix("torch.") == str(b.dtype), path
        if a.is_floating_point():
            a, b = a.float(), b.astype(np.float32)
        np.testing.assert_array_equal(a.numpy(), b)


def test_checkpoint_written_by_jax_restores_in_the_port(tmp_path):
    jtree = _jax_train_state()
    JaxCheckpointManager(tmp_path).save(5, jtree)
    target = tree.tree_map(torch.zeros_like, _to_port(jtree))
    step, restored = CheckpointManager(tmp_path).restore(target)
    assert step == 5
    _assert_equal_trees(restored, jtree)


def test_checkpoint_written_by_the_port_restores_in_jax(tmp_path):
    jtree = _jax_train_state()
    CheckpointManager(tmp_path).save(9, _to_port(jtree))
    step, restored = JaxCheckpointManager(tmp_path).restore(jax.tree.map(jnp.zeros_like, jtree))
    assert step == 9
    for a, b in zip(jax.tree.leaves(restored), jax.tree.leaves(jtree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a.astype(jnp.float32)), np.asarray(b.astype(jnp.float32)))


def test_checkpoint_files_equal_jax_for_the_same_tree(tmp_path):
    """metadata.json byte for byte, the same shard files with the same keys
    and the same arrays: leaf names ``0$...``, ``1$.step``, ``1$.m$...``,
    chunks along axis 0, bf16 widened to float32."""
    jtree = _jax_train_state()
    JaxCheckpointManager(tmp_path / "jax").save(3, jtree)
    CheckpointManager(tmp_path / "port").save(3, _to_port(jtree))
    dj, dp = tmp_path / "jax" / "step_000000003", tmp_path / "port" / "step_000000003"
    assert (dj / "metadata.json").read_text() == (dp / "metadata.json").read_text()
    names = [leaf["name"] for leaf in json.loads((dp / "metadata.json").read_text())["leaves"]]
    assert "1$.step" in names and "1$.m$embed" in names and "0$mamba_layers$mamba$in_proj" in names
    assert sorted(p.name for p in dj.iterdir()) == sorted(p.name for p in dp.iterdir())
    assert (tmp_path / "port" / "step_000000003.COMMIT").exists()
    for shard in sorted(dj.glob("shard_*.npz")):
        with np.load(shard) as zj, np.load(dp / shard.name) as zp:
            assert sorted(zj.files) == sorted(zp.files)
            for k in zj.files:
                assert zj[k].dtype == zp[k].dtype
                np.testing.assert_array_equal(zj[k], zp[k])


def _tree():
    return {
        "a": torch.arange(13, dtype=torch.float32).reshape(13, 1),
        "b": {"c": torch.ones((4, 4), dtype=torch.bfloat16), "d": torch.tensor(3, dtype=torch.int32)},
    }


def test_checkpoint_roundtrip_restores_dtype(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    mgr.save(7, _tree())
    step, restored = mgr.restore(tree.tree_map(torch.zeros_like, _tree()))
    assert step == 7
    for a, b in zip(tree.leaves(_tree()), tree.leaves(restored)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_checkpoint_async_copies_before_returning_and_retains(tmp_path):
    """save_async snapshots on the host: an in-place update right after it
    returns does not reach the checkpoint."""
    mgr = CheckpointManager(tmp_path, keep=2)
    t = _tree()
    futs = []
    for s in (1, 2, 3):
        futs.append(mgr.save_async(s, t))
        t["a"].add_(100.0)
    for f in futs:
        f.result()
    mgr.close()
    assert mgr.all_steps() == [2, 3]
    _, restored = CheckpointManager(tmp_path).restore(tree.tree_map(torch.zeros_like, _tree()), step=2)
    assert torch.equal(restored["a"], _tree()["a"] + 100.0)


def test_checkpoint_ignores_uncommitted(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, _tree())
    (tmp_path / "step_000000002").mkdir()  # a crash mid-save: no COMMIT
    assert mgr.latest_step() == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"a": torch.zeros(4)})
    with pytest.raises(ValueError):
        mgr.restore({"a": torch.zeros(5)})
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"a": torch.zeros(4)})


# ---------------------------------------------------------------------------
# Data pipeline: the same batches, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["granite-3-8b", "rwkv6-3b"])
def test_make_batch_bit_equal_to_jax(name):
    jarch, tarch = jax_get_arch(name).reduced(), get_arch(name).reduced()
    for hosts, host in ((1, 0), (2, 0), (2, 1), (4, 3)):
        kw = dict(seed=7, global_batch=8, seq_len=32, num_hosts=hosts, host_index=host)
        assert host_slice(DataConfig(**kw)) == (host * (8 // hosts), 8 // hosts)
        for step in (0, 1, 5, 1000):
            want = jax_make_batch(jarch, JaxDataConfig(**kw), step)
            got = make_batch(tarch, DataConfig(**kw), step)
            assert got.keys() == want.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])


def test_pipeline_prefetch_and_resume_match_jax():
    jarch, tarch = jax_get_arch("granite-3-8b").reduced(), get_arch("granite-3-8b").reduced()
    pj = JaxDataPipeline(jarch, JaxDataConfig(seed=3, global_batch=2, seq_len=16), start_step=1)
    pt = DataPipeline(tarch, DataConfig(seed=3, global_batch=2, seq_len=16), start_step=1)
    try:
        for _ in range(3):
            (sj, bj), (st, bt) = next(pj), next(pt)
            assert sj == st
            np.testing.assert_array_equal(bt["tokens"], bj["tokens"])
    finally:
        pj.close()
        pt.close()
    assert not pt._thread.is_alive()


# ---------------------------------------------------------------------------
# Compression
# ---------------------------------------------------------------------------
def test_int8_codes_equal_jax():
    x = np.random.default_rng(0).standard_normal(4096).astype(np.float32) * 3.0
    qj, sj = jax_comp.quantize_int8(jnp.asarray(x))
    qt, st = comp.quantize_int8(torch.from_numpy(x))
    assert qt.dtype == torch.int8
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    assert float(st) == float(sj)
    np.testing.assert_array_equal(comp.dequantize_int8(qt, st).numpy(),
                                  np.asarray(jax_comp.dequantize_int8(qj, sj)))


@pytest.mark.parametrize("method", ["int8", "topk", "none"])
def test_compress_with_feedback_matches_jax(method):
    """Three steps of error feedback on inputs without ties: the sent values
    (top-k masks included), the residuals and the wire bytes."""
    rng = np.random.default_rng(1)
    shapes = {"w": (64, 8), "b": (37,)}
    jstate = jax_comp.init_state({k: jnp.zeros(s) for k, s in shapes.items()})
    state = comp.init_state({k: torch.zeros(s) for k, s in shapes.items()})
    for _ in range(3):
        g = {k: rng.permutation(np.prod(s)).reshape(s).astype(np.float32) / 100 - 1.0
             for k, s in shapes.items()}  # distinct magnitudes
        sj, jstate, wj = jax_comp.compress_with_feedback(
            {k: jnp.asarray(v) for k, v in g.items()}, jstate, method, topk_frac=0.1)
        st, state, wt = comp.compress_with_feedback(
            {k: torch.from_numpy(v) for k, v in g.items()}, state, method, topk_frac=0.1)
        for k in shapes:
            np.testing.assert_array_equal(st[k].numpy(), np.asarray(sj[k]))
            np.testing.assert_array_equal(state.residual[k].numpy(), np.asarray(jstate.residual[k]))
        assert comp.wire_bytes(wt) == jax_comp.wire_bytes(wj)
    with pytest.raises(ValueError):
        comp.compress_with_feedback({"w": torch.zeros(2)}, comp.init_state({"w": torch.zeros(2)}), "fp4")


def test_wire_bytes_int8_is_quarter():
    g = {"w": torch.zeros(1024)}
    _, _, wire = comp.compress_with_feedback(g, comp.init_state(g), "int8")
    assert comp.wire_bytes(wire) < 1024 * 4 / 3.5


# ---------------------------------------------------------------------------
# Fault tolerance (tests/test_substrate.py:200-287, mirrored)
# ---------------------------------------------------------------------------
def test_heartbeat_detects_timeout():
    t = [0.0]
    mon = HeartbeatMonitor(["w0", "w1"], timeout=5.0, clock=lambda: t[0])
    t[0] = 3.0
    mon.beat("w0")
    t[0] = 7.0
    assert mon.check() == ["w1"]
    assert mon.alive == ["w0"]


def test_straggler_tracker_advice():
    s = StragglerTracker(alpha=1.0, factor=1.5, evict_factor=3.0)
    for w, dt in [("a", 1.0), ("b", 1.0), ("c", 2.0), ("d", 4.0)]:
        s.record(w, dt)
    assert s.stragglers() == {"c": "rebalance", "d": "evict"}
    shares = s.rebalanced_shares(["a", "c"])
    assert shares["a"] > shares["c"]
    assert abs(sum(shares.values()) - 1.0) < 1e-9


def test_elastic_plan_shrinks_data_axis():
    assert plan_mesh(512, model_parallel=16, pod_size=256) == ElasticPlan(pods=2, data=16, model=16)
    p2 = plan_mesh(496, model_parallel=16, pod_size=256)
    assert p2.chips <= 496 and p2.model == 16
    with pytest.raises(ValueError):
        plan_mesh(8, model_parallel=16)


def _supervisor(tmp_path, every, schedule):
    mgr = CheckpointManager(tmp_path, keep=5)
    log = []

    def step_fn(state, i):
        log.append(i)
        return state + 1

    def save_fn(step, state):
        mgr.save(step, {"s": torch.tensor(state)})

    def restore_fn():
        step, t = mgr.restore({"s": torch.tensor(0)})
        return step, int(t["s"])

    mon = HeartbeatMonitor(["w0", "w1"], timeout=1e9, clock=lambda: 0.0)
    return TrainingSupervisor(step_fn, save_fn, restore_fn, mon, checkpoint_every=every,
                              failure_schedule=schedule), mon


def test_supervisor_restores_after_failure(tmp_path):
    sup, _ = _supervisor(tmp_path, 5, {12: ["w1"]})
    state, report = sup.run(0, 0, 20)
    assert report.failures_handled == 1 and report.restores == 1
    assert report.final_step == 20 and state == 20
    assert report.steps_run == 20 + 2  # steps 10 and 11 ran twice


def test_supervisor_failed_worker_can_rejoin(tmp_path):
    sup, mon = _supervisor(tmp_path, 4, {6: ["w1"]})
    state, _ = sup.run(0, 0, 10)
    assert "w1" in mon.failed and mon.last_seen["w1"] == -math.inf
    mon.rejoin("w1")
    assert mon.alive == ["w0", "w1"]
    assert state == 10
