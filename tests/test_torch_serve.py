"""Serving parity: the port's greedy serve loop against the same loop driven
by the JAX package's ``decode_step`` (float32, the same converted
parameters), and the port's serve CLI on the CPU."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import build_model as jax_build_model
from repro_torch.launch import serve
from repro_torch.models import build_model
from torch_parity import MOE_ARCHS, f32_pair, to_torch


def _jax_serve_loop(jmodel, jparams, prompts, gen_len):
    """repro/launch/serve.py's prefill-by-decode and greedy loop."""
    B, P = prompts.shape
    vocab = jmodel.cfg.vocab_size
    cache = jmodel.init_cache(B, P + gen_len)
    decode = jax.jit(jmodel.decode_step)
    for t in range(P):
        logits, cache = decode(jparams, cache, {"tokens": jnp.asarray(prompts[:, t : t + 1])}, jnp.array(t))
    last = logits
    out = []
    tok = jnp.argmax(logits[:, -1, :vocab], axis=-1)[:, None].astype(jnp.int32)
    for i in range(gen_len):
        out.append(np.asarray(tok))
        logits, cache = decode(jparams, cache, {"tokens": tok}, jnp.array(P + i))
        tok = jnp.argmax(logits[:, -1, :vocab], axis=-1)[:, None].astype(jnp.int32)
    return np.concatenate(out, axis=1), last


@pytest.mark.parametrize(
    "name", ["granite-3-8b", "command-r-35b", "zamba2-2.7b", "rwkv6-3b", "mixtral-8x7b"]
)
def test_greedy_tokens_match_jax(name):
    jcfg, tcfg = f32_pair(name)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(0))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab_size, (3, 8), dtype=np.int32)
    gen_len = 12
    want_tokens, want_last = _jax_serve_loop(jmodel, jparams, prompts, gen_len)

    model = build_model(tcfg)
    params = to_torch(jparams)
    t_prompts = torch.from_numpy(prompts).long()
    with torch.inference_mode():
        cache = model.init_cache(3, 8 + gen_len, device="cpu")
        last, cache = serve.prefill_by_decode(model, params, cache, t_prompts)
        tokens = serve.greedy_decode(model, params, cache, last, 8, gen_len)
    np.testing.assert_allclose(last.numpy(), np.asarray(want_last), atol=2e-4, rtol=2e-4)
    np.testing.assert_array_equal(tokens.numpy(), want_tokens)


def test_serve_main_runs_on_cpu(capsys):
    result = serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "16", "--gen-len", "5"])
    assert result["tokens"].shape == (2, 5)
    assert result["tokens"].max() < 128  # reduced vocabulary
    assert result["prefill_decode_max_abs_diff"] <= result["prefill_decode_tol"]
    assert "tok/s" in capsys.readouterr().out


def test_serve_flash_prefill_launches_no_kernel_on_cpu():
    from repro_torch.kernels.attention import ops

    before = ops.launches
    serve.main(["--device", "cpu", "--requests", "1", "--prompt-len", "8", "--gen-len", "2"])
    assert ops.launches == before


def test_serve_cli_flags():
    ap = serve.build_parser()
    assert ap.parse_args([]).reduced is True
    assert ap.parse_args(["--no-reduced"]).reduced is False
    assert ap.parse_args([]).device == "cuda"


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_serve_moe_on_cpu(name, capsys):
    """The reduced MoE server on the CPU in float32, through the launcher's
    ``serve_config``: the check's prompt forward runs at the no-drop
    capacity, takes the plain versions (no launch) and agrees with decode
    at the float32 bound, and the launcher says so.  (In bf16 a routing
    near-tie can flip between the two paths: PERF.md.)"""
    from repro_torch.kernels.attention import ops as flash_ops

    _, tcfg = f32_pair(name)
    args = serve.build_parser().parse_args(["--requests", "2", "--prompt-len", "12", "--gen-len", "4"])
    before = flash_ops.launches
    result = serve.serve_config(tcfg, args, torch.device("cpu"))
    assert flash_ops.launches == before
    assert result["tokens"].shape == (2, 4) and result["tokens"].max() < tcfg.vocab_size
    assert result["prefill_decode_tol"] == serve.PREFILL_DECODE_TOL["float32"]
    assert result["prefill_decode_max_abs_diff"] <= result["prefill_decode_tol"]
    routing = result["routing"]
    assert routing["beyond_tie"] == 0 and routing["ties"] <= serve.ROUTING_MAX_TIES
    assert len(routing["flips_by_layer"]) == tcfg.n_layers
    assert routing["pairs_per_layer"] == 2 * 12
    factor = tcfg.moe.num_experts // tcfg.moe.top_k
    out = capsys.readouterr().out
    assert f"capacity factor {factor} (no drops; configured 1.25)" in out
    assert f"routing against decode's: {routing}" in out


def test_serve_check_capacity_is_no_drop_and_decode_never_drops():
    from repro_torch.configs import get_arch
    from repro_torch.models.moe import expert_capacity

    for name in MOE_ARCHS:
        cfg = get_arch(name)
        check = serve.no_drop_config(cfg)
        assert check.moe.capacity_factor == cfg.moe.num_experts / cfg.moe.top_k
        assert dataclasses.replace(check, moe=cfg.moe) == cfg  # nothing else changes
        assert expert_capacity(check, 512) >= 512
        assert expert_capacity(cfg, 1) >= cfg.moe.top_k
    granite = get_arch("granite-3-8b")
    assert serve.no_drop_config(granite) is granite


def _route(probs, k=2):
    from repro_torch.models import moe

    return moe.route(probs, k)


def _decode_then_forward(tie_gap):
    """One MoE layer's routing, recorded over three decode steps (experts
    (0, 1), (0, 2), (0, 3)), then a prompt forward over the same three
    tokens: the same experts; (0, 1) ahead of decode's (0, 2) by half of
    ``tie_gap``; (0, 2) against decode's (0, 3) by 0.1, a routing fault."""
    routing = serve.DecodeRouting()
    with routing.recording():
        for row in [[0.5, 0.3, 0.2, 0.0], [0.5, 0.2, 0.3, 0.0], [0.5, 0.0, 0.2, 0.3]]:
            _route(torch.tensor([[row]]))
    forward = torch.tensor([[
        [0.5, 0.3, 0.2, 0.0],
        [0.5, 0.25 + serve.ROUTING_TIE_GAP / 4, 0.25 - serve.ROUTING_TIE_GAP / 4, 0.0],
        [0.5, 0.0, 0.3, 0.2],
    ]])
    with routing.forward(tie_gap):
        w, ids = _route(forward)
    return routing, forward, w, ids


def test_decode_routing_takes_decode_experts_only_at_ties():
    """With a tie gap the prompt forward keeps its own experts where they
    match decode's, takes decode's where the two differ by no more than
    ROUTING_TIE_GAP, and keeps its own where they differ by more, which
    fails the check; without one (bf16) it keeps its own everywhere."""
    routing, forward, w, ids = _decode_then_forward(serve.ROUTING_TIE_GAP)
    assert ids.tolist() == [[[0, 1], [0, 2], [0, 2]]]
    assert torch.equal(w, forward.gather(-1, ids))
    summary = routing.summary()
    tie = float(forward[0, 1, 1] - forward[0, 1, 2])
    assert 0 < tie <= serve.ROUTING_TIE_GAP
    assert summary == {
        "flips_by_layer": [2], "last_position_flips_by_layer": [1], "pairs_per_layer": 3,
        "max_gap": pytest.approx(0.1), "min_gap": pytest.approx(tie), "ties": 1,
        "max_tie_gap": pytest.approx(tie), "beyond_tie": 1,
    }
    assert "1 (token, layer) pairs routed differently beyond a tie" in serve.routing_fault(summary)

    routing, forward, w, ids = _decode_then_forward(None)
    assert ids.tolist() == [[[0, 1], [0, 1], [0, 2]]]
    assert "ties" not in routing.summary() and routing.summary()["flips_by_layer"] == [2]


def test_routing_fault_counts_ties_against_their_limit():
    summary = {"beyond_tie": 0, "ties": serve.ROUTING_MAX_TIES, "max_gap": 0.0}
    assert serve.routing_fault(summary) is None
    summary["ties"] += 1
    assert serve.routing_fault(summary) == (
        f"{serve.ROUTING_MAX_TIES + 1} routing ties, more than {serve.ROUTING_MAX_TIES}")


def test_decode_routing_leaves_the_router_as_it_was():
    """The hook holds inside its block only, one at a time, and only in the
    thread that set it."""
    import threading

    from repro_torch.models import moe

    probs = torch.tensor([[[0.1, 0.6, 0.3]]])
    routing = serve.DecodeRouting()
    with routing.recording():
        _route(probs)
        with pytest.raises(RuntimeError, match="already set"):
            with routing.forward():
                pass
        seen = []
        thread = threading.Thread(target=lambda: seen.append(_route(probs)))
        thread.start()
        thread.join()
    assert len(routing.decode) == 1  # not the other thread's call
    _route(probs)
    assert len(routing.decode) == 1
    assert [t.tolist() for t in seen[0]] == [t.tolist() for t in moe.top_k(probs, 2)]
