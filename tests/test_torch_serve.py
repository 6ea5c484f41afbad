"""Serving parity: the port's greedy serve loop against the same loop driven
by the JAX package's ``decode_step`` (float32, the same converted
parameters), and the port's serve CLI on the CPU."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import build_model as jax_build_model
from repro_torch.launch import serve
from repro_torch.models import build_model
from torch_parity import f32_pair, to_torch


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


@pytest.mark.parametrize("name", ["granite-3-8b", "command-r-35b", "zamba2-2.7b", "rwkv6-3b"])
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
