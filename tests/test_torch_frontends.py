"""The modality configs against the JAX package: internvl2-1b (VLM: patch
embeddings prepended to the tokens on a full forward, a tied head) and
musicgen-large (audio: frame embeddings in, one head per codebook).  Their
embedding, decode step by step, loss, synthetic batches, the
trainer and the eval step on the CPU, and the serve launcher's refusal of
frontends (the JAX server's).  Reduced configs, inputs made with numpy
from a seed, JAX parameters converted to the port."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.models import build_model as jax_build_model
from repro.models import synthetic_batch as jax_synthetic_batch
from repro.models import transformer as jax_transformer
from repro_torch.models import build_model, synthetic_batch, transformer
from torch_parity import (
    MODALITY_ARCHS,
    assert_close,
    cfg_pair,
    check_decode_steps,
    check_param_tree,
    f32_pair,
    jax_batch,
    np_batch,
    to_torch,
    torch_batch,
)


@pytest.mark.parametrize("name", MODALITY_ARCHS)
def test_param_tree_matches_jax(name):
    """Audio has no token embedding and a (codebooks, d, V) head; the VLM's
    head is its tied embedding."""
    check_param_tree(name)
    _, tcfg = cfg_pair(name)
    params = build_model(tcfg).init(0, device="cpu")
    if tcfg.frontend == "audio":
        assert "embed" not in params and "lm_head" not in params
        assert tuple(params["lm_heads"].shape) == (4, tcfg.d_model, tcfg.padded_vocab_size)
    else:
        assert "lm_head" not in params and "lm_heads" not in params


@pytest.mark.parametrize("decode", [False, True])
@pytest.mark.parametrize("name", MODALITY_ARCHS)
def test_embed_inputs_matches_jax(name, decode):
    """The patch prefix on a full forward and not in decode; audio frames
    cast to the activation dtype (bf16 here)."""
    jcfg, tcfg = cfg_pair(name)
    jparams = jax_build_model(jcfg).init(jax.random.key(0))
    batch = np_batch(jcfg, 2, 5, seed=1)
    want = jax_transformer.embed_inputs(jparams, jcfg, jax_batch(batch), decode=decode)
    got = transformer.embed_inputs(to_torch(jparams), tcfg, torch_batch(batch), decode=decode)
    assert tuple(got.shape) == want.shape and got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if name == "internvl2-1b":
        assert got.shape[1] == 5 + (0 if decode else tcfg.num_patches)


@pytest.mark.parametrize("name", MODALITY_ARCHS)
def test_decode_steps_match_jax(name):
    """Decode against JAX, logits and cache after every step: musicgen fed
    one frame embedding a step, internvl2 one token (no patches)."""
    check_decode_steps(name, steps=10)


@pytest.mark.parametrize("name", MODALITY_ARCHS + ["mixtral-8x7b"])
def test_loss_metrics_match_jax(name):
    """The loss and each metric on the family's batch: the VLM's CE over
    the token positions after the patches, musicgen's over every codebook
    of the next frame."""
    jcfg, tcfg = f32_pair(name)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.key(2))
    batch = np_batch(jcfg, 2, 12, seed=2)
    want, want_m = jax.jit(jmodel.loss)(jparams, jax_batch(batch))
    got, m = build_model(tcfg).loss(to_torch(jparams), torch_batch(batch))
    assert set(m) == set(want_m)
    assert_close(got, want)
    for k in want_m:
        assert_close(m[k], want_m[k])


@pytest.mark.parametrize("name", MODALITY_ARCHS)
def test_synthetic_batch_has_jax_structure(name):
    _, tcfg = cfg_pair(name)
    jcfg, _ = cfg_pair(name)
    want = jax_synthetic_batch(jcfg, 2, 6)
    got = synthetic_batch(tcfg, 2, 6, seed=0, device="cpu")
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert got[k].is_floating_point() == jnp.issubdtype(want[k].dtype, jnp.floating), k
        if got[k].is_floating_point():
            assert got[k].dtype == torch.bfloat16
        else:
            assert 0 <= int(got[k].min()) and int(got[k].max()) < tcfg.vocab_size
    again = synthetic_batch(tcfg, 2, 6, seed=0, device="cpu")
    assert all(torch.equal(got[k], again[k]) for k in got)


@pytest.mark.parametrize("name", MODALITY_ARCHS)
def test_eval_step_kernel_paths_match_torch_paths(name):
    """The eval step through the kernels' plain versions (the CPU) equals
    the torch paths' loss."""
    from repro_torch.train import make_eval_step

    _, tcfg = f32_pair(name)
    params = build_model(tcfg).init(0, device="cpu")
    batch = synthetic_batch(tcfg, 2, 16, seed=3, device="cpu")
    fast = make_eval_step(build_model(tcfg, impl="kernel"))(params, batch)
    plain = make_eval_step(build_model(tcfg))(params, batch)
    assert fast.keys() == plain.keys()
    assert_close(fast["loss"], plain["loss"])


@pytest.mark.parametrize("name", MODALITY_ARCHS + ["mixtral-8x7b"])
def test_train_main_runs_on_cpu(name, capsys):
    """The trainer's CLI on the reduced config: the pipeline's frame or
    patch embeddings reach the model, and the losses are finite."""
    from repro_torch.launch import train

    first, last = train.main(["--arch", name, "--device", "cpu", "--steps", "3", "--batch", "2",
                              "--seq", "16", "--microbatches", "2", "--log-every", "1"])
    assert np.isfinite([first, last]).all()
    assert f"arch={name}-smoke" in capsys.readouterr().out


def test_serve_refuses_frontends():
    """As the JAX server (repro/launch/serve.py), the port's serves token
    LMs only."""
    from repro_torch.launch import serve

    for name in MODALITY_ARCHS:
        with pytest.raises(SystemExit, match="token"):
            serve.main(["--arch", name, "--device", "cpu"])

