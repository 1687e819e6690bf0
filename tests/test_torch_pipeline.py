"""GPipe over a 'pipe' axis of gloo ranks, the port against the reference
(``tests/test_pipeline.py``).

A stack of 4 stages on ``{pipe: 4}``: each rank holds its stage of the
stacked leaves (``pipeline_partition_rules``), the pipelined forward of
4 microbatches equals the stages applied in turn (the reference's 2e-6),
sgd training through the pipeline equals sequential training step for
step (1e-5 / 1e-6), and the adam moments follow the pipe rules. The
causal LM with its trunk pipelined on ``{data: 2, pipe: 2}``
(``split_pipeline_params``: embed and readout stay ordinary tensors)
trains as the reference's non-pipelined LM does (5e-5 / 5e-6), and its
pipelined loss in one process, where the stages run in turn, equals the
reference's plain loss (2e-5 / 2e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ps_tpu
import test_torch_ranks_harness as torch_ranks
from ps_tpu.models import lm as ref_lm
from ps_tpu_torch.models import lm
from ps_tpu_torch.parallel import pipeline as pl

S, DM, B, M = 4, 16, 16, 4  # stages, width, global batch, microbatches


def _stage_params(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 0.3, (DM, DM)).astype(np.float32),
            "b": rng.normal(0, 0.1, DM).astype(np.float32)}


def _stage_fn(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _sequential(stages, x):
    for p in stages:
        x = _stage_fn(p, x)
    return x


def _batches():
    rng = np.random.default_rng(11)
    return [(rng.normal(0, 1, (B, DM)).astype(np.float32),
             rng.normal(0, 1, (B, DM)).astype(np.float32)) for _ in range(3)]


@pytest.fixture(scope="module")
def pipe(tmp_path_factory):
    stages = [_stage_params(i) for i in range(S)]
    x = np.random.default_rng(9).normal(0, 1, (B, DM)).astype(np.float32)
    cases = [("pipeline", dict(stages=stages, x=x, batches=_batches(),
                               microbatches=M))]
    return stages, x, torch_ranks.run_ranks(
        S, cases, tmp_path_factory.mktemp("pipe"),
        init={"mesh_shape": {"pipe": S}})


def test_pipeline_forward_matches_sequential(pipe):
    stages, x, ranks = pipe
    want = np.asarray(_sequential(stages, jnp.asarray(x)))
    for r in ranks:  # the last stage's outputs on every pipe rank
        np.testing.assert_allclose(r[0]["out"], want, rtol=2e-6, atol=2e-6)


def test_pipelined_training_matches_sequential(pipe):
    """The PS step through the pipeline == sequential optax sgd, step for
    step (the reverse schedule's sends are exact)."""
    stages, _, ranks = pipe
    opt = optax.sgd(0.1)
    params = {f"s{i}": p for i, p in enumerate(stages)}
    state = opt.init(params)

    def loss(ps_, batch):
        x, y = batch
        out = _sequential([ps_[f"s{i}"] for i in range(S)], x)
        return jnp.mean((out - y) ** 2)

    ref = []
    for b in _batches():
        val, g = jax.value_and_grad(loss)(params, b)
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
        ref.append(float(val))
    for s, r in enumerate(ranks):
        np.testing.assert_allclose(r[0]["losses"], ref, rtol=1e-5, atol=1e-6)
        assert r[0]["specs"]["stack/w"] == ("pipe", None, None)
        assert r[0]["held"]["stack/w"] == (1, DM, DM)  # its stage


def test_moments_follow_pipe_rules(pipe):
    for r in pipe[2]:
        state = r[0]["state_specs"]
        assert state["mu/stack/w"] == ("pipe", None, None)
        assert state["mu/stack/b"] == ("pipe", None)
        assert state["nu/stack/w"] == ("pipe", None, None)
        assert state["count"] == ()


def _lm_setup():
    params = ref_lm.init_params(np.random.default_rng(3), vocab=64,
                                d_model=32, n_heads=2, n_layers=4, max_len=64)
    batches = list(ref_lm.lm_batches(8, 16, vocab=64, seed=5, steps=3))
    return params, batches


def test_lm_pipelined_forward_matches_sequential():
    """Embed -> the 4-stage trunk run in turn -> readout in one process ==
    the reference's plain loss."""
    params, batches = _lm_setup()
    want = float(ref_lm.make_loss_fn(n_heads=2)(
        params, {k: jnp.asarray(v) for k, v in batches[0].items()}))
    ported = lm.init_params(np.random.default_rng(3), vocab=64, d_model=32,
                            n_heads=2, n_layers=4, max_len=64)
    comp = lm.split_pipeline_params(ported, num_stages=4)
    got = float(lm.make_pipelined_loss_fn(n_heads=2, num_stages=4,
                                          microbatches=M)(
        comp, {k: torch.as_tensor(v) for k, v in batches[0].items()}))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)


def test_lm_trains_under_dp_pp_with_parity(tmp_path):
    """The PS step through the dp x pp pipeline (``{data: 2, pipe: 2}``,
    2 layers a stage) == the reference's non-pipelined training; the
    trunk rides 'pipe', the embed stays off it."""
    params, batches = _lm_setup()
    ps_tpu.init(backend="tpu")
    try:
        store = ps_tpu.KVStore(optimizer="sgd", learning_rate=0.1)
        store.init(params)
        run = store.make_step(ref_lm.make_loss_fn(n_heads=2))
        ref = [float(run({k: jnp.asarray(v) for k, v in b.items()})[0])
               for b in batches]
    finally:
        ps_tpu.shutdown()
    ranks = torch_ranks.run_ranks(
        4, [("lm_steps", dict(n_heads=2, n_layers=4, vocab=64, seq_len=16,
                              batch=8, steps=3, optimizer="sgd", lr=0.1,
                              placement="replicated", microbatches=M,
                              init_seed=3, data_seed=5, max_len=64))],
        tmp_path, init={"mesh_shape": {"data": 2, "pipe": 2}})
    for r in ranks:
        got = r[0]
        np.testing.assert_allclose(got["losses"], ref, rtol=5e-5, atol=5e-6)
        assert got["losses"][-1] < got["losses"][0]
        assert got["specs"]["stages/attn/qkv/kernel"][0] == "pipe"
        assert "pipe" not in got["specs"]["embed/tokens"]
        assert ("broadcast", "pipe") in got["calls"]


def test_pipeline_refuses_what_the_reference_refuses():
    fn = pl.make_pipeline_fn(lambda p, x: x, None, microbatches=M)
    with pytest.raises(ValueError, match="microbatches"):
        fn({"w": torch.zeros(1, 2)}, torch.zeros(M + 1, 2, 2))
    with pytest.raises(ValueError, match="not divisible"):
        pl.microbatch(torch.zeros(B + 1, 2), M)
