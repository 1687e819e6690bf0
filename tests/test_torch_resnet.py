"""The ResNet slice: the port's model, 'SAME' padding, BatchNorm, momentum
step and trainer against the reference's, on the CPU.

Weights come from the reference (``model.init`` with a ``jax.random.key``)
and go into the port with ``ResNet.params_from_jax``; inputs are numpy,
from a seed. Tolerances are the reference's own (tests/test_resnet.py):
one momentum step within loss rtol 1e-5 and params and ``batch_stats``
rtol 2e-4, atol 2e-5; full-width ResNet-50 in f32 within rtol/atol 2e-4 on
the logits and the new ``batch_stats``.

For the full-width forwards the BatchNorm parameters and running
statistics are perturbed from flax's init (which zeroes each block's last
BN scale, so that a residual branch would add nothing): scales 1 ± 0.1,
the last one 0.2·N(0, 1) as in a trained network, biases and running means
0.1·N(0, 1), running variances in [0.5, 1.5]. With the last scales near 1
the residual stream's channel means grow large against their spread, and
the train-mode forward (fast variance, mean subtraction) amplifies f32
round-off to ~1e-3 in the logits whatever the summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ps_tpu
import ps_tpu_torch
from ps_tpu.data.synthetic import mnist_batches
from ps_tpu.kv.keys import flatten_with_keys as ref_flatten_with_keys
from ps_tpu.models import resnet as ref_resnet
from ps_tpu_torch.data.files import write_dataset
from ps_tpu_torch.examples import train_resnet50
from ps_tpu_torch.kv.keys import flatten_with_keys
from ps_tpu_torch.models import resnet
from ps_tpu_torch.utils import profiling, trace


@pytest.fixture(autouse=True)
def _fresh_port():
    ps_tpu_torch.shutdown()
    yield
    ps_tpu_torch.shutdown()


def _tiny(ref=False, **kw):
    """The reference tests' tiny ResNet: BasicBlock, stages (1, 1), 8
    filters, 10 classes, f32, small inputs."""
    mod = ref_resnet if ref else resnet
    kw.setdefault("stage_sizes", (1, 1))
    kw.setdefault("block_cls", mod.BasicBlock)
    kw.setdefault("num_filters", 8)
    kw.setdefault("num_classes", 10)
    kw.setdefault("dtype", jnp.float32 if ref else torch.float32)
    kw.setdefault("small_inputs", True)
    return mod.ResNet(**kw)


def _to_flax(flat):
    """The port's ``{key: tensor}`` in flax's layouts, as numpy."""
    out = {}
    for k, t in flat.items():
        a = t.detach().numpy()
        out[k] = (a.transpose(2, 3, 1, 0) if a.ndim == 4
                  else a.T if k == "head/kernel" else a)
    return out


def _assert_tree_close(got, want, rtol, atol):
    got = _to_flax(flatten_with_keys(got)[0])
    want, _ = ref_flatten_with_keys(want)
    assert list(got) == list(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=k)


def _perturbed(variables, seed=0):
    """flax's init with its BatchNorm parameters and statistics perturbed
    (module docstring), as numpy."""
    rng = np.random.default_rng(seed)

    def fill(path, a):
        name, a = jax.tree_util.keystr(path), np.asarray(a)
        if "scale" in name:
            z = rng.normal(size=a.shape)
            return (0.2 * z if "BatchNorm_2" in name else 1 + 0.1 * z
                    ).astype(np.float32)
        if ("'bias'" in name and "head" not in name) or "mean" in name:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if "var" in name:
            return rng.uniform(0.5, 1.5, size=a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(fill, variables)


def test_forward_shape():
    model = _tiny()
    params, stats = model.init(torch.Generator().manual_seed(0),
                               in_channels=1)
    logits, new_stats = model.apply(params, stats, torch.zeros((4, 28, 28, 1)),
                                    train=False)
    assert logits.shape == (4, 10) and logits.dtype == torch.float32
    assert new_stats["bn_init"] is stats["bn_init"]  # eval: unchanged
    assert "BasicBlock_1" in stats and "conv_proj" in params["BasicBlock_1"]


def test_bottleneck_block_downsamples():
    model = _tiny(block_cls=resnet.BottleneckBlock)
    params, stats = model.init(torch.Generator().manual_seed(0))
    logits, new_stats = model.apply(params, stats, torch.zeros((2, 16, 16, 3)))
    assert logits.shape == (2, 10)
    # the second stage's stride lives on the 3x3 and on conv_proj
    block = resnet.BottleneckBlock(16, 2)
    convs, _, out = block.variables(32)
    assert out == 64 and convs["Conv_1"] == ((16, 16, 3, 3), 2)
    assert convs["conv_proj"] == ((64, 32, 1, 1), 2)
    assert set(new_stats["BottleneckBlock_1"]) == {
        "BatchNorm_0", "BatchNorm_1", "BatchNorm_2", "norm_proj"}


def test_resnet50_param_count_keys_and_shapes():
    """ResNet-50 v1.5 has the canonical 25.56M trainable params, under the
    reference's keys in its order, in the port's layouts."""
    model = resnet.ResNet50(dtype=torch.float32)
    params, stats = model.shapes()
    assert sum(int(np.prod(s)) for s in params.values()) == 25_557_032
    ref = ref_resnet.ResNet50(dtype=jnp.float32)
    want = jax.eval_shape(lambda: ref.init(
        jax.random.key(0), jnp.zeros((1, 32, 32, 3)), train=False))
    ref_p, _ = ref_flatten_with_keys(want["params"])
    ref_s, _ = ref_flatten_with_keys(want["batch_stats"])
    assert sorted(params) == list(ref_p) and sorted(stats) == list(ref_s)
    for k, w in ref_p.items():
        shape = tuple(w.shape)
        if len(shape) == 4:  # HWIO → OIHW
            shape = (shape[3], shape[2], shape[0], shape[1])
        elif k == "head/kernel":
            shape = shape[::-1]
        assert params[k] == shape, k
    # about 4.09 G multiply-adds a 224² image, the published figure
    assert 4.08e9 < model.forward_macs(224) < 4.10e9


def test_init_follows_flax():
    ref = _tiny(ref=True, block_cls=ref_resnet.BottleneckBlock)
    want = jax.jit(lambda: ref.init(jax.random.key(0),
                                    jnp.zeros((2, 16, 16, 3)), train=False))()
    model = _tiny(block_cls=resnet.BottleneckBlock)
    params, stats = model.init(torch.Generator().manual_seed(1))
    got = _to_flax(flatten_with_keys(params)[0])
    for key, w in ref_flatten_with_keys(want["params"])[0].items():
        w = np.asarray(w)
        assert got[key].shape == w.shape, key
        if w.std() == 0:  # zero biases, BN scales 1 and the last BN's 0
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:  # lecun_normal: the same spread, truncated at 2 std
            np.testing.assert_allclose(got[key].std(), w.std(), rtol=0.3,
                                       err_msg=key)
            bound = 2 * np.sqrt(1.0 / np.prod(w.shape[:-1])) / 0.8796
            assert np.abs(got[key]).max() <= bound * 1.0001, key
    _assert_tree_close(stats, want["batch_stats"], 0, 0)
    assert params["conv_init"]["kernel"].is_contiguous(
        memory_format=torch.channels_last)


def test_init_draws_on_one_thread_whatever_the_thread_count(monkeypatch):
    """Every conv kernel's erfinv runs on one intra-op thread (the guard
    the MLP's draw takes, ``models/draws.py``), so the weights are the
    seed's alone in every process; the caller's thread count is left as
    it was."""
    threads = torch.get_num_threads()
    erfinv_ = torch.Tensor.erfinv_
    seen = []

    def spy(t):
        seen.append(torch.get_num_threads())
        return erfinv_(t)

    monkeypatch.setattr(torch.Tensor, "erfinv_", spy)
    model = _tiny(block_cls=resnet.BottleneckBlock)
    try:
        draws = []
        for n in (1, 4):
            torch.set_num_threads(n)
            draws.append(flatten_with_keys(
                model.init(torch.Generator().manual_seed(3))[0])[0])
            assert torch.get_num_threads() == n
    finally:
        torch.set_num_threads(threads)
    kernels = [k for k in draws[0] if k.endswith("kernel")]
    assert len(seen) == 2 * len(kernels) and set(seen) == {1}
    for k in kernels:
        assert torch.equal(draws[0][k], draws[1][k]), k


@pytest.mark.parametrize("size,kernel,stride,pads", [
    (224, 7, 2, (2, 3)), (112, 3, 2, (0, 1)), (56, 3, 2, (0, 1)),
    (57, 3, 2, (1, 1)), (56, 1, 2, (0, 0)), (28, 3, 1, (1, 1)),
    (9, 7, 2, (3, 3)),
])
def test_same_pads(size, kernel, stride, pads):
    assert resnet.same_pads(size, kernel, stride) == pads


@pytest.mark.parametrize("size", [8, 9])
@pytest.mark.parametrize("kernel,stride", [(7, 2), (3, 2), (1, 2), (3, 1)])
def test_same_conv_and_max_pool_match_flax(size, kernel, stride):
    import flax.linen as nn

    rng = np.random.default_rng(size * 10 + kernel)
    x = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    w = rng.normal(size=(kernel, kernel, 3, 5)).astype(np.float32)
    conv = nn.Conv(5, (kernel, kernel), (stride, stride), padding="SAME",
                   use_bias=False)
    want = conv.apply({"params": {"kernel": w}}, x)
    scope = resnet._Scope(
        {"c": {"kernel": torch.as_tensor(w).permute(3, 2, 0, 1)}}, {},
        False, torch.float32)
    got = scope.conv("c", torch.as_tensor(x).permute(0, 3, 1, 2), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    want = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
    got = resnet._max_pool_same(torch.as_tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.fixture(scope="module")
def resnet50_f32():
    ref = ref_resnet.ResNet50(dtype=jnp.float32)
    variables = _perturbed(jax.jit(lambda: ref.init(
        jax.random.key(0), jnp.zeros((2, 64, 64, 3)), train=False))())
    model = resnet.ResNet50(dtype=torch.float32)
    return ref, variables, model, model.params_from_jax(
        variables["params"], variables["batch_stats"])


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size", [64, 57])
def test_resnet50_f32_matches_reference(resnet50_f32, size, train):
    ref, variables, model, (params, stats) = resnet50_f32
    x = np.random.default_rng(size).normal(size=(2, size, size, 3)).astype(
        np.float32)
    if train:
        want, mutated = jax.jit(lambda v, x: ref.apply(
            v, x, train=True, mutable=["batch_stats"]))(variables, x)
        want_stats = mutated["batch_stats"]
    else:
        want = jax.jit(lambda v, x: ref.apply(v, x, train=False))(variables, x)
        want_stats = variables["batch_stats"]
    with torch.no_grad():
        got, new_stats = model.apply(params, stats, torch.as_tensor(x),
                                     train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    _assert_tree_close(new_stats, want_stats, 2e-4, 2e-4)


def test_bf16_forward_matches_reference():
    """bf16 compute over f32 params: within two bf16 ulps at the logits'
    scale (1.6e-2; each layer rounds to bf16 after sums taken in another
    order), and the running statistics (f32) within 2e-3."""
    ref = _tiny(ref=True, dtype=jnp.bfloat16)
    variables = _perturbed(jax.jit(lambda: ref.init(
        jax.random.key(2), jnp.zeros((2, 28, 28, 1)), train=False))())
    model = _tiny(dtype=torch.bfloat16)
    params, stats = model.params_from_jax(variables["params"],
                                          variables["batch_stats"])
    x = np.random.default_rng(5).normal(size=(16, 28, 28, 1)).astype(
        np.float32)
    for train in (False, True):
        want, mutated = jax.jit(lambda v, x: ref.apply(
            v, x, train=train, mutable=["batch_stats"]))(variables, x)
        with torch.no_grad():
            got, new_stats = model.apply(params, stats, torch.as_tensor(x),
                                         train=train)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1.6e-2, atol=1.6e-2)
        _assert_tree_close(new_stats, mutated["batch_stats"], 2e-3, 2e-3)


def test_batch_norm_gradient_matches_flax():
    """The custom backward (the input's and scale's and bias's gradients)
    against autodiff through flax's BatchNorm, f32."""
    import flax.linen as nn

    rng = np.random.default_rng(3)
    x = (1.5 + rng.normal(size=(4, 5, 5, 6))).astype(np.float32)
    scale = (1 + 0.1 * rng.normal(size=6)).astype(np.float32)
    bias = rng.normal(size=6).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    bn = nn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    stats = {"mean": np.zeros(6, np.float32), "var": np.ones(6, np.float32)}

    def f(x, scale, bias):
        y, _ = bn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": stats}, x, mutable=["batch_stats"])
        return jnp.sum(y * gy)

    want = jax.grad(f, argnums=(0, 1, 2))(x, scale, bias)
    leaves = [torch.as_tensor(a).requires_grad_()
              for a in (x.transpose(0, 3, 1, 2), scale, bias)]
    scope = resnet._Scope({"bn": {"scale": leaves[1], "bias": leaves[2]}},
                          {"bn": {k: torch.as_tensor(v)
                                  for k, v in stats.items()}},
                          True, torch.float32)
    y = scope.norm("bn", leaves[0])
    (y * torch.as_tensor(gy).permute(0, 3, 1, 2)).sum().backward()
    got = [leaves[0].grad.permute(0, 2, 3, 1), leaves[1].grad, leaves[2].grad]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-5)


def test_params_from_jax_rejects_what_does_not_fit():
    ref = _tiny(ref=True)
    variables = ref.init(jax.random.key(0), jnp.zeros((2, 28, 28, 1)),
                         train=False)
    model = _tiny()
    params = ref_flatten_with_keys(variables["params"])[0]
    stats = variables["batch_stats"]
    with pytest.raises(ValueError, match="do not match"):
        model.params_from_jax({**params, "extra/kernel": np.zeros(3)}, stats)
    bad = dict(params)
    bad["head/bias"] = np.zeros(11, np.float32)
    with pytest.raises(ValueError, match="does not fit"):
        model.params_from_jax(bad, stats)


def test_cross_entropy_matches_reference():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (8, 50)).astype(np.float32)
    labels = rng.integers(0, 50, 8).astype(np.int32)
    for ls in (0.0, 0.1):
        np.testing.assert_allclose(
            float(resnet.cross_entropy_loss(torch.as_tensor(logits),
                                            torch.as_tensor(labels), ls)),
            float(ref_resnet.cross_entropy_loss(jnp.asarray(logits),
                                                jnp.asarray(labels), ls)),
            rtol=1e-6)


@pytest.mark.parametrize("placement", ["replicated", "sharded"])
def test_momentum_step_matches_reference(placement):
    """One momentum PS step (tiny ResNet, batch 32) against the reference's
    KVStore step on its 8-device CPU mesh and a plain optax step."""
    ref = _tiny(ref=True)
    images, labels = next(mnist_batches(32, seed=3))
    batch = (jnp.asarray(images), jnp.asarray(labels))
    variables = ref.init(jax.random.key(1), batch[0][:2], train=False)
    params0, state0 = variables["params"], variables["batch_stats"]
    loss_fn = ref_resnet.make_loss_fn(ref)

    opt = optax.sgd(0.1, momentum=0.9)
    (plain_loss, plain_bn), grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params0, batch, state0)
    updates, _ = opt.update(grads, opt.init(params0), params0)
    plain_params = optax.apply_updates(params0, updates)

    ps_tpu.init(backend="tpu")
    try:
        store = ps_tpu.KVStore(optimizer="momentum", learning_rate=0.1,
                               momentum=0.9, placement=placement)
        store.init(params0)
        run = store.make_step(loss_fn, has_aux=True)
        ref_loss, ref_params, ref_bn = run(store.shard_batch(batch), state0)
        ref_keys = store.keys()
    finally:
        ps_tpu.shutdown()

    ps_tpu_torch.init(backend="cuda", device="cpu")
    model = _tiny()
    params, stats = model.params_from_jax(params0, state0)
    store = ps_tpu_torch.KVStore(optimizer="momentum", learning_rate=0.1,
                                 momentum=0.9, placement=placement)
    store.init(params)
    assert store.keys() == ref_keys
    assert store.collective_bytes == 0
    loss, new_params, new_bn = store.make_step(
        resnet.make_loss_fn(model), has_aux=True)(
            store.shard_batch((images, labels)), stats)
    for want_loss, want_params, want_bn in (
            (ref_loss, ref_params, ref_bn),
            (plain_loss, plain_params, plain_bn)):
        np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
        _assert_tree_close(new_params, want_params, 2e-4, 2e-5)
        _assert_tree_close(new_bn, want_bn, 2e-4, 2e-5)


def test_training_decreases_loss():
    ps_tpu_torch.init(backend="cuda", device="cpu")
    model = _tiny()
    params, model_state = model.init(torch.Generator().manual_seed(0),
                                     in_channels=1)
    store = ps_tpu_torch.KVStore(optimizer="momentum", learning_rate=0.5,
                                 momentum=0.9, placement="sharded")
    store.init(params)
    run = store.make_step(resnet.make_loss_fn(model), has_aux=True)
    losses = []
    for images, labels in mnist_batches(64, seed=0, steps=40):
        loss, _, model_state = run(store.shard_batch((images, labels)),
                                   model_state)
        losses.append(float(loss))
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) - 0.2, losses


def test_trainer_runs_tiny_on_cpu(tmp_path, capsys):
    """Three steps of the ResNet-50 trainer at 32², batch 2, f32, from a
    column-npy dataset (``--data``), with a JSONL log."""
    rng = np.random.default_rng(0)
    write_dataset(str(tmp_path / "data"), {
        "images": rng.normal(size=(6, 32, 32, 3)).astype(np.float32),
        "labels": rng.integers(0, 1000, 6).astype(np.int32)})
    s = train_resnet50.main([
        "--device", "cpu", "--steps", "3", "--batch-size", "2",
        "--image-size", "32", "--dtype", "float32", "--lr", "0.01",
        "--data", str(tmp_path / "data"),
        "--jsonl", str(tmp_path / "log.jsonl")])
    out = capsys.readouterr().out.splitlines()
    assert s["steps"] == 2 and s["examples_per_sec"] > 0
    assert "imgs/s/chip" in out[-1] and "collective bytes 0.00 GB" in out[-1]
    assert out[-2].startswith("input: the steps after warm-up waited")
    assert len((tmp_path / "log.jsonl").read_text().splitlines()) == 3
    with pytest.raises(SystemExit, match="steps"):
        train_resnet50.main(["--device", "cpu", "--steps", "1"])


@pytest.mark.parametrize("name,family", [
    ("sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc",
     "convolution"),
    ("void cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop>",
     "convolution"),
    ("nvjet_tst_64x512_64x2_1x2_h_bz_coopB_NNT", "matmul"),
    ("void at::native::(anonymous namespace)::max_pool_backward_nhwc<>",
     "pooling"),
    ("void at::native::batch_norm_backward_reduce_channels_last_kernel<4>",
     "batch_norm"),
    ("void at::native::reduce_kernel<128, 4, at::native::ReduceOp<float>>",
     "reduction"),
    ("void at::native::multi_tensor_apply_kernel<>", "foreach"),
    ("Memcpy HtoD (Pinned -> Device)", "copy"),
    ("void at::native::vectorized_elementwise_kernel<8, CUDAFunctor_add>",
     "elementwise"),
    ("void some_other_kernel", "other"),
])
def test_profile_names_kernel_families(name, family):
    """The trainers' --profile-dir table groups kernels by these names
    (taken from a ResNet-50 step's trace on the card)."""
    assert profiling._family(name) == family


def test_trace_writes_the_trace_and_the_step_table(tmp_path, capsys):
    """``trace`` records steps 2 to ``steps - 1``, writes ``trace.json`` and
    prints the busy share and the time a step; without a directory it is a
    no-op, and it refuses fewer than 3 steps."""
    with trace(str(tmp_path), "cpu", 4) as mark:
        for _ in range(4):
            torch.ones(64).cumsum(0)
            mark()
    out = capsys.readouterr().out
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert "profile: device busy" in out
    assert "a step over 2 traced steps" in out
    with trace(None, "cpu", 1) as mark:
        mark()
    assert capsys.readouterr().out == ""
    with pytest.raises(ValueError, match="3 steps"):
        with trace(str(tmp_path), "cpu", 2):
            pass
