"""Ring and Ulysses attention across 'seq' gloo ranks, the port against
the reference (``tests/test_ring_attention.py``).

Each rank holds its block of global [B, T, H, D] q/k/v (its 'data' slice
of B, its 'seq' slice of T). Both ops, causal and not, give each rank its
block of full attention and of the reference's ``ring_attention`` /
``ulysses_attention`` on its 8-device mesh within that test's 2e-5; the
gradients of ``sum(out ** 2)`` through the ring's permutes and the
all-to-alls equal the reference's full-attention gradients within its
5e-4. On a mesh of one 'seq' axis of 4 (the batch whole on every rank)
the ring runs three hops. Ulysses refuses heads that do not divide by
the axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import ps_tpu
import test_torch_ranks_harness as torch_ranks
from ps_tpu.parallel.ring_attention import (ring_attention,
                                            sequence_sharding,
                                            ulysses_attention)
from ps_tpu_torch.parallel.mesh import Mesh
from ps_tpu_torch.parallel.ring_attention import (
    ring_attention as port_ring, ulysses_attention as port_ulysses)

B, T, H, D = 4, 32, 8, 16
K = 4
OUT_TOL = {"rtol": 2e-5, "atol": 2e-5}
GRAD_TOL = {"rtol": 5e-4, "atol": 5e-4}
OPS = [("ring", True), ("ring", False), ("ulysses", True),
       ("ulysses", False)]


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _reference(q, k, v, causal):
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) * (D ** -0.5)
    if causal:
        s = jnp.where(jnp.tril(jnp.ones((T, T), bool))[None, None], s, -1e30)
    return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, axis=-1), v)


def _block(x, coords, shape):
    """A rank's block of a global [B, T, ...] array."""
    dp, sp = shape.get("data", 1), shape.get("seq", 1)
    b, t = x.shape[0] // dp, x.shape[1] // sp
    d, s = coords.get("data", 0), coords.get("seq", 0)
    return x[d * b:(d + 1) * b, s * t:(s + 1) * t]


def _coords(rank, shape):
    return dict(zip(shape, map(int, np.unravel_index(rank,
                                                     tuple(shape.values())))))


@pytest.fixture(scope="module")
def dp_sp(tmp_path_factory):
    """Every op of OPS on ``{data: 2, seq: 2}`` (one group)."""
    q, k, v = _qkv()
    cases = [("seq_attention", dict(q=q, k_=k, v=v, op=op, causal=causal))
             for op, causal in OPS]
    return torch_ranks.run_ranks(K, cases, tmp_path_factory.mktemp("sp"),
                                 init={"mesh_shape": {"data": 2, "seq": 2}})


@pytest.fixture(scope="module")
def ref_ops():
    """The reference's ops on its ``{data: 2, seq: 4}`` mesh."""
    q, k, v = map(jnp.asarray, _qkv())
    ps_tpu.init(backend="tpu", mesh_shape={"data": 2, "seq": 4})
    try:
        mesh = ps_tpu.current_context().mesh
        sh = sequence_sharding(mesh)
        qs, ks, vs = (jax.device_put(x, sh) for x in (q, k, v))
        fns = {"ring": ring_attention, "ulysses": ulysses_attention}
        return {(op, causal): np.asarray(fns[op](qs, ks, vs, mesh,
                                                 causal=causal))
                for op, causal in OPS}
    finally:
        ps_tpu.shutdown()


@pytest.mark.parametrize("i", range(len(OPS)),
                         ids=[f"{op}-{'causal' if c else 'full'}"
                              for op, c in OPS])
def test_matches_full_attention_and_the_reference(dp_sp, ref_ops, i):
    op, causal = OPS[i]
    q, k, v = map(jnp.asarray, _qkv())
    want = np.asarray(_reference(q, k, v, causal))
    shape = {"data": 2, "seq": 2}
    for r, out in enumerate(dp_sp):
        coords = _coords(r, shape)
        got = out[i]["out"]
        np.testing.assert_allclose(got, _block(want, coords, shape),
                                   **OUT_TOL)
        np.testing.assert_allclose(got, _block(ref_ops[(op, causal)],
                                               coords, shape), **OUT_TOL)
        coll = {"ring": ("ppermute", "seq"),
                "ulysses": ("all_to_all", "seq")}[op]
        assert coll in out[i]["calls"]


@pytest.mark.parametrize("i", range(len(OPS)),
                         ids=[f"{op}-{'causal' if c else 'full'}"
                              for op, c in OPS])
def test_gradients_flow(dp_sp, i):
    """The gradients of the global ``sum(out ** 2)`` with respect to each
    rank's blocks (the backward re-runs the ring in reverse, the
    all-to-alls swapped) equal the reference's full attention's."""
    op, causal = OPS[i]
    q, k, v = map(jnp.asarray, _qkv())
    want = jax.grad(lambda q, k, v: jnp.sum(_reference(q, k, v, causal)
                                            ** 2), argnums=(0, 1, 2))(q, k, v)
    shape = {"data": 2, "seq": 2}
    for r, out in enumerate(dp_sp):
        coords = _coords(r, shape)
        for got, w in zip(out[i]["grads"], want):
            np.testing.assert_allclose(got, _block(np.asarray(w), coords,
                                                   shape), **GRAD_TOL)


def test_ring_on_a_seq_only_mesh(tmp_path):
    """The whole group on 'seq' (3 hops), the batch whole on every rank
    (``test_ring_under_jit_and_seq_only_mesh``)."""
    q, k, v = _qkv(seed=3)
    want = np.asarray(_reference(*map(jnp.asarray, (q, k, v)), True))
    out = torch_ranks.run_ranks(
        K, [("seq_attention", dict(q=q, k_=k, v=v, op="ring", causal=True))],
        tmp_path, init={"mesh_shape": {"seq": K}})
    for r, got in enumerate(out):
        np.testing.assert_allclose(got[0]["out"],
                                   _block(want, {"seq": r}, {"seq": K}),
                                   **OUT_TOL)


def test_ulysses_rejects_indivisible_heads():
    import torch

    q, k, v = (torch.tensor(x[:, :, :6]) for x in _qkv())
    with pytest.raises(ValueError, match="divisible"):
        port_ulysses(q, k, v, Mesh({"seq": 8}))


def test_one_rank_is_full_attention():
    """On a mesh without a 'seq' axis both ops are full attention (no
    hop, no swap)."""
    import torch

    q, k, v = _qkv(seed=7)
    want = np.asarray(_reference(*map(jnp.asarray, (q, k, v)), True))
    for fn in (port_ring, port_ulysses):
        got = fn(*(torch.tensor(x) for x in (q, k, v)), Mesh({"data": 1}),
                 causal=True)
        np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)
