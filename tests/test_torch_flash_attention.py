"""The port's flash attention against the reference's, case for case with
tests/test_flash_attention.py.

Inputs are made from a seed with numpy and given to both packages. The
reference runs its Pallas kernel in interpret mode on the CPU; the port
runs its plain version (a CPU tensor never reaches the CUDA kernel) and
its blockwise backward through the ``torch.autograd.Function``.
Tolerances are the reference's own: forward rtol/atol 2e-5 in f32, input
gradients 5e-4; in bf16, 1.6e-2 (two bf16 ulps: both round ``p`` and the
output to bf16, at points a sum order apart).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ps_tpu.models.lm import _full_attention
from ps_tpu.ops import flash_attention as ref_flash_attention
from ps_tpu_torch.ops.flash_attention import flash_attention

B, S, H, D = 2, 256, 4, 64

# the module itself: ps_tpu_torch.ops exports the function under its name
fa = importlib.import_module("ps_tpu_torch.ops.flash_attention")


def _qkv(seed, s=S):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (B, s, H, D)).astype(np.float32)
            for _ in range(3)]


def _mask(seed, s=S, rate=0.8):
    mask = (np.random.default_rng(seed).random((B, s)) < rate).astype(np.int32)
    # keep key 0 valid: a causal row whose every visible key is masked is
    # degenerate (zeros here, uniform garbage in an einsum reference)
    mask[:, 0] = 1
    return mask


def _port(qkv, mask=None, causal=False, grad=False, dtype=torch.float32):
    ts = [torch.tensor(x, dtype=dtype, requires_grad=grad) for x in qkv]
    m = None if mask is None else torch.as_tensor(mask)
    return ts, flash_attention(*ts, mask=m, causal=causal)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_reference(causal, masked):
    qkv = _qkv(0)
    mask = _mask(2) if masked else None
    _, got = _port(qkv, mask, causal)
    want = ref_flash_attention(
        *map(jnp.asarray, qkv), causal=causal,
        mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)
    if not masked:  # the LM's einsum attention op, the drop-in contract
        full = _full_attention(*map(jnp.asarray, qkv), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(full), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gradients_match_reference(causal):
    qkv = _qkv(3)
    mask = _mask(4)
    ts, out = _port(qkv, mask, causal, grad=True)
    (out ** 2).sum().backward()

    def loss_ref(q, k, v):
        return jnp.sum(ref_flash_attention(q, k, v, mask=jnp.asarray(mask),
                                           causal=causal) ** 2)

    g_want = jax.grad(loss_ref, argnums=(0, 1, 2))(*map(jnp.asarray, qkv))
    for t, want, name in zip(ts, g_want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want),
                                   rtol=5e-4, atol=5e-4, err_msg=name)


def test_fully_masked_rows_emit_zeros_fwd_and_bwd():
    qkv = _qkv(7, s=128)
    mask = np.zeros((B, 128), np.int32)  # everything padded
    ts, out = _port(qkv, mask, grad=True)
    np.testing.assert_array_equal(out.detach().numpy(), 0.0)
    (out ** 2).sum().backward()
    for t, name in zip(ts, "qkv"):
        np.testing.assert_array_equal(t.grad.numpy(), 0.0, err_msg=name)
    packed = [torch.as_tensor(x).transpose(1, 2).reshape(B * H, 128, D)
              for x in qkv]
    _, lse = fa._flash_fwd_torch(*packed, torch.as_tensor(mask), D ** -0.5,
                                 False, H)
    assert torch.all(lse == -1e30)

    # causal corner: key 0 masked -> row 0 sees nothing -> zeros; later
    # rows see key 1+ and are finite and normal
    mask2 = np.ones((B, 128), np.int32)
    mask2[:, 0] = 0
    _, out2 = _port(qkv, mask2, causal=True)
    out2 = out2.numpy()
    np.testing.assert_array_equal(out2[:, 0], 0.0)
    assert np.isfinite(out2).all() and np.abs(out2[:, 1:]).max() > 0
    _, lse2 = fa._flash_fwd_torch(*packed, torch.as_tensor(mask2), D ** -0.5,
                                  True, H)
    assert torch.all(lse2[:, 0] == -1e30) and torch.all(lse2[:, 1:] > -1e29)


def test_block_divisibility_validated():
    with pytest.raises(ValueError, match="divisible"):
        _port(_qkv(6, s=96))


def test_plain_version_bf16_matches_reference_bf16():
    qkv = _qkv(8, s=128)
    mask = _mask(9, s=128)
    _, got = _port(qkv, mask, dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = ref_flash_attention(*(jnp.asarray(x, jnp.bfloat16) for x in qkv),
                               mask=jnp.asarray(mask))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=1.6e-2, atol=1.6e-2)


def test_cpu_tensors_never_reach_the_kernel():
    before = fa.LAUNCHES
    _port(_qkv(10, s=128))
    assert fa.LAUNCHES == before
    with pytest.raises(ValueError, match="not meta"):
        fa._flash_fwd(*(torch.empty((8, 128, D), device="meta")
                        for _ in range(3)), None, 0.125, False, 4)
