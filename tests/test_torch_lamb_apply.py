"""LAMB's two routes, on the CPU: the fused kernel's work table and the
router in ``optim.lamb``.

- ``chunk_table`` (``ops/lamb_apply.py``): every value of every tensor in
  exactly one segment, chunks of at most ``CHUNK`` values, segments in
  tensor order and aligned to the chunk, at BERT-base's 202 shapes, at a
  1-value tensor and at sizes around the chunk.
- On the CPU every key takes the loop: a 202-tensor BERT's LAMB step
  counts 202 in ``ps_lamb_loop_tensors_total`` and 0 in
  ``ps_lamb_fused_tensors_total``.
- The router, with the kernel's route stood in for by a plain twin on CPU
  tensors (the kernel itself runs only on the card,
  tests/test_torch_kernel_cuda.py): every key, half of them or none sent
  to the fused route, the step counted once, the results bitwise equal
  to the loop's over 3 steps, with a float and a scheduled rate; a key
  whose norms wait for other ranks (``ShardNorms.whole``) stays on the
  loop.
"""

import numpy as np
import pytest
import torch

from ps_tpu_torch import obs
from ps_tpu_torch import optim
from ps_tpu_torch.kv import keys
from ps_tpu_torch.models.bert import BertConfig, BertMLM
from ps_tpu_torch.ops import lamb_apply


def _bert_numels():
    model = BertMLM(BertConfig(), device="meta")
    flat, _ = keys.flatten_with_keys(model.param_tree())
    return [p.numel() for p in flat.values()]


def _small_bert_tree():
    """A BERT of BERT-base's 202 tensors at toy widths."""
    cfg = BertConfig(vocab_size=64, hidden_size=16, num_layers=12,
                     num_heads=2, intermediate_size=32, max_len=16,
                     dtype=torch.float32)
    model = BertMLM(cfg, generator=torch.Generator().manual_seed(0))
    flat, _ = keys.flatten_with_keys(model.param_tree())
    return {k: p.detach().clone() for k, p in flat.items()}


C = lamb_apply.CHUNK
SHAPES = {
    "bert_base": _bert_numels,
    "one_value": lambda: [1],
    "around_the_chunk": lambda: [1, 3, C - 1, C, C + 1, 768, 2 * C + 5,
                                 768, 768, 4 * C, 7, C - 4, 5],
}


@pytest.mark.parametrize("chunk", [C, 64])
@pytest.mark.parametrize("shapes", sorted(SHAPES))
def test_chunk_table_covers_every_value_once(shapes, chunk):
    numels = SHAPES[shapes]()
    table, chunks, segments = lamb_apply.chunk_table(numels, chunk)
    n = len(numels)
    assert table.dtype == np.int64
    assert len(table) == (chunks + 1) + 3 * segments + (n + 1)
    chunk_first = table[:chunks + 1]
    seg_tensor, seg_offset, seg_len = (
        table[chunks + 1 + i * segments:chunks + 1 + (i + 1) * segments]
        for i in range(3))
    tensor_seg = table[chunks + 1 + 3 * segments:]
    assert chunk_first[0] == 0 and chunk_first[-1] == segments
    assert np.all(np.diff(chunk_first) > 0)  # no empty chunk
    assert np.all(np.diff(seg_tensor) >= 0)  # tensor order
    assert np.all(seg_offset % chunk == 0) and np.all(seg_len > 0)
    for c in range(chunks):
        run = slice(chunk_first[c], chunk_first[c + 1])
        assert seg_len[run].sum() <= chunk
        assert len(set(seg_tensor[run])) == len(seg_tensor[run])
    covered = [np.zeros(m, np.int32) for m in numels]
    for t, off, ln in zip(seg_tensor, seg_offset, seg_len):
        covered[t][off:off + ln] += 1
    assert all(np.all(cov == 1) for cov in covered)
    assert tensor_seg[0] == 0 and tensor_seg[-1] == segments
    for i in range(n):
        assert np.all(seg_tensor[tensor_seg[i]:tensor_seg[i + 1]] == i)
    if shapes == "bert_base":
        assert n == 202 and sum(numels) == 109_514_298
        if chunk == C:  # 27 chunks of shared small tensors
            assert (chunks, segments) == (6_750, 6_803)


def test_chunk_table_refuses_a_chunk_not_of_whole_vectors():
    with pytest.raises(ValueError):
        lamb_apply.chunk_table([8], chunk=6)


def test_cpu_keys_take_the_loop():
    params = _small_bert_tree()
    assert len(params) == 202
    opt = optim.lamb(learning_rate=1e-3, weight_decay=0.01)
    state = opt.init(params)
    rng = np.random.default_rng(0)
    fused0 = optim.FUSED_TENSORS.value
    loop0 = optim.LOOP_TENSORS.value
    before = obs.default_registry().snapshot()
    for _ in range(2):
        grads = {k: torch.as_tensor(rng.normal(size=tuple(p.shape))
                                    .astype(np.float32))
                 for k, p in params.items()}
        opt.step_(params, grads, state)
    assert optim.FUSED_TENSORS.value == fused0
    assert optim.LOOP_TENSORS.value == loop0 + 2 * 202
    after = obs.default_registry().snapshot()
    assert (after["ps_lamb_loop_tensors_total"]
            - before.get("ps_lamb_loop_tensors_total", 0)) == 404
    assert (after["ps_lamb_fused_tensors_total"]
            == before.get("ps_lamb_fused_tensors_total", 0))
    assert int(state["count"]) == 2


def test_takes_no_cpu_tensor():
    p = torch.zeros(8)
    assert not lamb_apply.takes(p, p.clone(), p.clone(), p.clone())


def _plain_fused(calls):
    """The fused route's contract on CPU tensors: the loop's arithmetic,
    the count incremented first only when asked."""

    def apply_(params, grads, mus, nus, count, lr, b1, b2, eps,
               weight_decay, increment=True, checked=False):
        calls.append((len(params), increment, checked))
        if increment:
            optim._safe_increment_(count)
        bc1 = 1 - b1 ** count
        bc2 = 1 - b2 ** count
        for p, g, mu, nu in zip(params, grads, mus, nus):
            mu.mul_(b1).add_((1 - b1) * g)
            nu.mul_(b2).add_((1 - b2) * (g * g))
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + 0.0) + eps)
            u = u + weight_decay * p
            pn = torch.linalg.vector_norm(p)
            un = torch.linalg.vector_norm(u)
            ratio = torch.where((pn == 0) | (un == 0), torch.ones(()),
                                pn / un)
            p.add_(-lr * (u * ratio))

    return apply_


def _tree(seed):
    rng = np.random.default_rng(seed)
    shapes = {"a": (6, 5), "b": (7,), "c": (3, 4), "d": (9,), "z": (4, 4)}
    tree = {k: torch.as_tensor(rng.normal(size=s).astype(np.float32))
            for k, s in shapes.items()}
    tree["z"].zero_()  # its trust ratio is exactly 1
    return tree


@pytest.mark.parametrize("rate", ["float", "schedule"])
@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("route", ["all", "half", "none"])
def test_router_counts_the_step_once_and_matches_the_loop(monkeypatch, route,
                                                          wd, rate):
    chosen = {"all": set("abcdz"), "half": {"a", "d", "z"},
              "none": set()}[route]
    lr = 1e-2 if rate == "float" else (lambda c: 1e-2 / (1.0 + c))

    def run(fused_keys):
        calls = []
        monkeypatch.setattr(lamb_apply, "takes",
                            lambda p, g, m, v: p.shape[0] in fused_keys)
        monkeypatch.setattr(lamb_apply, "lamb_apply_", _plain_fused(calls))
        params = _tree(0)
        opt = optim.lamb(learning_rate=lr, weight_decay=wd)
        state = opt.init(params)
        fused0, loop0 = (optim.FUSED_TENSORS.value,
                         optim.LOOP_TENSORS.value)
        for step in range(3):
            grads = _tree(step + 1)
            grads["b"].zero_()  # a zero gradient
            opt.step_(params, grads, state)
        rule = state["rule"] if rate == "schedule" else state
        counted = (optim.FUSED_TENSORS.value - fused0,
                   optim.LOOP_TENSORS.value - loop0)
        return params, rule, calls, counted

    # the stand-in takes keys by their first dimension, one per key
    firsts = {k: v.shape[0] for k, v in _tree(0).items()}
    want, want_state, none_calls, _ = run(set())
    got, state, calls, counted = run({firsts[k] for k in chosen})
    assert none_calls == []
    n = len(chosen)
    assert counted == (3 * n, 3 * (5 - n))
    assert calls == ([(n, n == 5, True)] * 3 if n else [])
    assert int(state["count"]) == int(want_state["count"]) == 3
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(state["mu"][k], want_state["mu"][k]), k
        assert torch.equal(state["nu"][k], want_state["nu"][k]), k


def test_keys_whose_norms_wait_for_other_ranks_stay_on_the_loop(monkeypatch):
    calls = []
    monkeypatch.setattr(lamb_apply, "takes", lambda p, g, m, v: True)
    monkeypatch.setattr(lamb_apply, "lamb_apply_", _plain_fused(calls))
    params = _tree(0)
    opt = optim.lamb(learning_rate=1e-2, weight_decay=0.01)
    state = opt.init(params)
    whole = {"a": params["a"].clone()}
    norms = optim.ShardNorms(whole, lambda flat, axis: flat)
    opt.step_(params, _tree(1), state, norms)
    norms.finish()
    assert calls == [(4, False, True)]
    assert int(state["count"]) == 1

