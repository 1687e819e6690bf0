"""The port's gradient codecs (``ps_tpu_torch/compress/``) against the
reference's (``ps_tpu/compress/``), on the same numpy inputs.

- Every codec's frames, and the packed buffer ``pack_frames`` makes of
  them, are the reference's byte for byte, over codec x dtype x shape,
  non-finite values included; each side decodes the other's packed bytes
  to the same array, bitwise (NaN payloads too).
- int8 with the same seed draws the same stream: bit-identical ``q8``
  over several encodes; topk's error-feedback residuals are equal after
  every one of 5 steps; the bf16 cast rounds as ml_dtypes does, on
  random bit patterns and every special class.
- ``resolve_spec`` and ``CompressPolicy``'s selection are the
  reference's; ``GradCompressor`` and ``decode_tree`` give the
  reference's wire trees and decoded trees.
- Interop over loopback on the CPU: a reference ``connect_async`` worker
  with a codec against the port's ``serve_async``, and a port worker
  against the reference's, serial and bucketed (with pull compression
  where the codec allows it): the server's parameters are bitwise those
  the same server reaches under a worker of its own package, so the
  packed frames were interchangeable.

Every comparison is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import ps_tpu_torch
from ps_tpu_torch import compress as port
from ps_tpu_torch.compress import codecs as port_codecs
from tests import test_torch_van_harness as harness

SHAPES = [(), (0,), (7,), (33, 17), (3, 1029)]
DTYPES = ["float32", "float16", "int32"]
CODECS = ["none", "cast16", "int8", "topk"]


def _ref():
    from ps_tpu import compress as ref

    return ref


def _array(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal(shape) * 3).astype(dtype)
    if dtype == "float32" and a.size >= 7:
        flat = a.reshape(-1)
        flat[:4] = [np.nan, np.inf, -np.inf, 1e-42]  # a subnormal too
    return a


def _codec_pair(name, **kw):
    ref = _ref()
    return port.make_codec(name, **kw), ref.make_codec(name, **kw)


def _same_frames(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert g.tobytes() == w.tobytes(), k


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s))
                         or "scalar")
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", CODECS)
def test_frames_and_packed_bytes_are_the_references(name, dtype, shape):
    ref = _ref()
    kw = {"fraction": 0.1} if name == "topk" else {}
    mine, theirs = _codec_pair(name, **kw)
    arr = _array(shape, dtype)
    got, want = mine.encode("k", arr), theirs.encode("k", arr)
    _same_frames(got, want)
    packed = port.pack_frames(name, got)
    assert packed.tobytes() == ref.pack_frames(name, want).tobytes()
    # each side decodes the other's bytes to the same array, bitwise
    a = port.decode_packed(ref.pack_frames(name, want))
    b = ref.decode_packed(packed)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_int8_same_seed_gives_bit_identical_q8(seed):
    mine, theirs = _codec_pair("int8", seed=seed, chunk=256)
    for step in range(4):
        arr = _array((5, 300), "float32", seed=step)
        got, want = mine.encode("g", arr), theirs.encode("g", arr)
        _same_frames(got, want)
        assert got["q8"].tobytes() == want["q8"].tobytes()


@pytest.mark.parametrize("fraction", [0.01, 0.25, 1.0])
def test_topk_residuals_equal_over_five_steps(fraction):
    mine, theirs = _codec_pair("topk", fraction=fraction)
    for step in range(5):
        for key in ("a", "b"):
            arr = _array((40, 25), "float32", seed=10 * step + len(key))
            _same_frames(mine.encode(key, arr), theirs.encode(key, arr))
        assert sorted(mine._residual) == sorted(theirs._residual)
        for key, r in theirs._residual.items():
            assert mine._residual[key].tobytes() == r.tobytes()
        # NaN inputs leave NaN residuals: equal as NaN
        assert np.array_equal([mine.residual_norm()],
                              [theirs.residual_norm()], equal_nan=True)


def test_bf16_rounding_is_ml_dtypes_bit_for_bit():
    import ml_dtypes

    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64).astype(
        np.uint32)
    special = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                        0x7FFFFFFF, 0xFFFFFFFF, 0x7F800000, 0xFF800000,
                        0x7F7FFFFF, 0x00000001, 0x80000001, 0x007FFFFF,
                        0x3F808000, 0x3F818000, 0, 0x80000000], np.uint32)
    a = np.concatenate([bits, special]).view(np.float32)
    with np.errstate(invalid="ignore"):
        want = a.astype(ml_dtypes.bfloat16).view(np.uint16)
    got = port_codecs.f32_to_bf16_bits(a)
    assert got.tobytes() == want.tobytes()
    back = want.view(ml_dtypes.bfloat16).astype(np.float32)
    assert port_codecs.bf16_bits_to_f32(want).tobytes() == back.tobytes()


def test_cast16_fp16_mode_and_modes_refused():
    mine, theirs = _codec_pair("cast16", mode="fp16")
    arr = _array((9, 9), "float32")
    _same_frames(mine.encode("k", arr), theirs.encode("k", arr))
    with pytest.raises(ValueError, match="cast16 mode"):
        port.make_codec("cast16", mode="fp8")
    with pytest.raises(ValueError, match="unknown codec"):
        port.make_codec("zstd")
    assert port.available_codecs() == _ref().available_codecs()


@pytest.mark.parametrize("spec,kw", [
    (None, {}), ("", {}), ("none", {}), ({"codec": "none"}, {}),
    ("int8", {}), ("topk", {"topk": 0.05}),
    ({"codec": "cast16", "min_bytes": 10}, {"min_bytes": 4096}),
    ({"codec": "topk", "topk": 0.2, "pull": True}, {"pull": False}),
], ids=["None", "empty", "none", "dict-none", "int8", "topk-override",
        "cast16-min-bytes", "topk-pull"])
def test_resolve_spec_is_the_references(spec, kw):
    assert port.resolve_spec(spec, **kw) == _ref().resolve_spec(spec, **kw)


@pytest.mark.parametrize("spec", [
    "int8", {"codec": "cast16", "min_bytes": 100},
    {"codec": "topk", "topk": 0.3, "exclude": ["bias"], "min_bytes": 0},
    {"codec": "int8", "seed": 9, "min_bytes": 2048},
], ids=["int8-default", "cast16-small-floor", "topk-exclude", "int8-seed"])
def test_policy_selection_is_the_references(spec):
    ref = _ref()
    mine = port.CompressPolicy.from_spec(spec)
    theirs = ref.CompressPolicy.from_spec(spec)
    tree = {"layer/w": _array((64, 64), "float32"),
            "layer/bias": _array((64,), "float32"),
            "ids": np.arange(5000, dtype=np.int32),
            "half": _array((300, 300), "float16"),
            "big/bias": _array((200, 100), "float32")}
    for k, a in tree.items():
        assert mine.select(k, a).name == theirs.select(k, a).name, k
    assert port.CompressPolicy.from_spec("none") is None
    assert mine.enabled and theirs.enabled


@pytest.mark.parametrize("codec", ["cast16", "int8", "topk"])
def test_grad_compressor_and_decode_tree_are_the_references(codec):
    from ps_tpu.utils.metrics import TransportStats as RefStats

    from ps_tpu_torch.utils.metrics import TransportStats

    ref = _ref()
    spec = {"codec": codec, "min_bytes": 1024, "topk": 0.1, "seed": 4}
    mine = port.GradCompressor(port.CompressPolicy.from_spec(spec),
                               stats=TransportStats())
    theirs = ref.GradCompressor(ref.CompressPolicy.from_spec(spec),
                                stats=RefStats())
    for step in range(3):
        tree = {"a/w": _array((50, 40), "float32", seed=step),
                "a/b": _array((40,), "float32", seed=step),
                "c/ids": np.arange(400, dtype=np.int32)}
        got, enc = mine.encode_tree(dict(tree))
        want, renc = theirs.encode_tree(dict(tree))
        assert enc == renc == ["a/w"]
        for k in want:
            assert np.asarray(got[k]).tobytes() == np.asarray(
                want[k]).tobytes(), k
        dec = port.decode_tree(dict(got), enc, stats=mine.stats)
        rdec = ref.decode_tree(dict(want), renc)
        for k in rdec:
            assert dec[k].tobytes() == np.asarray(rdec[k]).tobytes(), k
    assert mine.stats.compress_ratio() > 1.5
    assert mine.stats.summary()["compress_ratio"] > 1.5
    with pytest.raises(KeyError, match="absent"):
        port.decode_tree({}, ["missing"])


def test_unpack_rejects_garbage():
    with pytest.raises(ValueError, match="bad magic"):
        port.unpack_frames(np.zeros(64, np.uint8))


# -- interop over loopback ----------------------------------------------------

SEQ = 4


def _grads(params):
    return [harness.make_grads(params, 0, c) for c in range(SEQ)]


def _port_server(params):
    from ps_tpu_torch.backends.remote_async import serve_async

    ps_tpu_torch.init(backend="cuda", mode="async", num_workers=1,
                      dc_lambda=harness.DC_LAMBDA, device="cpu")
    store = ps_tpu_torch.KVStore(optimizer="sgd",
                                 learning_rate=harness.LR, mode="async")
    store.init({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    svc = serve_async(store)

    def finish():
        out = {k: v.numpy().copy() for k, v in store._engine._params.items()}
        svc.stop()
        ps_tpu_torch.shutdown()
        return out

    return svc.port, finish


def _ref_server(params):
    import jax.numpy as jnp

    import ps_tpu
    from ps_tpu.backends.remote_async import serve_async

    ps_tpu.init(backend="tpu", mode="async", num_workers=1,
                dc_lambda=harness.DC_LAMBDA)
    store = ps_tpu.KVStore(optimizer="sgd", learning_rate=harness.LR,
                           mode="async")
    store.init({k: jnp.asarray(v) for k, v in params.items()})
    svc = serve_async(store)

    def finish():
        out = {k: np.asarray(v).copy()
               for k, v in store._engine._params.items()}
        svc.stop()
        ps_tpu.shutdown()
        return out

    return svc.port, finish


def _drive(package, port_no, params, spec, bucket_bytes):
    """One worker of ``package`` ('port' or 'ref'): pull, then SEQ
    push_pulls through the codec spec."""
    uri = f"127.0.0.1:{port_no}"
    if package == "port":
        from ps_tpu_torch.backends.remote_async import connect_async

        w = connect_async(uri, 0, {k: torch.from_numpy(np.array(v))
                                   for k, v in params.items()},
                          bucket_bytes=bucket_bytes, compress=spec)
        conv = (lambda g: {k: torch.from_numpy(v) for k, v in g.items()})
    else:
        import jax.numpy as jnp

        from ps_tpu.backends.remote_async import connect_async

        w = connect_async(uri, 0, {k: jnp.asarray(v)
                                   for k, v in params.items()},
                          bucket_bytes=bucket_bytes, compress=spec)
        conv = (lambda g: {k: jnp.asarray(v) for k, v in g.items()})
    w.pull_all()
    for g in _grads(params):
        w.push_pull(conv(g))
    assert w.transport.codec_enc_bytes > 0  # the codec ran
    w.close()


@pytest.mark.parametrize("bucket_bytes", [None, 1 << 12],
                         ids=["serial", "bucketed"])
@pytest.mark.parametrize("codec", ["cast16", "int8", "topk"])
@pytest.mark.parametrize("server", ["port", "ref"])
def test_interop_compressed_pushes_land_bitwise(server, codec, bucket_bytes):
    params = harness.model_params()
    spec = {"codec": codec, "min_bytes": 1024, "topk": 0.1,
            "pull": bucket_bytes is not None and codec != "topk"}
    start = _port_server if server == "port" else _ref_server
    other = "ref" if server == "port" else "port"
    finals = {}
    for package in (server, other):
        port_no, finish = start(params)
        try:
            _drive(package, port_no, params, spec, bucket_bytes)
        finally:
            finals[package] = finish()
    for k, v in finals[server].items():
        assert v.tobytes() == finals[other][k].tobytes(), k
