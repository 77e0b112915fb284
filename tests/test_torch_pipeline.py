"""The port's concurrent sweep pipeline and the split encoder, on the CPU.

Concurrency is a scheduling change, never a semantic one: the pipelined
results must equal the serial path's bitwise, come back in submission
order with at most ``max_in_flight`` sweeps held, and the split encoder
(``progressive_encode_start`` + ``_finish``) must write the bytes of
``progressive_encode`` and of the JAX package's encoder (float32, same
weights). The coders' ``stats`` and the kernel launch counter must stay
exact under concurrent callers.
"""

import sys
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.codec import PICCodec as JPICCodec
from epic_tpu.codec import progressive_encode as j_encode
from epic_tpu.models.pic import VarianceMaskingPIC as JPIC
from epic_tpu_torch import (PICCodec, SweepPipeline, VarianceMaskingPIC,
                            from_jax_params, progressive_decode_all,
                            progressive_encode, progressive_encode_finish,
                            progressive_encode_start, run_sweeps)
from epic_tpu_torch.ops.gdn_kernel import gdn
from epic_tpu_torch.tools.workload import pipelined_sweeps
from test_torch_layers import random_params
from test_torch_pic import TINY
from test_torch_rem import TINY_REM, _pair

Q_LIST = [0.5, 2.0, 10.0]


def _batches(n, b=1, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((b, 64, 64, 3), dtype=np.float32) for _ in range(n)]


@pytest.fixture(scope="module")
def pic():
    """JAX and port codecs of the tiny ``pic`` model, same weights."""
    jmodel = JPIC(**TINY)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.key(0)}, jnp.zeros((1, 64, 64, 3)),
        method="init_all"))["params"]
    params = random_params(dict(shapes), seed=7)
    model = VarianceMaskingPIC(**TINY)
    model.load_state_dict(from_jax_params(params, model))
    return JPICCodec(jmodel, {"params": params}), PICCodec(model,
                                                           device="cpu")


def _serial(codec, x, rems=False, q_list=Q_LIST):
    st = {}
    bs, bits = progressive_encode(codec, x, q_list, rems=rems, state=st)
    out = progressive_decode_all(codec, bs, rems, st["auto_ckpts"])
    return bs, bits, st, out["x_hat"]


def _assert_same_sweep(res, bs, bits, x_hat):
    assert res["bitstreams"]["y"] == bs["y"]
    assert res["bitstreams"]["z"] == bs["z"]
    np.testing.assert_array_equal(res["bitstreams"]["prefix"], bs["prefix"])
    assert res["bits"] == bits
    assert torch.equal(res["x_hat"], x_hat)


def test_pipeline_matches_serial_bitwise(pic):
    codec = pic[1]
    xs = _batches(4, b=2)
    pipe = SweepPipeline(codec, Q_LIST, workers=3)
    results = list(pipe.run(xs))
    assert len(results) == len(xs)
    for x, res in zip(xs, results):
        bs, bits, _, x_hat = _serial(codec, x)
        _assert_same_sweep(res, bs, bits, x_hat)
    assert pipe.timing["encode_finish_s"] > 0 and pipe.timing["decode_s"] > 0
    assert set(pipe.finish_phases) == {"device_s", "rans_s"}


def test_rem_pipeline_matches_serial():
    _, codec, _ = _pair(TINY_REM)
    xs = _batches(3, seed=10)
    results = run_sweeps(codec, xs, Q_LIST, rems=True, workers=2)
    for x, res in zip(xs, results):
        bs, bits, st, x_hat = _serial(codec, x, rems=True)
        _assert_same_sweep(res, bs, bits, x_hat)
        for a, b in zip(res["ckpts"], st["auto_ckpts"]):
            assert torch.equal(a, b)


def test_max_in_flight_bounds_and_order(pic):
    codec = pic[1]
    xs = _batches(5, seed=20)
    pulled = []

    def source():
        for i, x in enumerate(xs):
            pulled.append(i)
            yield x

    pipe = SweepPipeline(codec, [1.0, 10.0], workers=2, max_in_flight=2,
                         decode=False)
    results = []
    for res in pipe.run(source()):
        # the batches pulled but not yet yielded are the sweeps held
        assert len(pulled) - len(results) <= 2
        results.append(res)
    assert len(results) == 5 and "x_hat" not in results[0]
    for x, res in zip(xs, results):
        bs, _ = progressive_encode(codec, x, [1.0, 10.0])
        assert res["bitstreams"]["y"] == bs["y"]


def test_encode_start_finish_is_progressive_encode(pic):
    codec = pic[1]
    x = _batches(1, b=2, seed=3)[0]
    st = progressive_encode_start(codec, x, Q_LIST)
    assert st["event"] is None and len(st["host"]) == 6
    timing = {}
    bs, bits = progressive_encode_finish(codec, st, timing)
    assert set(timing) == {"device_s", "rans_s"}
    bs_ref, bits_ref = progressive_encode(codec, x, Q_LIST)
    assert bs["y"] == bs_ref["y"] and bs["z"] == bs_ref["z"]
    np.testing.assert_array_equal(bs["prefix"], bs_ref["prefix"])
    assert bits == bits_ref


def test_pipelined_streams_equal_jax_encode(pic):
    """Batch 2, float32, same weights: the port's pipelined streams are
    the JAX package's progressive_encode bytes."""
    jcodec, codec = pic
    xs = _batches(2, b=2, seed=30)
    results = run_sweeps(codec, xs, Q_LIST, workers=2)
    for x, res in zip(xs, results):
        jbs, jbits = j_encode(jcodec, x, Q_LIST)
        assert res["bitstreams"]["y"] == jbs["y"]
        assert res["bitstreams"]["z"] == jbs["z"]
        np.testing.assert_array_equal(res["bitstreams"]["prefix"],
                                      jbs["prefix"])
        assert res["bits"][:2] == jbits[:2]
        assert list(res["bits"][2]) == list(jbits[2])


def test_pipelined_sweeps_keep_the_first_two(pic):
    """The bench loop's timed region on uint8 batches: bits and bpp for
    every sweep, the first two sweeps kept for the metrics."""
    codec = pic[1]
    rng = np.random.default_rng(4)
    u8 = [(rng.random((2, 64, 64, 3)) * 255).astype(np.uint8)
          for _ in range(3)]
    seen = []
    run = pipelined_sweeps(codec, u8, workers=2, q_list=Q_LIST,
                           on_result=lambda k, res: seen.append(k))
    assert seen == [0, 1, 2] and len(run["kept"]) == 2
    for b, bpp, x8 in zip(run["bits"], run["bpp"], u8):
        bs, bits = progressive_encode(codec, x8.astype(np.float32) / 255.0,
                                      Q_LIST)
        assert b == bits[0] + bits[1] + sum(bits[2])
        assert bpp[-1] == pytest.approx(b / (2 * 64 * 64))


@pytest.fixture
def fast_switching():
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        yield
    finally:
        sys.setswitchinterval(old)


def _hammer(fn, n_threads=4):
    threads = [threading.Thread(target=fn) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()


def test_coder_stats_exact_under_threads(pic, fast_switching):
    coder = pic[1].y_coder
    coder.stats.update({k: type(v)(0) for k, v in coder.stats.items()})
    rng = np.random.default_rng(5)
    sym = rng.integers(-3, 4, 2000).astype(np.int32)
    idx = rng.integers(0, 64, 2000).astype(np.int32)
    blobs = coder.encode_batch(sym, idx, [1000, 1000])
    n = 50

    def work():
        for _ in range(n):
            coder.encode_batch(sym, idx, [1000, 1000])
            coder.decode_batch(blobs, idx, [1000, 1000])

    _hammer(work)
    s = coder.stats
    assert s["encode_calls"] == 4 * n + 1 and s["decode_calls"] == 4 * n
    assert s["encode_syms"] == (4 * n + 1) * 2000
    assert s["decode_syms"] == 4 * n * 2000
    assert s["encode_s"] > 0 and s["decode_s"] > 0


def test_launch_counts_exact_under_threads(fast_switching):
    """``gdn.launches.add``, what the kernel wrapper calls per launch."""
    counts = gdn.launches
    before = dict(counts)
    n = 20_000

    def work():
        for k in range(n):
            counts.add("igdn" if k % 4 == 0 else "gdn")

    try:
        _hammer(work)
        assert counts["gdn"] - before["gdn"] == 4 * n * 3 // 4
        assert counts["igdn"] - before["igdn"] == 4 * n // 4
    finally:
        counts.update(before)
