"""Tests of the port's sweep pipeline that need a CUDA device: a tiny
``rem`` pipeline with 2 workers on their own streams is bitwise equal to
the serial path, and the GDN kernel launched from a side stream (and from
two streams at once) gives the main stream's bits. They skip without a
device. This file imports no JAX, so on a machine without it run it
without the repository's conftest:

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_pipeline_cuda.py
"""

import threading

import numpy as np
import pytest
import torch

import epic_tpu_torch as et
from epic_tpu_torch.ops.gdn_kernel import gdn

TINY_REM = dict(n=32, m=32, division=(16, 32), dim_chunk=8,
                param_net_widths=(24, 16), check_levels=(0.25, 0.75),
                rem_dimension="middle")


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
def test_tiny_rem_pipeline_matches_serial_bitwise():
    _need_cuda()
    codec = et.PICCodec(et.get_model("rem", **TINY_REM).init_weights(0))
    rng = np.random.default_rng(0)
    xs = [torch.as_tensor(rng.random((2, 64, 64, 3), dtype=np.float32),
                          device="cuda") for _ in range(4)]
    before = dict(gdn.launches)
    results = et.run_sweeps(codec, xs, rems=True, workers=2,
                            max_in_flight=2)
    torch.cuda.synchronize()
    assert gdn.launches["gdn"] == before["gdn"] + 6 * len(xs)
    assert gdn.launches["igdn"] == before["igdn"] + 9 * len(xs)
    for x, res in zip(xs, results):
        st = {}
        bs, bits = et.progressive_encode(codec, x, rems=True, state=st)
        out = et.progressive_decode_all(codec, bs, True, st["auto_ckpts"])
        assert res["bitstreams"]["y"] == bs["y"]
        assert res["bitstreams"]["z"] == bs["z"]
        np.testing.assert_array_equal(res["bitstreams"]["prefix"],
                                      bs["prefix"])
        assert res["bits"] == bits
        for a, b in zip(res["ckpts"], st["auto_ckpts"]):
            assert torch.equal(a, b)
        assert torch.equal(res["x_hat"], out["x_hat"])


def _gdn_data(rows, c=192, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                        device="cuda")
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    return x, gamma, beta


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_gdn_on_side_streams_gives_main_stream_bits(inverse):
    """One launch on a side stream, then two threads launching on two
    streams at once: every result equals the main stream's bitwise."""
    _need_cuda()
    x, gamma, beta = _gdn_data(393_216)
    want = gdn(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        got = gdn(x, gamma, beta, inverse)
    side.synchronize()
    assert torch.equal(got, want)

    outs = [None, None]

    def work(k):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            outs[k] = [gdn(x, gamma, beta, inverse) for _ in range(4)]
        s.synchronize()

    threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()
    for out in outs:
        for y in out:
            assert torch.equal(y, want)
