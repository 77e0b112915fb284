"""Tests of the port that need a CUDA device: the GDN kernel against its
plain version (max relative error 1e-5) at the main path's shapes (those
of ``progressive_decode_all``, whose 15 levels fold into the batch,
included), at ragged row counts and at every width it takes, rows whose
bits do not depend on where they sit, and tiny ``pic`` and ``rem`` codec
round trips through the kernel. Its bf16 variant at the same shapes, widths,
row counts and offsets, on side streams and from two threads: bitwise the
float32 variant's output rounded to bf16; 200 launches of each kind
bitwise alike; the bf16 ``GDN`` module call
bitwise the cast, float32 call, cast that it replaces, with as many kernel
launches as a float32 call; x at an address TMA cannot take; bf16 training
gradients bitwise those of the float32 path. The backward kernel against its plain
version (dx and u within 1e-5 of their largest magnitude) and ``GDN``'s
gradients through both kernels against autograd through ``gdn_plain``
and ``gdn_backward_plain`` (dgamma / dbeta within 1e-4: sums over every
row in another order), at small and ragged R, every width, at the edges of
its persistent grid and of its dgamma flushes, x at an unaligned address,
on a side stream and from launch to launch bitwise, float32 and bf16 (bf16
bitwise the float32 variant's, dx rounded; no cast kernel around it), and
a tiny training step through the kernels.
They skip without a device. This file imports no JAX, so on a machine
without it run it without the repository's conftest:

    PYTHONPATH=. python -m pytest --noconftest tests/test_torch_gdn_cuda.py
"""

import numpy as np
import pytest
import torch

import epic_tpu_torch as et
from epic_tpu_torch.ops.gdn import GDN
from epic_tpu_torch.ops.gdn_kernel import (MAX_CHANNELS, backward_clusters,
                                           gdn, gdn_backward,
                                           gdn_backward_plain,
                                           gdn_backward_reduce,
                                           gdn_backward_rows,
                                           gdn_backward_rows_plain,
                                           gdn_differentiable, gdn_plain)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1_474_560, 368_640, 92_160, 98_304,
                                  24_576, 6_144, 21])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_matches_plain(rows, inverse):
    _need_cuda()
    rng = np.random.default_rng(2)
    c = 192
    x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                        device="cuda")
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    before = gdn.launches["igdn" if inverse else "gdn"]
    got = gdn(x, gamma, beta, inverse)
    want = gdn_plain(x, gamma, beta, inverse)
    rel = ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()
    assert rel <= 1e-5
    assert gdn.launches["igdn" if inverse else "gdn"] == before + 1


def _data(rows, c, seed=2):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.normal(0, 1, (rows, c)).astype(np.float32),
                        device="cuda")
    gamma = torch.as_tensor((0.1 * np.eye(c) + 0.01 * rng.random((c, c)))
                            .astype(np.float32), device="cuda")
    beta = torch.as_tensor((1.0 + 0.1 * rng.random(c)).astype(np.float32),
                           device="cuda")
    return x, gamma, beta


def _max_rel(got, want):
    return ((got - want).abs() / want.abs().clamp_min(1e-30)).max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 31, 33, 98_309])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_matches_plain_ragged_rows(rows, inverse):
    _need_cuda()
    x, gamma, beta = _data(rows, 192, seed=3)
    assert _max_rel(gdn(x, gamma, beta, inverse),
                    gdn_plain(x, gamma, beta, inverse)) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_matches_plain_every_width(inverse):
    _need_cuda()
    for c in range(1, MAX_CHANNELS + 1):
        x, gamma, beta = _data(333, c, seed=c)
        rel = _max_rel(gdn(x, gamma, beta, inverse),
                       gdn_plain(x, gamma, beta, inverse))
        assert rel <= 1e-5, f"C={c}: {rel:.3e}"


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_rows_do_not_depend_on_their_position(inverse):
    """The same 21 rows alone and at offsets 0, 5 and 37 inside 98,304 rows
    give the same bits (the encoder and decoder batch rows differently)."""
    _need_cuda()
    x, gamma, beta = _data(98_304, 192, seed=4)
    rows = x[:21].clone()
    alone = gdn(rows, gamma, beta, inverse)
    for off in (0, 5, 37):
        big = x.clone()
        big[off:off + 21] = rows
        assert torch.equal(gdn(big, gamma, beta, inverse)[off:off + 21],
                           alone), f"offset {off}"


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_cuda()
    c = MAX_CHANNELS + 1
    x = torch.zeros(4, c, device="cuda")
    with pytest.raises(ValueError):
        gdn(x, torch.zeros(c, c, device="cuda"),
            torch.ones(c, device="cuda"))
    with pytest.raises(ValueError):
        gdn(x[:, :8].half(), torch.zeros(8, 8, device="cuda"),
            torch.ones(8, device="cuda"))
    # float32 or bf16 x only, contiguous; gamma and beta float32
    x, gamma, beta = _data(8, 16)
    for bad in (x.double(), x.t(), x.bfloat16().t()):
        with pytest.raises(ValueError):
            gdn(bad, gamma, beta)
    with pytest.raises(ValueError):
        gdn(x.bfloat16(), gamma.bfloat16(), beta)


@pytest.mark.cuda
def test_tiny_codec_roundtrip_through_the_kernel():
    _need_cuda()
    model = et.VarianceMaskingPIC(n=32, m=32, division=(16, 32), dim_chunk=8,
                   param_net_widths=(24, 16)).init_weights(0)
    codec = et.PICCodec(model)
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    st, cache = {}, {}
    launches = dict(gdn.launches)
    bs, _ = et.progressive_encode(codec, x, state=st)
    assert gdn.launches["gdn"] == launches["gdn"] + 6
    for lvl in range(len(bs["q_list"]) + 1):
        out = et.progressive_decode(codec, bs, lvl, cache)
        if lvl == 0:
            _, y_e = codec.synth_base(st["base_slices"])
        else:
            keep = st["sid"].to(torch.int32) < lvl
            _, y_e = codec.prog_reconstruct(st["psym"] * keep, st["mu_s"],
                                            st["msups"], st["base_slices"])
        assert torch.equal(out["y_hat"], y_e)


@pytest.mark.cuda
def test_tiny_rem_codec_through_the_kernel():
    """REMs on: levels 0..15 one by one and all at once (the top level, the
    base and the 15 folded levels: 9 IGDN launches)."""
    _need_cuda()
    model = et.get_model("rem", n=32, m=32, division=(16, 32), dim_chunk=8,
                         param_net_widths=(24, 16),
                         check_levels=(0.25, 0.75),
                         rem_dimension="middle").init_weights(0)
    codec = et.PICCodec(model)
    x = np.random.default_rng(0).random((1, 64, 64, 3), dtype=np.float32)
    st, cache = {}, {}
    bs, _ = et.progressive_encode(codec, x, rems=True, state=st)
    levels = [et.progressive_decode(codec, bs, lvl, cache, True,
                                    st["auto_ckpts"])["x_hat"]
              for lvl in range(len(bs["q_list"]) + 1)]
    before = gdn.launches["igdn"]
    out = et.progressive_decode_all(codec, bs, True, st["auto_ckpts"])
    assert gdn.launches["igdn"] == before + 9
    # float32: the folded batch may run other cuDNN algorithms
    assert (out["x_hat"] - torch.stack(levels)).abs().max().item() <= 1e-4


# every row count the main path launches GDN or IGDN at (C = 192), and the
# folded rows of progressive_decode_all
MAIN_ROWS = [5_898_240, 1_474_560, 393_216, 368_640, 262_144, 196_608,
             98_304, 92_160, 65_536, 49_152, 24_576, 16_384, 12_288, 6_144,
             4_096, 21]


def _randn(rows, c, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn((rows, c), device="cuda", generator=g)


def _check_bf16(x, gamma, beta, inverse, label=""):
    """bf16 x through the kernel: bitwise the float32 variant's output on
    the widened x, rounded to bf16; that one within 1e-5 of gdn_plain."""
    xb = x.bfloat16()
    y32 = gdn(xb.float(), gamma, beta, inverse)
    rel = _max_rel(y32, gdn_plain(xb.float(), gamma, beta, inverse))
    assert rel <= 1e-5, f"{label}: {rel:.3e}"
    yb = gdn(xb, gamma, beta, inverse)
    assert yb.dtype is torch.bfloat16
    assert torch.equal(yb, y32.bfloat16()), label


@pytest.mark.cuda
@pytest.mark.parametrize("rows", MAIN_ROWS)
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_bf16_is_the_float32_rounded(rows, inverse):
    _need_cuda()
    _, gamma, beta = _data(1, 192, seed=5)
    kind = "igdn" if inverse else "gdn"
    before = gdn.launches[kind]
    _check_bf16(_randn(rows, 192, rows), gamma, beta, inverse, f"R={rows}")
    assert gdn.launches[kind] == before + 2
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_bf16_every_width_and_ragged_rows(inverse):
    _need_cuda()
    for c in range(1, MAX_CHANNELS + 1):
        x, gamma, beta = _data(333, c, seed=c)
        _check_bf16(x, gamma, beta, inverse, f"C={c}")
    for rows in (1, 31, 33, 98_309):
        x, gamma, beta = _data(rows, 192, seed=3)
        _check_bf16(x, gamma, beta, inverse, f"R={rows}")


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_bf16_rows_do_not_depend_on_their_position(inverse):
    _need_cuda()
    x, gamma, beta = _data(98_304, 192, seed=4)
    x = x.bfloat16()
    rows = x[:21].clone()
    alone = gdn(rows, gamma, beta, inverse)
    for off in (0, 5, 37):
        big = x.clone()
        big[off:off + 21] = rows
        assert torch.equal(gdn(big, gamma, beta, inverse)[off:off + 21],
                           alone), f"offset {off}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_kernel_side_streams_and_threads_bitwise(dtype, inverse):
    """As the sweep pipeline launches it: on a side stream, and from two
    threads on two streams at once, bitwise the main stream's result."""
    import threading

    _need_cuda()
    x, gamma, beta = _data(393_216, 192, seed=6)
    x = x.to(dtype)
    want = gdn(x, gamma, beta, inverse)
    torch.cuda.synchronize()
    outs = [[] for _ in range(3)]

    def launch(k, reps):
        s = torch.cuda.Stream()
        with torch.cuda.stream(s):
            outs[k] = [gdn(x, gamma, beta, inverse) for _ in range(reps)]
        s.synchronize()

    launch(0, 1)
    threads = [threading.Thread(target=launch, args=(k, 4)) for k in (1, 2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(len(o) for o in outs) == 9
    assert all(torch.equal(y, want) for o in outs for y in o)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [24_576, 98_304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_many_launches_bitwise(rows, dtype):
    """200 launches of each kind give the same bits: a box slot freed or
    filled out of turn shows as a rare wrong row or column block."""
    _need_cuda()
    x, gamma, beta = _data(rows, 192, seed=12)
    x = x.to(dtype)
    for inverse in (False, True):
        want = gdn(x, gamma, beta, inverse)
        outs = [gdn(x, gamma, beta, inverse) for _ in range(200)]
        assert all(torch.equal(y, want) for y in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_kernel_unaligned_x_takes_the_load_path(dtype):
    """x one element past an aligned address (a contiguous view): no TMA
    for it, the kernel's own load path, the same bits."""
    _need_cuda()
    x, gamma, beta = _data(2_000, 192, seed=8)
    flat = torch.empty(2_000 * 192 + 1, device="cuda", dtype=dtype)
    shifted = flat[1:].view(2_000, 192)
    shifted.copy_(x.to(dtype))
    for inverse in (False, True):
        assert torch.equal(gdn(shifted, gamma, beta, inverse),
                           gdn(x.to(dtype), gamma, beta, inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_module_bf16_has_no_casts(inverse):
    """The bf16 GDN module call: bitwise the cast, float32 call, cast it
    replaces, and as many kernel launches as a float32 call."""
    from torch.profiler import ProfilerActivity, profile

    _need_cuda()
    mod = GDN(192, inverse).cuda()
    with torch.no_grad():
        mod.gamma.add_(0.01)
        x = _randn(8 * 16 * 24, 192, 9).view(8, 16, 24, 192)
        xb = x.bfloat16()
        want = mod(xb.float()).bfloat16()
        got = mod(xb)
        assert got.dtype is torch.bfloat16 and torch.equal(got, want)
        kernels = []
        for inp in (x, xb):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                mod(inp)
                torch.cuda.synchronize()
            kernels.append(sum(e.count for e in prof.key_averages()
                               if e.device_type.name == "CUDA"))
    assert kernels[0] == kernels[1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_bf16_gradients_bitwise_the_float32_path(inverse):
    """Training through bf16 x: dx, dgamma, dbeta bitwise those of the
    float32 path on the same values (the backward widens x and g)."""
    _need_cuda()
    x, gamma, beta = _data(4_096, 192, seed=10)
    xb = x.bfloat16()
    w = _randn(4_096, 192, 11)
    grads = []
    for path in ("bf16", "float32"):
        xi = xb.clone().requires_grad_(True)
        gi = gamma.clone().requires_grad_(True)
        bi = beta.clone().requires_grad_(True)
        if path == "bf16":
            y = gdn_differentiable(xi, gi, bi, inverse)
        else:
            y = gdn_differentiable(xi.float(), gi, bi, inverse).bfloat16()
        (y.float() * w).sum().backward()
        grads.append((xi.grad, gi.grad, bi.grad))
    assert grads[0][0].dtype is torch.bfloat16
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def _bwd_rel(got, want):
    got, want = got.float(), want.float()
    return ((got - want).abs().max() / want.abs().max()).item()


DTYPES = [torch.float32, torch.bfloat16]
DTYPE_IDS = ["f32", "bf16"]


def _check_backward(rows, c, inverse, seed, dtype=torch.float32):
    """The backward kernel's (dx, u) within 1e-5 of the plain closed form,
    gdn_backward's dx within 1e-5 and dgamma / dbeta within 1e-4 of
    autograd through gdn_plain and of gdn_backward_plain (float32: sums over
    every row in another order), one launch of each kernel per call. bf16:
    x and g rounded, held so in float32, and the bf16 variant bitwise the
    float32 one on the widened values (dx rounded once)."""
    x, gamma, beta = _data(rows, c, seed=seed)
    g = torch.randn(x.shape, generator=torch.Generator(device="cuda")
                    .manual_seed(seed), device="cuda")
    if dtype is torch.bfloat16:
        xb, gb = x.bfloat16(), g.bfloat16()
        x, g = xb.float(), gb.float()
    kind = "igdn" if inverse else "gdn"
    before = (gdn_backward.launches[kind], gdn_backward_reduce.launches[kind])
    dx, u = gdn_backward_rows(x, gamma, beta, g, inverse)
    assert gdn_backward.launches[kind] == before[0] + 1
    dx_p, u_p = gdn_backward_rows_plain(x, gamma, beta, g, inverse)
    assert _bwd_rel(dx, dx_p) <= 1e-5 and _bwd_rel(u, u_p) <= 1e-5
    xr, gr, br = (t.clone().requires_grad_() for t in (x, gamma, beta))
    want = torch.autograd.grad(gdn_plain(xr, gr, br, inverse), (xr, gr, br),
                               g)
    got = gdn_backward(x, gamma, beta, g, inverse)
    assert gdn_backward.launches[kind] == before[0] + 2
    assert gdn_backward_reduce.launches[kind] == before[1] + 1
    plain = gdn_backward_plain(x, gamma, beta, g, inverse)
    assert _bwd_rel(got[0], want[0]) <= 1e-5
    for k in (1, 2):
        assert _bwd_rel(got[k], want[k]) <= 1e-4
        assert _bwd_rel(got[k], plain[k]) <= 1e-4
    if dtype is torch.bfloat16:
        rows_b = gdn_backward_rows(xb, gamma, beta, gb, inverse)
        assert rows_b[0].dtype is torch.bfloat16
        assert torch.equal(rows_b[0], dx.bfloat16())
        assert torch.equal(rows_b[1], u)
        got_b = gdn_backward(xb, gamma, beta, gb, inverse)
        assert torch.equal(got_b[0], got[0].bfloat16())
        assert torch.equal(got_b[1], got[1]) and torch.equal(got_b[2],
                                                             got[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("rows", [1, 21, 31, 33, 16_384, 98_309])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_kernel_matches_plain_and_autograd(rows, inverse, dtype):
    _need_cuda()
    _check_backward(rows, 192, inverse, seed=5, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_kernel_every_width(inverse, dtype):
    _need_cuda()
    for c in range(1, MAX_CHANNELS + 1):
        _check_backward(333, c, inverse, seed=c, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_kernel_side_stream_bitwise(inverse, dtype):
    _need_cuda()
    x, gamma, beta = _data(65_536, 192, seed=6)
    g = torch.randn_like(x)
    x, g = x.to(dtype), g.to(dtype)
    want = (gdn_backward_rows(x, gamma, beta, g, inverse)
            + gdn_backward(x, gamma, beta, g, inverse))
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        got = (gdn_backward_rows(x, gamma, beta, g, inverse)
               + gdn_backward(x, gamma, beta, g, inverse))
    s.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def _ring_rows(edge):
    """Row counts at the edges of the backward kernel's persistent grid
    (clusters of 4 blocks walking 64-row tiles, as many clusters as fit on
    the card): one tile fewer than, as many as and one more than 2 tiles
    per cluster; fewer tiles than clusters; and the edges of the dgamma
    sums' flush to the cluster's partial every 8 tiles (8 tiles a cluster,
    and one row more). At -1 and +1 some clusters walk one tile more than
    others."""
    ones = torch.ones(64, 8, device="cuda")
    gdn_backward(ones, torch.eye(8, device="cuda"), ones[0], ones)  # set up
    clusters = backward_clusters(torch.float32)
    assert clusters > 0
    r = 64 * clusters  # rows of one tile per cluster
    return {"k-1": 2 * r - 64, "k": 2 * r, "k+1": 2 * r + 1,
            "below": r - 64 * (clusters // 2) - 5, "flush": 8 * r,
            "flush+1": 8 * r + 1}[edge]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("edge", ["k-1", "k", "k+1", "below", "flush",
                                  "flush+1"])
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_kernel_ring_edges(edge, inverse, dtype):
    _need_cuda()
    _check_backward(_ring_rows(edge), 192, inverse, seed=7, dtype=dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_kernel_two_launches_bitwise(inverse, dtype):
    """Launches of one input give the same bits: the u quarters' exchange
    between a cluster's blocks and the box ring, freed or filled out of
    turn, would show as a rare wrong row or column block; dgamma and dbeta
    are summed in a fixed order."""
    _need_cuda()
    x, gamma, beta = _data(_ring_rows("k+1"), 192, seed=8)
    g = torch.randn_like(x)
    x, g = x.to(dtype), g.to(dtype)
    first = (gdn_backward_rows(x, gamma, beta, g, inverse)
             + gdn_backward(x, gamma, beta, g, inverse))
    for _ in range(50):
        again = (gdn_backward_rows(x, gamma, beta, g, inverse)
                 + gdn_backward(x, gamma, beta, g, inverse))
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_backward_unaligned_x_takes_the_load_path(dtype):
    """x one element past an aligned address: the backward's own load path
    for x, the same bits."""
    _need_cuda()
    x, gamma, beta = _data(2_000, 192, seed=9)
    g = torch.randn_like(x).to(dtype)
    flat = torch.empty(2_000 * 192 + 1, device="cuda", dtype=dtype)
    shifted = flat[1:].view(2_000, 192)
    shifted.copy_(x.to(dtype))
    for inverse in (False, True):
        got = gdn_backward(shifted, gamma, beta, g, inverse)
        want = gdn_backward(x.to(dtype), gamma, beta, g, inverse)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["gdn", "igdn"])
def test_backward_bf16_has_no_casts(inverse):
    """The bf16 backward through the autograd function launches the
    backward kernel and its reduction once each (their launch counts) and
    no other kernel: every kernel the profiler records is one of the two
    (it may drop a record, never add one), as for a float32 backward."""
    from torch.profiler import ProfilerActivity, profile

    _need_cuda()
    x, gamma, beta = _data(4_096, 192, seed=10)
    g = _randn(4_096, 192, 11)
    kind = "igdn" if inverse else "gdn"
    for xt, gt in ((x, g), (x.bfloat16(), g.bfloat16())):
        xr, gr, br = (t.clone().requires_grad_() for t in (xt, gamma, beta))
        y = gdn_differentiable(xr, gr, br, inverse)
        torch.cuda.synchronize()
        before = (gdn_backward.launches[kind],
                  gdn_backward_reduce.launches[kind])
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            grads = torch.autograd.grad(y, (xr, gr, br), gt)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type.name == "CUDA"]
        assert names and all("gdn_bwd" in n for n in names), names
        assert (gdn_backward.launches[kind],
                gdn_backward_reduce.launches[kind]) == (before[0] + 1,
                                                        before[1] + 1)
        assert grads[0].dtype is xt.dtype


@pytest.mark.cuda
def test_backward_kernel_rejects_what_it_cannot_take():
    _need_cuda()
    x, gamma, beta = _data(8, 16)
    with pytest.raises(ValueError):
        gdn_backward_rows(x, gamma, beta, torch.zeros(8, 15, device="cuda"))
    with pytest.raises(ValueError):
        gdn_backward_rows(x, gamma, beta, x.t())


@pytest.mark.cuda
def test_tiny_training_step_through_the_kernels():
    """A tiny pic model's first_train step on the card: forward and
    backward GDN / IGDN launches counted (6 + 6 each), loss and gradients
    within 1e-3 of the same step on the CPU (float32; cuDNN's convolution
    algorithms differ from the CPU's)."""
    _need_cuda()
    from epic_tpu_torch.device import resolve_device
    from epic_tpu_torch.training.stages import make_stage
    from epic_tpu_torch.training.state import TrainState
    from epic_tpu_torch.training.step import make_train_step

    resolve_device("cuda")
    x = np.random.default_rng(0).random((2, 64, 64, 3), dtype=np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        model = et.get_model("pic", n=32, m=32, division=(16, 32),
                             dim_chunk=8, param_net_widths=(24, 16)
                             ).init_weights(0).to(device)
        state = TrainState(model, "first_train")
        step = make_train_step(model, make_stage("first_train"),
                               training=False)
        fwd, bwd = dict(gdn.launches), dict(gdn_backward.launches)
        metrics = step.loss(torch.as_tensor(x, device=device))
        info = step.apply(state, metrics["loss"])
        if device == "cuda":
            torch.cuda.synchronize()
            assert {k: gdn.launches[k] - fwd[k] for k in fwd} == \
                {"gdn": 6, "igdn": 6}
            assert {k: gdn_backward.launches[k] - bwd[k] for k in bwd} == \
                {"gdn": 6, "igdn": 6}
        out[device] = (float(metrics["loss"].detach()),
                       [g.detach().cpu() for g in info["grads"]])
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-3)
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        assert (a - b).abs().max() <= 1e-3 * b.abs().max() + 1e-9
