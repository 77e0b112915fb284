"""Entropy models and host rANS of the PyTorch port against the JAX package.

Likelihoods are held to a tolerance (float32 erfc of two libraries:
rtol 1e-5, atol 1e-7); CDF-table indexes, the default quantized CDF tables
(shipped as data) and tables quantized from the same pmf must be equal,
and rANS streams byte-identical to the JAX package's ``RansCoder`` (the
cases of tests/test_rans.py), with each side decoding the other's bytes.

The z coder's tables are built from the entropy bottleneck's weights; the
port evaluates the pmf grid as the JAX package's CPU program rounds it
(``entropy/xla_f32.py``), so they are held equal for any weights: every
committed checkpoint under ``artifacts/``, the constructor's weights and a
seeded draw with nonzero factors; and ``tests/fixtures/z_tables_jax.npz``
(written by ``tests/gen_torch_z_tables.py``, checked by chip_smoke.py on a
host without JAX) is held equal to the JAX package's tables.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from epic_tpu.entropy import bottleneck as jbottleneck
from epic_tpu.entropy import coder as jcoder
from epic_tpu.entropy import gaussian as jgaussian
from epic_tpu.entropy.ops import lower_bound as j_lower_bound
from epic_tpu.entropy.ops import nn_param_apply as j_nn_param_apply
from epic_tpu_torch.convert import _as_f32, from_jax_params
from epic_tpu_torch.entropy import coder, gaussian
from epic_tpu_torch.entropy.bottleneck import EntropyBottleneck
from epic_tpu_torch.entropy.ops import lower_bound, nn_param_apply
from gen_torch_cdf_tables import reference_arrays
import gen_torch_z_tables


def _gauss_pmf(scale, length):
    xs = np.arange(length) - length // 2
    p = np.exp(-0.5 * (xs / scale) ** 2)
    return p / p.sum()


def _tables():
    tables, lengths, offsets = [], [], []
    for scale in [0.11, 0.5, 1.0, 3.0, 8.0, 20.0]:
        L = int(np.ceil(scale * 12)) * 2 + 1
        full = np.concatenate(
            [_gauss_pmf(scale, L) * (1 - 1e-9), [1e-9]]).astype(np.float32)
        tables.append(coder.pmf_to_quantized_cdf(full, 16))
        lengths.append(len(tables[-1]))
        offsets.append(-(L // 2))
    cdfs = np.zeros((len(tables), max(lengths)), dtype=np.int32)
    for i, t in enumerate(tables):
        cdfs[i, :len(t)] = t
    return cdfs, lengths, offsets


@pytest.fixture(scope="module")
def coders():
    t = _tables()
    return coder.RansCoder(*t), jcoder.RansCoder(*t)


def test_lower_bound_value_and_gradient():
    x = np.array([-2.0, 0.05, 0.2, 3.0], np.float32)
    g = np.array([1.0, -1.0, 1.0, -1.0], np.float32)
    xt = torch.tensor(x, requires_grad=True)
    (lower_bound(xt, 0.11) * torch.tensor(g)).sum().backward()
    val, vjp = jax.vjp(lambda a: j_lower_bound(a, 0.11), jnp.asarray(x))
    np.testing.assert_array_equal(xt.detach().clamp(min=0.11).numpy(),
                                  np.asarray(val))
    np.testing.assert_array_equal(xt.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))
    reparam = torch.tensor([0.0, 1e-4, 0.5, 2.0])
    np.testing.assert_array_equal(
        nn_param_apply(reparam, 1e-6).numpy(),
        np.asarray(j_nn_param_apply(jnp.asarray(reparam.numpy()), 1e-6)))


def test_gaussian_likelihood():
    rng = np.random.default_rng(0)
    x = rng.normal(0, 4, (2, 6, 5, 8)).astype(np.float32)
    s = np.abs(rng.normal(0, 3, x.shape)).astype(np.float32)
    mu = rng.normal(0, 1, x.shape).astype(np.float32)
    got = gaussian.gaussian_likelihood(torch.from_numpy(x),
                                       torch.from_numpy(s),
                                       torch.from_numpy(mu)).numpy()
    want = np.asarray(jgaussian.gaussian_likelihood(
        jnp.asarray(x), jnp.asarray(s), jnp.asarray(mu)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


def test_build_indexes_equal():
    rng = np.random.default_rng(1)
    table = gaussian.get_scale_table()
    np.testing.assert_array_equal(table, jgaussian.get_scale_table())
    s = np.concatenate([np.exp(rng.uniform(-4, 7, 5000)), table,
                        [0.0, 0.05, 0.11, 256.0, 1e4]]).astype(np.float32)
    got = gaussian.build_indexes(torch.from_numpy(s), table).numpy()
    want = np.asarray(jgaussian.build_indexes(jnp.asarray(s), table))
    np.testing.assert_array_equal(got, want)


def test_gaussian_cdf_tables_equal():
    table = gaussian.get_scale_table()
    ours = gaussian.build_gaussian_cdf_tables(table)
    ref = jgaussian.build_gaussian_cdf_tables(table)
    np.testing.assert_array_equal(ours.cdf_length, ref.cdf_length)
    np.testing.assert_array_equal(ours.offset, ref.offset)
    # the same pmf quantizes to the same table
    center = -ref.offset
    pmf, tail = jgaussian._gaussian_pmf_device(
        jnp.asarray(table), jnp.asarray(center), int(2 * center.max() + 1))
    same = gaussian.quantize_pmf_rows(np.asarray(pmf),
                                      np.asarray(tail)[:, 0], 2 * center + 1)
    np.testing.assert_array_equal(same, ref.quantized_cdf)
    # the default tables are the stream format's: equal entry for entry
    np.testing.assert_array_equal(ours.quantized_cdf, ref.quantized_cdf)


def test_shipped_cdf_tables_equal_the_generator():
    want = reference_arrays()
    with np.load(gaussian._TABLES_FILE) as f:
        assert set(f.files) == set(want)
        for k, v in want.items():
            assert f[k].dtype == v.dtype, k
            np.testing.assert_array_equal(f[k], v, err_msg=k)


def test_gaussian_cdf_tables_other_scales():
    # tables outside the stream format are computed with torch's erfc:
    # same lengths and offsets, entries within one count of XLA's
    table = gaussian.get_scale_table()[:40:3] * np.float32(1.5)
    ours = gaussian.build_gaussian_cdf_tables(table)
    ref = jgaussian.build_gaussian_cdf_tables(table)
    np.testing.assert_array_equal(ours.cdf_length, ref.cdf_length)
    np.testing.assert_array_equal(ours.offset, ref.offset)
    assert np.abs(ours.quantized_cdf - ref.quantized_cdf).max() <= 1


def test_bottleneck_likelihood_and_tables():
    c = 6
    rng = np.random.default_rng(2)
    eb_j = jbottleneck.EntropyBottleneck(c)
    z = rng.normal(0, 3, (1, 3, 4, c)).astype(np.float32)
    shapes = jax.eval_shape(lambda: eb_j.init(
        jax.random.key(0), jnp.asarray(z), False))["params"]
    params = {k: (rng.normal(0, 0.3, v.shape)
                  + (np.array([-8.0, 0.3, 9.0]) if k == "quantiles" else 0))
              .astype(np.float32) for k, v in shapes.items()}
    eb = EntropyBottleneck(c)
    eb.load_state_dict(from_jax_params(params, eb))
    out_j, lik_j = eb_j.apply({"params": params}, jnp.asarray(z), False)
    out, lik = eb(torch.from_numpy(z))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(out_j))
    np.testing.assert_allclose(lik.detach().numpy(), np.asarray(lik_j),
                               rtol=1e-5, atol=1e-7)
    tables, med = eb.cdf_tables()
    ref, med_j = jbottleneck.build_bottleneck_cdf_tables(
        eb_j, {"params": params})
    np.testing.assert_array_equal(med, med_j)
    for f in ("quantized_cdf", "cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(tables, f), getattr(ref, f))


ARTIFACTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "artifacts")
CHECKPOINTS = sorted(d for d in os.listdir(ARTIFACTS)
                     if os.path.isfile(os.path.join(ARTIFACTS, d, "last.npz")))


def _z_tables_differ(params) -> int:
    """The entropy bottleneck's arrays -> the number of quantized CDF
    entries in which the two packages' z tables differ (lengths, offsets
    and medians asserted equal)."""
    c = params["quantiles"].shape[0]
    eb = EntropyBottleneck(c)
    eb.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    tables, med = eb.cdf_tables()
    ref, med_j = jbottleneck.build_bottleneck_cdf_tables(
        jbottleneck.EntropyBottleneck(c),
        {"params": {k: jnp.asarray(v) for k, v in params.items()}})
    np.testing.assert_array_equal(med, med_j)
    for f in ("cdf_length", "offset"):
        np.testing.assert_array_equal(getattr(tables, f), getattr(ref, f))
    return int((tables.quantized_cdf != ref.quantized_cdf).sum())


@pytest.mark.parametrize("ckpt", CHECKPOINTS)
def test_committed_checkpoint_z_tables_equal(ckpt):
    """Only the bottleneck's arrays are read from the checkpoint."""
    with np.load(os.path.join(ARTIFACTS, ckpt, "last.npz")) as z:
        params = {k.split("/", 1)[1]: _as_f32(z[k]) for k in z.files
                  if k.startswith("entropy_bottleneck/")}
    assert _z_tables_differ(params) == 0


@pytest.mark.parametrize("channels", [32, 192])
def test_constructor_z_tables_equal(channels):
    eb = EntropyBottleneck(channels)
    assert _z_tables_differ({k: v.detach().numpy()
                             for k, v in eb.state_dict().items()}) == 0


def test_seeded_z_tables_equal():
    """Every array drawn with numpy at 192 channels, factors nonzero (so
    tanh is exercised; the constructor's factors are zero)."""
    assert _z_tables_differ(gen_torch_z_tables.seeded_arrays()) == 0


def test_z_table_fixture_is_jax():
    """The fixture chip_smoke.py checks the port against (on a host with no
    JAX) holds the JAX package's tables for the arrays it stores."""
    path = gen_torch_z_tables.OUT
    with np.load(path) as z:
        for case in ("constructor", "seeded"):
            arrays = {k.rsplit("/", 1)[1]: z[k] for k in z.files
                      if k.startswith(f"{case}/arrays/")}
            want = gen_torch_z_tables.jax_tables(arrays)
            for k, v in want.items():
                np.testing.assert_array_equal(z[f"{case}/tables/{k}"], v)


def _sym_idx(seed, n, spread=1.0):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, 6, n).astype(np.int32)
    scales = np.array([0.11, 0.5, 1.0, 3.0, 8.0, 20.0])[idx]
    return np.round(rng.normal(0, scales * spread)).astype(np.int32), idx


@pytest.mark.parametrize("case", ["in_range", "escape", "single", "zeros"])
def test_rans_single_message_bytes_equal(coders, case):
    ours, ref = coders
    sym, idx = {
        "in_range": _sym_idx(0, 20000),
        "escape": (np.array([10**6, -(10**6), 2**30, -(2**30), 0, -1, 999,
                             -999], np.int32), np.zeros(8, np.int32)),
        "single": (np.array([3], np.int32), np.array([2], np.int32)),
        "zeros": (np.zeros(50000, np.int32), np.zeros(50000, np.int32)),
    }[case]
    blob = ours.encode_with_indexes(sym, idx)
    assert blob == ref.encode_with_indexes(sym, idx)
    np.testing.assert_array_equal(ours.decode_with_indexes(blob, idx), sym)
    np.testing.assert_array_equal(ref.decode_with_indexes(blob, idx), sym)


def test_rans_batch_and_segments_bytes_equal(coders):
    ours, ref = coders
    sym, idx = _sym_idx(3, 9000, 2.0)
    lengths = [2000, 3000, 4000]
    blobs = ours.encode_batch(sym, idx, lengths)
    assert blobs == ref.encode_batch(sym, idx, lengths)
    np.testing.assert_array_equal(ref.decode_batch(blobs, idx, lengths), sym)
    np.testing.assert_array_equal(ours.decode_batch(blobs, idx, lengths), sym)
    seg_ends = np.array([[500, 1200, 2000], [1000, 2000, 3000],
                         [0, 4000, 4000]], np.int64)
    got = ours.encode_seg_batch(sym, idx, lengths, seg_ends)
    want = ref.encode_seg_batch(sym, idx, lengths, seg_ends)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("sym_dtype", [np.int8, np.int16, np.int32])
def test_rans_shell_streams_bytes_equal(coders, sym_dtype):
    ours, ref = coders
    rng = np.random.default_rng(12)
    m, nb, np_, nq = 3, 700, 4000, 5
    base_idx = rng.integers(0, 6, (m, nb)).astype(np.uint8)
    prog_idx = rng.integers(0, 6, (m, np_)).astype(np.uint8)
    base_sym = rng.integers(-90, 90, (m, nb)).astype(sym_dtype)
    prog_sym = rng.integers(-90, 90, (m, np_)).astype(sym_dtype)
    sid = rng.integers(0, nq + 1, (m, np_)).astype(np.int8)
    blobs, prefix = ours.encode_shell_batch(base_sym, base_idx, prog_sym,
                                            prog_idx, sid, nq)
    want_blobs, want_prefix = ref.encode_shell_batch(
        base_sym, base_idx, prog_sym, prog_idx, sid, nq)
    assert blobs == want_blobs
    np.testing.assert_array_equal(prefix, want_prefix)
    # the port decodes the reference's streams shell by shell
    streams = [ours.stream_decoder(b) for b in want_blobs]
    got_base = ours.decode_streams(streams, base_idx, [nb] * m)
    np.testing.assert_array_equal(got_base.reshape(m, nb), base_sym)
    canvas = np.zeros((m, np_), np.int16)
    for j0, j1 in ((0, 2), (2, nq)):
        assert ours.decode_shell_streams(streams, prog_idx, sid, j0, j1, nq,
                                         canvas) is None
        np.testing.assert_array_equal(canvas, np.where(sid < j1, prog_sym, 0))
    for s in streams:
        s.close()


def test_rans_shell_overflow_reported(coders):
    ours, _ = coders
    rng = np.random.default_rng(15)
    m, nb, np_, nq = 1, 50, 400, 3
    base_idx = rng.integers(0, 6, (m, nb)).astype(np.uint8)
    prog_idx = rng.integers(0, 6, (m, np_)).astype(np.uint8)
    base_sym = rng.integers(-100, 100, (m, nb)).astype(np.int32)
    prog_sym = rng.integers(-100, 100, (m, np_)).astype(np.int32)
    sid = rng.integers(0, nq + 1, (m, np_)).astype(np.int8)
    hot = np.where(sid[0] < nq)[0][:3]
    prog_sym[0, hot] = np.array([40000, -50000, 32768])
    blobs, _ = ours.encode_shell_batch(base_sym, base_idx, prog_sym,
                                       prog_idx, sid, nq)
    streams = [ours.stream_decoder(b) for b in blobs]
    ours.decode_streams(streams, base_idx, [nb] * m)
    canvas = np.zeros((m, np_), np.int16)
    pos, val = ours.decode_shell_streams(streams, prog_idx, sid, 0, nq, nq,
                                         canvas)
    np.testing.assert_array_equal(np.sort(pos), np.sort(hot))
    assert sorted(val.tolist()) == [-50000, 32768, 40000]
    for s in streams:
        s.close()


def test_pmf_quantizer_equal():
    pmfs = np.zeros((3, 20), np.float32)
    lengths = np.array([5, 11, 20], np.int32)
    for i, L in enumerate(lengths):
        pmfs[i, :L] = _gauss_pmf(2.0, L)
    np.testing.assert_array_equal(
        coder.pmf_to_quantized_cdf_batch(pmfs, lengths),
        jcoder.pmf_to_quantized_cdf_batch(pmfs, lengths))
    tiny = np.array([0.999, 1e-12, 1e-12, 1e-12], np.float32)
    np.testing.assert_array_equal(coder.pmf_to_quantized_cdf(tiny),
                                  jcoder.pmf_to_quantized_cdf(tiny))
