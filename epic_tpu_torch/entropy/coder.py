"""Host rANS coder over numpy buffers (ctypes binding of ``native/``).

Same surface and the same bytes as the JAX package's coder: symbols and
CDF indexes arrive as packed integer arrays (one device-to-host copy per
stage), and batched calls fan out over host threads inside one C call.
A coder is stateless per call apart from ``stats``, which is updated under
a lock, so one coder serves concurrent sweeps (``codec/pipeline.py``);
the C calls release the GIL.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Sequence

import numpy as np

from ..native.build import load_library

_DEFAULT_PRECISION = 16


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _ascontig(a, dtype) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a), dtype=dtype)


def _offsets(lengths: np.ndarray) -> np.ndarray:
    offs = np.zeros(lengths.size, dtype=np.int64)
    np.cumsum(lengths[:-1], out=offs[1:])
    return offs


def pmf_to_quantized_cdf(pmf, precision: int = _DEFAULT_PRECISION) -> np.ndarray:
    """Quantize one float pmf (1-D) to an integer CDF of length len(pmf)+1."""
    lib = load_library()
    pmf = _ascontig(pmf, np.float32)
    out = np.zeros(pmf.shape[0] + 1, dtype=np.uint32)
    rc = lib.epic_pmf_to_quantized_cdf(
        _ptr(pmf, ctypes.c_float), pmf.shape[0], precision,
        _ptr(out, ctypes.c_uint32))
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf failed with code {rc}")
    return out.astype(np.int32)


def pmf_to_quantized_cdf_batch(pmf: np.ndarray, pmf_lengths: np.ndarray,
                               precision: int = _DEFAULT_PRECISION,
                               nthreads: int = 8) -> np.ndarray:
    """Quantize a padded [M, Lmax] pmf matrix; row i uses pmf_lengths[i]
    entries. Returns int32 [M, Lmax + 2] (row i holds pmf_lengths[i] + 1
    CDF entries, zero padded)."""
    lib = load_library()
    pmf = _ascontig(pmf, np.float32)
    m, lmax = pmf.shape
    pmf_lengths = _ascontig(pmf_lengths, np.int32)
    out = np.zeros((m, lmax + 2), dtype=np.uint32)
    rc = lib.epic_pmf_to_quantized_cdf_batch(
        _ptr(pmf, ctypes.c_float), lmax, _ptr(pmf_lengths, ctypes.c_int32),
        m, precision, _ptr(out, ctypes.c_uint32), out.shape[1], nthreads)
    if rc != 0:
        raise ValueError(f"pmf_to_quantized_cdf_batch failed with code {rc}")
    return out.astype(np.int32)


class RansCoder:
    """Stateless encoder/decoder over a fixed set of quantized CDF tables
    (``cdfs`` int32 [num_tables, Lmax], per-row ``cdf_lengths`` and symbol
    ``offsets``).

    ``stats`` accumulates the batched calls' wall seconds, calls and
    symbols coded (``encode_s``, ``decode_s``, ``encode_calls``,
    ``decode_calls``, ``encode_syms``, ``decode_syms``); reset it with
    ``stats.update(...)``. ``nthreads`` (default: the core count, at most
    16) is the C threads of each batched call, so W concurrent callers
    start up to W x nthreads threads."""

    def __init__(self, cdfs, cdf_lengths, offsets,
                 precision: int = _DEFAULT_PRECISION,
                 nthreads: int | None = None):
        self.cdfs = _ascontig(cdfs, np.uint32)
        self.cdf_lengths = _ascontig(cdf_lengths, np.int32)
        self.offsets = _ascontig(offsets, np.int32)
        if self.cdfs.ndim != 2:
            raise ValueError("cdfs must be 2-D [num_tables, max_len]")
        self.precision = int(precision)
        self.nthreads = int(nthreads or min(16, os.cpu_count() or 1))
        self._lib = load_library()
        self.stats = {"encode_s": 0.0, "decode_s": 0.0, "encode_calls": 0,
                      "decode_calls": 0, "encode_syms": 0, "decode_syms": 0}
        self._stats_lock = threading.Lock()

    def _stat_add(self, op: str, t_start: float, syms: int) -> None:
        """Add one batched ``op`` ("encode" or "decode") call that started
        at ``t_start`` and coded ``syms`` symbols."""
        dt = time.perf_counter() - t_start
        with self._stats_lock:
            self.stats[f"{op}_s"] += dt
            self.stats[f"{op}_calls"] += 1
            self.stats[f"{op}_syms"] += syms

    def _tables(self):
        return (_ptr(self.cdfs, ctypes.c_uint32), self.cdfs.shape[1],
                _ptr(self.cdf_lengths, ctypes.c_int32),
                _ptr(self.offsets, ctypes.c_int32), self.precision)

    # -- single message ---------------------------------------------------

    def encode_with_indexes(self, symbols, indexes) -> bytes:
        symbols = _ascontig(symbols, np.int32).ravel()
        indexes = _ascontig(indexes, np.int32).ravel()
        if symbols.shape != indexes.shape:
            raise ValueError("symbols and indexes must have the same size")
        cap = max(64, symbols.size * 8 + 64)
        out = np.empty(cap, dtype=np.uint8)
        n = self._lib.epic_rans_encode(
            _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32),
            symbols.size, *self._tables(), _ptr(out, ctypes.c_uint8), cap)
        if n < 0:
            raise RuntimeError("rANS encode output exceeded capacity")
        return out[:n].tobytes()

    def decode_with_indexes(self, data: bytes, indexes) -> np.ndarray:
        indexes = _ascontig(indexes, np.int32).ravel()
        buf = _ascontig(np.frombuffer(data, dtype=np.uint8), np.uint8)
        out = np.empty(indexes.size, dtype=np.int32)
        rc = self._lib.epic_rans_decode(
            _ptr(buf, ctypes.c_uint8), buf.size,
            _ptr(indexes, ctypes.c_int32), indexes.size, *self._tables(),
            _ptr(out, ctypes.c_int32))
        if rc != 0:
            raise RuntimeError(f"rANS decode failed with code {rc}")
        return out

    def stream_decoder(self, data: bytes) -> "StreamDecoder":
        return StreamDecoder(self, data)

    # -- batched ----------------------------------------------------------

    def encode_batch(self, symbols, indexes,
                     msg_lengths: Sequence[int]) -> list[bytes]:
        """Encode M messages packed back to back; msg_lengths[i] is message
        i's symbol count. One C call, messages in parallel."""
        t_start = time.perf_counter()
        symbols = _ascontig(symbols, np.int32).ravel()
        indexes = _ascontig(indexes, np.int32).ravel()
        lengths = _ascontig(msg_lengths, np.int64).ravel()
        m = lengths.size
        offs = _offsets(lengths)
        if offs[-1] + lengths[-1] != symbols.size:
            raise ValueError("msg_lengths do not cover the symbols buffer")
        cap = int(max(64, int(lengths.max()) * 8 + 64))
        out = np.empty(m * cap, dtype=np.uint8)
        out_lengths = np.empty(m, dtype=np.int64)
        rc = self._lib.epic_rans_encode_batch(
            _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32),
            _ptr(offs, ctypes.c_int64), _ptr(lengths, ctypes.c_int64), m,
            *self._tables(), _ptr(out, ctypes.c_uint8), cap,
            _ptr(out_lengths, ctypes.c_int64), self.nthreads)
        if rc != 0:
            raise RuntimeError("batched rANS encode failed")
        res = [out[i * cap:i * cap + int(out_lengths[i])].tobytes()
               for i in range(m)]
        self._stat_add("encode", t_start, symbols.size)
        return res

    def decode_batch(self, datas: Sequence[bytes], indexes,
                     msg_lengths: Sequence[int]) -> np.ndarray:
        """Decode M messages; returns one packed int32 symbol buffer."""
        t_start = time.perf_counter()
        indexes = _ascontig(indexes, np.int32).ravel()
        lengths = _ascontig(msg_lengths, np.int64).ravel()
        m = lengths.size
        if len(datas) != m:
            raise ValueError("need one bytestring per message")
        offs = _offsets(lengths)
        data_lengths = np.array([len(d) for d in datas], dtype=np.int64)
        data_offsets = _offsets(data_lengths)
        blob = _ascontig(np.frombuffer(b"".join(datas), dtype=np.uint8),
                         np.uint8)
        out = np.empty(int(lengths.sum()), dtype=np.int32)
        rc = self._lib.epic_rans_decode_batch(
            _ptr(blob, ctypes.c_uint8), _ptr(data_offsets, ctypes.c_int64),
            _ptr(data_lengths, ctypes.c_int64),
            _ptr(indexes, ctypes.c_int32), _ptr(offs, ctypes.c_int64),
            _ptr(lengths, ctypes.c_int64), m, *self._tables(),
            _ptr(out, ctypes.c_int32), self.nthreads)
        if rc != 0:
            raise RuntimeError(f"batched rANS decode failed with code {rc}")
        self._stat_add("decode", t_start, out.size)
        return out

    def encode_seg_batch(self, symbols, indexes, msg_lengths: Sequence[int],
                         seg_ends) -> tuple[list[bytes], np.ndarray]:
        """Encode M single-stream messages with the same number of
        cumulative segment boundaries ``seg_ends`` [M, nseg]; returns
        (blobs, prefix [M, nseg]), the bytes a decoder needs to decode
        symbols [0, seg_ends[i, k]) of message i."""
        t_start = time.perf_counter()
        symbols = _ascontig(symbols, np.int32).ravel()
        indexes = _ascontig(indexes, np.int32).ravel()
        lengths = _ascontig(msg_lengths, np.int64).ravel()
        seg_ends = _ascontig(seg_ends, np.int64)
        m = lengths.size
        if seg_ends.ndim != 2 or seg_ends.shape[0] != m:
            raise ValueError("seg_ends must be [M, nseg]")
        nseg = seg_ends.shape[1]
        offs = _offsets(lengths)
        if offs[-1] + lengths[-1] != symbols.size:
            raise ValueError("msg_lengths do not cover the symbols buffer")
        cap = int(max(64, int(lengths.max()) * 8 + 64))
        out = np.empty(m * cap, dtype=np.uint8)
        out_lengths = np.empty(m, dtype=np.int64)
        prefix = np.empty((m, nseg), dtype=np.int64)
        rc = self._lib.epic_rans_encode_seg_batch(
            _ptr(symbols, ctypes.c_int32), _ptr(indexes, ctypes.c_int32),
            _ptr(offs, ctypes.c_int64), _ptr(lengths, ctypes.c_int64), m,
            _ptr(seg_ends, ctypes.c_int64), nseg, *self._tables(),
            _ptr(out, ctypes.c_uint8), cap,
            _ptr(out_lengths, ctypes.c_int64), _ptr(prefix, ctypes.c_int64),
            self.nthreads)
        if rc != 0:
            raise RuntimeError("segmented rANS encode failed")
        res = [out[i * cap:i * cap + int(out_lengths[i])].tobytes()
               for i in range(m)]
        self._stat_add("encode", t_start, symbols.size)
        return res, prefix

    def encode_shell_batch(self, base_sym, base_idx, prog_sym, prog_idx,
                           sid, nq: int) -> tuple[list[bytes], np.ndarray]:
        """One stream per image: [base symbols in grid order] ++
        [progressive symbols stably bucketed by shell id], with the exact
        decode-prefix bytes of every level.

        base_sym [M, nb] int8/16/32, base_idx [M, nb] uint8-valued,
        prog_sym [M, np] int8/16/32, prog_idx [M, np], sid [M, np] int8
        (0..nq; nq = never coded). Returns (blobs, prefix [M, nq+1])."""
        t_start = time.perf_counter()

        def _sym(a):
            a = np.ascontiguousarray(a)
            return a if a.dtype in (np.int8, np.int16, np.int32) else \
                a.astype(np.int32)

        base_sym, prog_sym = _sym(base_sym), _sym(prog_sym)
        base_idx = _ascontig(base_idx, np.uint8)
        prog_idx = _ascontig(prog_idx, np.uint8)
        sid = _ascontig(sid, np.int8)
        m, nb = base_sym.shape
        np_ = prog_sym.shape[1]
        if prog_idx.shape != (m, np_) or sid.shape != (m, np_) or \
                base_idx.shape != (m, nb):
            raise ValueError("shell encode: inconsistent shapes")
        cap = int(max(64, (nb + np_) * 8 + 64))
        out = np.empty(m * cap, dtype=np.uint8)
        out_lengths = np.empty(m, dtype=np.int64)
        prefix = np.empty((m, nq + 1), dtype=np.int64)
        rc = self._lib.epic_rans_encode_shell_batch(
            base_sym.ctypes.data, base_sym.dtype.itemsize,
            _ptr(base_idx, ctypes.c_uint8), nb,
            prog_sym.ctypes.data, prog_sym.dtype.itemsize,
            _ptr(prog_idx, ctypes.c_uint8), _ptr(sid, ctypes.c_int8), np_,
            nq, m, *self._tables(), _ptr(out, ctypes.c_uint8), cap,
            _ptr(out_lengths, ctypes.c_int64), _ptr(prefix, ctypes.c_int64),
            self.nthreads)
        if rc != 0:
            raise RuntimeError(f"shell rANS encode failed ({rc})")
        res = [out[i * cap:i * cap + int(out_lengths[i])].tobytes()
               for i in range(m)]
        self._stat_add("encode", t_start,
                       m * nb + int(np.count_nonzero(sid < nq)))
        return res, prefix

    def decode_shell_streams(self, streams: Sequence["StreamDecoder"],
                             idx_flat, sid, j0: int, j1: int, nq: int,
                             canvas: np.ndarray):
        """Advance every stream through shells [j0, j1), writing symbols at
        their original flat positions into ``canvas`` (int16 [M, np],
        mutated in place). Returns the (positions, values) of symbols
        outside int16, which the canvas cannot hold, or None."""
        t_start = time.perf_counter()
        idx_flat = _ascontig(idx_flat, np.uint8)
        sid = _ascontig(sid, np.int8)
        m, np_ = sid.shape
        if len(streams) != m or canvas.shape != (m, np_) or \
                canvas.dtype != np.int16 or not canvas.flags.c_contiguous:
            raise ValueError("shell decode: bad canvas/streams")
        handles = (ctypes.c_void_p * m)(*[s.handle for s in streams])
        cap = 65536
        ovf_pos = np.empty(cap, dtype=np.int64)
        ovf_val = np.empty(cap, dtype=np.int32)
        rc = self._lib.epic_rans_stream_decode_shell_batch(
            handles, m, _ptr(idx_flat, ctypes.c_uint8),
            _ptr(sid, ctypes.c_int8), np_, j0, j1, nq, *self._tables(),
            _ptr(canvas, ctypes.c_int16), _ptr(ovf_pos, ctypes.c_int64),
            _ptr(ovf_val, ctypes.c_int32), cap, self.nthreads)
        if rc < 0:
            raise RuntimeError(f"shell stream decode failed ({rc})")
        self._stat_add("decode", t_start,
                       int(np.count_nonzero((sid >= j0) & (sid < j1))))
        return (ovf_pos[:rc].copy(), ovf_val[:rc].copy()) if rc else None

    def decode_streams(self, streams: Sequence["StreamDecoder"], indexes,
                       msg_lengths: Sequence[int]) -> np.ndarray:
        """Advance M stream decoders by one chunk each (chunk i covers
        msg_lengths[i] symbols of the packed ``indexes``)."""
        t_start = time.perf_counter()
        indexes = _ascontig(indexes, np.int32).ravel()
        lengths = _ascontig(msg_lengths, np.int64).ravel()
        m = lengths.size
        if len(streams) != m:
            raise ValueError("need one stream per message")
        offs = _offsets(lengths)
        if offs[-1] + lengths[-1] != indexes.size:
            raise ValueError("msg_lengths do not cover the indexes buffer")
        handles = (ctypes.c_void_p * m)(*[s.handle for s in streams])
        out = np.empty(indexes.size, dtype=np.int32)
        rc = self._lib.epic_rans_stream_decode_batch(
            handles, m, _ptr(indexes, ctypes.c_int32),
            _ptr(offs, ctypes.c_int64), _ptr(lengths, ctypes.c_int64),
            *self._tables(), _ptr(out, ctypes.c_int32), self.nthreads)
        if rc != 0:
            raise RuntimeError(f"batched stream decode failed ({rc})")
        self._stat_add("decode", t_start, out.size)
        return out


class StreamDecoder:
    """Stateful chunked decoding of one stream: decode chunk k, derive
    chunk k+1's indexes from it, continue."""

    def __init__(self, coder: RansCoder, data: bytes):
        self._coder = coder
        self._lib = coder._lib
        buf = _ascontig(np.frombuffer(data, dtype=np.uint8), np.uint8)
        self.handle = self._lib.epic_rans_stream_new(
            _ptr(buf, ctypes.c_uint8), buf.size)
        if not self.handle:
            raise ValueError("invalid stream")

    def decode_stream(self, indexes) -> np.ndarray:
        indexes = _ascontig(indexes, np.int32).ravel()
        out = np.empty(indexes.size, dtype=np.int32)
        rc = self._lib.epic_rans_stream_decode(
            self.handle, _ptr(indexes, ctypes.c_int32), indexes.size,
            *self._coder._tables(), _ptr(out, ctypes.c_int32))
        if rc != 0:
            raise RuntimeError(f"stream decode failed with code {rc}")
        return out

    def close(self):
        if self.handle:
            self._lib.epic_rans_stream_free(self.handle)
            self.handle = None

    def __del__(self):
        if getattr(self, "handle", None):
            self.close()
