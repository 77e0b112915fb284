"""Concurrent sweeps: the encode and full-ladder decode of independent image
batches, with the host phases of several sweeps in flight at once.

A sweep's decode is a chain of host<->device round trips (the base chain
fetches each slice's CDF indexes before it can decode the slice) plus host
rANS, so one sweep alone leaves the device idle most of the time. Sweeps
are independent, and the waits and the C coder release the GIL, so each
worker thread runs one sweep's host phases while the others' device work
runs:

    pipe = SweepPipeline(codec, q_list, rems=True, workers=2)
    for res in pipe.run(batches):
        res["x_hat"]  # [1+Q, B, H, W, 3], ready on the caller's stream

The calling thread queues every sweep's device stages
(``progressive_encode_start``) in submission order on a stream of its own.
Each worker runs ``progressive_encode_finish`` and, with ``decode``,
``progressive_decode_all`` on its own CUDA stream, so its waits (the base
chain's index fetches, ``PICCodec.synchronize``) wait for its own work
only. Tensors that cross threads are ordered by events and guarded with
``record_stream``, so the caching allocator does not hand their memory to
another stream while one still reads it. Results come back in submission
order, at most ``max_in_flight`` sweeps held at a time, and are bitwise
those of the serial path. A worker's exception (a CUDA error included)
is raised to the caller when its result is due.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from contextlib import nullcontext
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence

import torch

from .pic_codec import PICCodec
from .progressive import (progressive_decode_all, progressive_encode_finish,
                          progressive_encode_start)


def _device_tensors(res: Dict[str, Any]):
    """The CUDA tensors a result hands to the caller: x, the checkpoint
    latents and x_hat."""
    ts = [res["x"], res.get("x_hat")] + list(res["ckpts"] or ())
    return [t for t in ts if torch.is_tensor(t) and t.is_cuda]


class SweepPipeline:
    """Encode + full-ladder decode of independent image batches with the
    host phases of up to ``workers`` sweeps in flight at once.

    ``timing`` sums wall seconds over the calling thread
    ("encode_start_s") and the workers ("encode_finish_s", "decode_s"):
    concurrent phases overlap, so the sums exceed the elapsed wall. Each
    phase's "_cpu_s" twin sums the CPU time of the thread that ran it
    (``time.thread_time``): a phase whose wall exceeds its CPU time waited,
    for the device or for the interpreter lock. ``finish_phases`` sums
    ``progressive_encode_finish``'s own split ("device_s": the wait for
    the encode's copies; "rans_s")."""

    def __init__(self, codec: PICCodec,
                 q_list: Optional[Sequence[float]] = None,
                 rems: bool = False, workers: int = 3,
                 max_in_flight: Optional[int] = None, decode: bool = True):
        self.codec = codec
        self.q_list = list(q_list) if q_list is not None else None
        self.rems = bool(rems)
        self.workers = max(1, int(workers))
        self.max_in_flight = int(max_in_flight or (self.workers + 1))
        self.decode = bool(decode)
        self.timing: Dict[str, float] = {
            k + s: 0.0 for k in ("encode_start", "encode_finish", "decode")
            for s in ("_s", "_cpu_s")}
        self.finish_phases: Dict[str, float] = {}
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._cuda = codec.device.type == "cuda"

    def _add(self, timing: Dict[str, float], phases: Dict[str, float]):
        with self._lock:
            for k, v in timing.items():
                self.timing[k] += v
            for k, v in phases.items():
                self.finish_phases[k] = self.finish_phases.get(k, 0.0) + v

    def _worker_stream(self):
        """This worker thread's CUDA stream, made at its first sweep."""
        stream = getattr(self._tls, "stream", None)
        if stream is None:
            stream = self._tls.stream = torch.cuda.Stream(self.codec.device)
        return stream

    def _host_stage(self, st: Dict[str, Any]) -> Dict[str, Any]:
        stream = self._worker_stream() if self._cuda else None
        with torch.cuda.stream(stream) if stream else nullcontext():
            if stream is not None:
                # the encode's device work (x, the checkpoint latents) was
                # queued on the calling thread's stream
                stream.wait_event(st["event"])
                for t in [st["x"]] + list(st["auto_ckpts"] or ()):
                    t.record_stream(stream)
            t0, c0 = time.perf_counter(), time.thread_time()
            phases: Dict[str, float] = {}
            bs, bits = progressive_encode_finish(self.codec, st, phases)
            t1, c1 = time.perf_counter(), time.thread_time()
            res: Dict[str, Any] = {"bitstreams": bs, "bits": bits,
                                   "x": st["x"], "ckpts": st["auto_ckpts"]}
            timing = {"encode_finish_s": t1 - t0,
                      "encode_finish_cpu_s": c1 - c0}
            if self.decode:
                res["x_hat"] = progressive_decode_all(
                    self.codec, bs, rems=self.rems,
                    y_checkpoints=st["auto_ckpts"])["x_hat"]
                timing.update(decode_s=time.perf_counter() - t1,
                              decode_cpu_s=time.thread_time() - c1)
            if stream is not None:
                res["_ready"] = torch.cuda.Event()
                res["_ready"].record(stream)
        self._add(timing, phases)
        return res

    def _deliver(self, fut) -> Dict[str, Any]:
        """A worker's result, ready on the caller's current stream."""
        res = fut.result()
        ready = res.pop("_ready", None)
        if ready is not None:
            caller = torch.cuda.current_stream(self.codec.device)
            caller.wait_event(ready)
            for t in _device_tensors(res):
                t.record_stream(caller)
        return res

    def run(self, batches: Iterable[Any]) -> Iterator[Dict[str, Any]]:
        """Yield one result per input batch, in submission order:
        {"bitstreams", "bits", "x", "ckpts"} (the checkpoint latents the
        encode extracted), and "x_hat" ([1+Q, B, H, W, 3]) with
        ``decode``."""
        enc_stream = torch.cuda.Stream(self.codec.device) if self._cuda \
            else None
        batches = iter(batches)
        with ThreadPoolExecutor(max_workers=self.workers) as ex:
            futs: deque = deque()
            while True:
                # make room before taking the next batch
                while len(futs) >= self.max_in_flight:
                    yield self._deliver(futs.popleft())
                x = next(batches, None)
                if x is None:
                    break
                t0, c0 = time.perf_counter(), time.thread_time()
                if enc_stream is not None:
                    # x and the weights come from the caller's stream
                    enc_stream.wait_stream(torch.cuda.current_stream(
                        self.codec.device))
                    if torch.is_tensor(x) and x.is_cuda:
                        x.record_stream(enc_stream)
                with torch.cuda.stream(enc_stream) if enc_stream \
                        else nullcontext():
                    st = progressive_encode_start(self.codec, x, self.q_list,
                                                  rems=self.rems)
                self._add({"encode_start_s": time.perf_counter() - t0,
                           "encode_start_cpu_s": time.thread_time() - c0},
                          {})
                futs.append(ex.submit(self._host_stage, st))
            while futs:
                yield self._deliver(futs.popleft())


def run_sweeps(codec: PICCodec, batches: Iterable[Any],
               q_list: Optional[Sequence[float]] = None,
               rems: bool = False, workers: int = 3,
               max_in_flight: Optional[int] = None) -> list:
    """Every ``SweepPipeline.run`` result of ``batches``, as a list."""
    pipe = SweepPipeline(codec, q_list, rems=rems, workers=workers,
                         max_in_flight=max_in_flight)
    return list(pipe.run(batches))
