"""Persistent imputation service: the model and reference panel are loaded
once, and requests stream through the resident imputer.

Port of rag_snvbert_tpu/infer/serve.py: ``ImputationService`` (``create``,
``handle``, ``handle_target``, the JSON-lines loop ``serve_lines``) and
``BatchingImputationService``, which merges concurrent requests of one
missing-site pattern into shared device batches.  Transport is JSON lines
over stdin/stdout (the ``serve`` verb) or HTTP (``infer/httpd.py``).

On a mesh (``serve --data-parallel N``) every rank holds the imputer and
rank 0 runs the front end: before each imputation it broadcasts the
target to the other ranks, which run ``follow`` (the same imputation,
its collectives included) until rank 0's ``release``.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time

import numpy as np
import torch.distributed as dist

from ..io.freq import FreqTable
from ..parallel.comm import broadcast_object
from ..io.vcf import VCFData, load_vcf_or_hdf5
from .imputer import ImputationResult, Imputer


@dataclasses.dataclass
class ImputationService:
    """Resident imputation state + request loop."""

    imputer: Imputer
    ref_vcf: VCFData

    # True when handle() may be called from many threads at once (the
    # HTTP front end keeps a global request lock otherwise).
    concurrent = False

    @classmethod
    def create(cls, model, ref_vcf: VCFData, freq: FreqTable,
               device=None, **imputer_kw) -> "ImputationService":
        """``device=None`` serves on the card (raises without one);
        ``imputer_kw`` go to ``Imputer`` (``rag_mode="token"`` serves a
        V17 ``BERTWithRAG`` model, ``"none"`` a plain ``BERT``)."""
        imp = Imputer(model, ref_vcf, freq, device=device, **imputer_kw)
        return cls(imputer=imp, ref_vcf=ref_vcf)

    @property
    def _world(self) -> int:
        mesh = getattr(self.imputer, "mesh", None)   # any imputer-like
        return 1 if mesh is None else dist.get_world_size()

    def _impute(self, target: VCFData, rounds: int = 1) -> ImputationResult:
        """The imputation itself; on a mesh, rank 0 first hands the target
        to the other ranks (``follow``)."""
        if self._world > 1:
            broadcast_object((target, rounds))
        if rounds > 1:
            return self.imputer.impute_progressive(target, rounds=rounds)
        return self.imputer.impute(target)

    def follow(self) -> int:
        """Ranks other than 0 of a mesh: run every imputation rank 0
        broadcasts, until ``release``; returns how many ran."""
        n = 0
        while (item := broadcast_object(None)) is not None:
            target, rounds = item
            if rounds > 1:
                self.imputer.impute_progressive(target, rounds=rounds)
            else:
                self.imputer.impute(target)
            n += 1
        return n

    def release(self) -> None:
        """Rank 0 of a mesh: end the other ranks' ``follow``."""
        if self._world > 1:
            broadcast_object(None)

    def handle(self, request: dict) -> dict:
        """One request:
          {"target": <vcf/h5 path>, "output_vcf": <path>,
           "npy_prefix": <optional>, "progressive_rounds": <optional int>}
        Returns a JSON-able response dict."""
        t0 = time.time()
        target = load_vcf_or_hdf5(request["target"])
        rounds = int(request.get("progressive_rounds", 1))
        res = self.handle_target(target, rounds=rounds)
        if request.get("npy_prefix"):
            res.save_npy(request["npy_prefix"])
        if request.get("output_vcf"):
            res.write_vcf(request["output_vcf"], self.ref_vcf,
                          target.samples)
        return {"ok": True,
                "sites": int(res.pos.shape[0]),
                "samples": len(target.samples),
                "imputed_sites": int(res.imputed_flag.sum()),
                "seconds": round(time.time() - t0, 3)}

    def handle_target(self, target: VCFData,
                      rounds: int = 1) -> ImputationResult:
        """The device-facing half of ``handle`` (parse and write excluded):
        impute one parsed target (``rounds > 1``: progressive).  The seam
        the batching service overrides."""
        return self._impute(target, rounds)

    def serve_lines(self, in_stream, out_stream) -> int:
        """JSON-lines request loop; returns the number of requests served.
        A blank line or EOF ends the loop; per-request errors are reported
        in-band and the service stays up."""
        n = 0
        for line in in_stream:
            line = line.strip()
            if not line:
                break
            try:
                resp = self.handle(json.loads(line))
            except Exception as e:  # keep serving
                resp = {"ok": False, "error": f"{type(e).__name__}: {e}"}
            out_stream.write(json.dumps(resp) + "\n")
            out_stream.flush()
            n += 1
        return n


@dataclasses.dataclass
class _Pending:
    """One submitted target waiting for (or holding) its result."""

    target: VCFData
    key: int                      # hash of the target's site pattern
    rounds: int = 1
    enqueued: float = dataclasses.field(default_factory=time.monotonic)
    done: threading.Event = dataclasses.field(
        default_factory=threading.Event)
    result: ImputationResult | None = None
    error: BaseException | None = None


@dataclasses.dataclass
class BatchingImputationService(ImputationService):
    """Cross-request batched scheduling over one resident imputer.

    A scheduler thread is the single owner of the device: every imputation
    runs on it, one at a time.  Host work (VCF parse, result writing) stays
    on the request threads and overlaps another request's device work.
    Requests whose targets cover the same site pattern are merged along
    the sample axis into one ``impute`` call (imputation is per sample, so
    splitting the matrices back per request is exact, and merged requests
    fill the fixed device batch instead of each padding it).  Progressive
    requests bypass merging (their working target changes between rounds)
    but still queue through the scheduler.  ``Imputer.impute`` takes its
    own no-grad mode, so the scheduler thread needs none set.
    """

    max_merge: int = 8            # max requests fused into one impute
    max_wait_ms: float = 25.0     # linger for merge partners

    concurrent = True

    def __post_init__(self):
        self._queue: collections.deque[_Pending] = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._merged_requests = 0   # requests that rode a shared impute
        self._impute_calls = 0
        self._queue_wait_s = 0.0    # enqueue -> group taken, summed
        self._queue_wait_max_s = 0.0
        self._linger_s = 0.0        # waiting for merge partners
        self._rows_padded = 0       # device batch rows beyond the samples
        self._thread = threading.Thread(target=self._scheduler_loop,
                                        daemon=True,
                                        name="impute-scheduler")
        self._thread.start()

    def close(self) -> None:
        """Stop the scheduler thread (idempotent).  Queued requests finish
        first; new ``handle_target`` calls are rejected."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- request side ----

    @staticmethod
    def _pattern_key(target: VCFData) -> int:
        return hash(target.pos.tobytes())

    def handle_target(self, target: VCFData,
                      rounds: int = 1) -> ImputationResult:
        if rounds > 1:
            # progressive: no merging, but serialized through the queue so
            # it never interleaves with a merged batch on the device
            item = _Pending(target=target, key=-1, rounds=rounds)
        else:
            item = _Pending(target=target, key=self._pattern_key(target))
        with self._cv:
            if self._closed:
                raise RuntimeError("BatchingImputationService is closed")
            self._queue.append(item)
            self._cv.notify()
        item.done.wait()
        if item.error is not None:
            raise item.error
        return item.result

    # ---- scheduler side ----

    def _take_group(self) -> list[_Pending]:
        """Pop a mergeable group: the head plus same-key neighbours that
        arrive within ``max_wait_ms`` (lingering only while the queue is
        otherwise empty: under load the group forms by itself)."""
        with self._cv:
            while not self._queue:
                if self._closed:
                    return []
                self._cv.wait()
            head = self._queue.popleft()
            group = [head]
            if head.key == -1:
                return group
            deadline = time.monotonic() + self.max_wait_ms / 1000.0
            while len(group) < self.max_merge:
                # the key is a hash: confirm equal positions, so a
                # collision can never merge targets of different patterns
                i = next((j for j, it in enumerate(self._queue)
                          if it.key == head.key and np.array_equal(
                              it.target.pos, head.target.pos)), None)
                if i is not None:
                    group.append(self._queue[i])
                    del self._queue[i]
                    continue
                now = time.monotonic()
                remaining = deadline - now
                if remaining <= 0 or self._queue:
                    break       # incompatible work waiting: don't linger
                self._cv.wait(timeout=remaining)
                self._linger_s += time.monotonic() - now
            return group

    def _run_group(self, group: list[_Pending]) -> None:
        padded = getattr(self.imputer, "rows_padded", 0)   # any imputer-like
        try:
            if len(group) == 1:
                it = group[0]
                it.result = ImputationService.handle_target(
                    self, it.target, rounds=it.rounds)
                it.done.set()
                return
            first = group[0].target
            merged = dataclasses.replace(
                first,
                gt=np.concatenate([it.target.gt for it in group], axis=1),
                samples=[s for it in group for s in it.target.samples])
            res = self._impute(merged)
            self._merged_requests += len(group)
            col = 0
            for it in group:
                n = it.target.n_samples
                it.result = ImputationResult(
                    hap1_prob=res.hap1_prob[:, col:col + n],
                    hap2_prob=res.hap2_prob[:, col:col + n],
                    gt_prob=res.gt_prob[:, col:col + n],
                    pos=res.pos,
                    imputed_flag=res.imputed_flag)
                col += n
                it.done.set()
        except BaseException as e:
            # Delivered to every waiter, and the scheduler keeps serving:
            # an exception that ended this thread would leave every later
            # request waiting forever.
            for it in group:
                if not it.done.is_set():
                    it.error = e
                    it.done.set()
        finally:
            self._rows_padded += getattr(self.imputer, "rows_padded",
                                         0) - padded

    def _scheduler_loop(self) -> None:
        while True:
            group = self._take_group()
            if not group:       # closed and drained
                return
            now = time.monotonic()
            for it in group:
                wait = now - it.enqueued
                self._queue_wait_s += wait
                self._queue_wait_max_s = max(self._queue_wait_max_s, wait)
            self._impute_calls += 1
            self._run_group(group)

    @property
    def stats(self) -> dict:
        """The scheduler's counters (``/health`` returns them): imputations
        run, requests merged into shared ones, the seconds requests waited
        from their enqueue to their group being taken (summed and the
        largest), the seconds the scheduler lingered for merge partners,
        and the device batch rows beyond the samples (padding)."""
        return {"impute_calls": self._impute_calls,
                "merged_requests": self._merged_requests,
                "queue_wait_s": self._queue_wait_s,
                "queue_wait_max_s": self._queue_wait_max_s,
                "linger_s": self._linger_s,
                "rows_padded": self._rows_padded}
