"""Serving: LM token requests, and multi-user personalized PageRank over
one prepared graph.

The PyTorch counterpart of ``repro.serve.engine``.  :class:`ServeEngine`
serves token requests from a language model
(:mod:`repro_torch.models`): prefill + decode with slot-based continuous
batching, a host-side scheduler over ``n_slots`` sequences, each with
its own batch-1 decode cache, as in the JAX engine.  Prefill and decode
run eagerly (the JAX engine jits them once per shape).  Greedy decoding
is ``argmax``; temperature sampling draws the Gumbel-max of the scaled
logits from a seeded ``torch.Generator`` on the logits' device — the
distribution of ``jax.random.categorical``, from another random stream.

:class:`PageRankQueryEngine` and ``PPRQuery`` serve PageRank.  Per-user
seed sets queue up and are flushed as **one** batched (N, Q) propagation
through :meth:`repro_torch.pagerank.engine.PageRankEngine.ppr` — Q
queries share each sweep over H instead of paying Q independent power
iterations (the MELOPPR batching).  Two optional, independent
accelerations sit in front of it: a
:class:`~repro_torch.serve.cache.ResultCache` answers repeated seed sets
on the host, and a
:class:`~repro_torch.pagerank.landmarks.LandmarkIndex` replaces the cold
solve with hub-combination warm starts plus a short residual push.

Over a :class:`~repro_torch.pagerank.dynamic.DynamicPageRankEngine` the
graph is live: ``push_update`` queues a delta, and ``refresh`` — run by
every ``flush`` before it serves — folds the backlog into the engine as
one update (``compose``), bumps ``graph_version`` and runs the cache's
delta-aware invalidation with the per-column perturbation weights.

With ``resilience=ServeResilience()`` the live path stops trusting its
inputs and its own solves, as the JAX package's resilient mode does:
pushed deltas are screened by
:func:`~repro_torch.graph.validate.validate_delta` (bad edges quarantined
into ``dead_letters``), refreshes run through the
:class:`~repro_torch.pagerank.resilience.ResilientRefresher` ladder (retry
→ rebuild → restore the last-known-good snapshot), and every served batch
is health-checked: an unhealthy PPR triggers one recovery and one
re-serve, then falls back to the last good global ranks.  Queries are
tagged ``fresh`` / ``stale`` / ``degraded`` with the snapshot version they
were answered from.  A fault of the card itself (a kernel that does not
build or launch, a CUDA error) is never turned into a tag: it propagates.

Each flush copies the solved (N, Q) matrix to the host once, then
health-checks it and ranks every query's top-k there.  Every non-empty
flush records one ``serve`` event (schema v1, the JAX package's keys) and
the ``serve.*`` counters and histograms; the resilient mode adds the
``dead_letter``, ``refresh`` and ``watchdog`` events and the per-status
counters, so ``scripts/obs_report.py`` re-derives the port's log.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.graph.delta import compose
from repro_torch.graph.validate import (DeadLetterQueue, ValidationPolicy,
                                        validate_delta)
from repro_torch.models import model as M
from repro_torch.obs.registry import default_registry
from repro_torch.pagerank.resilience import (RankStore, ResilientRefresher,
                                             RetryPolicy, is_kernel_fault,
                                             ppr_healthy)
from repro_torch.pagerank.sparse import top_k_proteins
from repro_torch.serve.cache import ResultCache

__all__ = ["Request", "ServeEngine", "batched_decode_fn", "PPRQuery",
           "PageRankQueryEngine", "ServeResilience"]


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0      # 0 => greedy
    output: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Single-host token server over one model (a
    :class:`~repro_torch.models.model.LanguageModel`); the prompts and
    tokens live on the model's device."""

    def __init__(self, cfg: ModelConfig, params, max_len: int = 512,
                 eos_id: int | None = None, seed: int = 0):
        if not cfg.embed_input:
            raise ValueError("token serving requires an embedding frontend")
        self.cfg = cfg
        self.params = params
        self.max_len = max_len
        self.eos_id = eos_id
        self.device = params.device
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _prefill(self, prompt: np.ndarray):
        tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=self.device)[None, :]
        return M.prefill(self.params, {"tokens": tokens}, self.cfg,
                         self.max_len)

    def _decode(self, tok: torch.Tensor, cache: dict):
        """One step on ``cache``, which it writes in place."""
        return M.decode_step(self.params, {"tokens": tok[:, None]}, cache,
                             self.cfg)

    # ---------------- single-sequence paths ---------------- #
    def generate(self, prompt: np.ndarray, max_new_tokens: int = 32,
                 temperature: float = 0.0) -> list[int]:
        logits, cache = self._prefill(prompt)
        out = []
        tok = self._sample(logits, temperature)
        for _ in range(max_new_tokens):
            t = int(tok[0])
            out.append(t)
            if self.eos_id is not None and t == self.eos_id:
                break
            logits, cache = self._decode(tok, cache)
            tok = self._sample(logits, temperature)
        return out

    # ---------------- batched continuous serving ---------------- #
    def serve(self, requests: list[Request], n_slots: int = 4,
              max_steps: int = 10_000) -> list[Request]:
        """Run all requests to completion with ``n_slots`` slots.
        Sequences are prefilled independently (per-slot prefill) and each
        active slot decodes one token per step; finished slots are
        refilled from the queue."""
        queue = deque(requests)
        slots: list[Request | None] = [None] * n_slots
        # exposed as self._caches so tests (and memory accounting) can
        # verify drained slots release their KV cache
        self._caches = caches = [None] * n_slots
        last_tok: list[torch.Tensor | None] = [None] * n_slots

        def fill_slot(i: int) -> None:
            if not queue:
                # drain: drop the finished sequence's KV cache too, so it
                # stops pinning device memory for the rest of the serve
                slots[i] = None
                caches[i] = None
                last_tok[i] = None
                return
            req = queue.popleft()
            logits, cache = self._prefill(req.prompt)
            tok = self._sample(logits, req.temperature)
            req.output.append(int(tok[0]))
            slots[i] = req
            caches[i] = cache
            last_tok[i] = tok

        for i in range(n_slots):
            fill_slot(i)

        for _ in range(max_steps):
            active = [i for i, r in enumerate(slots) if r is not None]
            if not active:
                break
            for i in active:
                req = slots[i]
                done = (len(req.output) >= req.max_new_tokens or
                        (self.eos_id is not None
                         and req.output[-1] == self.eos_id))
                if done:
                    req.done = True
                    fill_slot(i)
            active = [i for i, r in enumerate(slots) if r is not None]
            if not active:
                break
            # one decode step per active slot (batch-1 caches), as in the
            # JAX engine; batched_decode_fn is the fixed-batch step
            for i in active:
                req = slots[i]
                logits, caches[i] = self._decode(last_tok[i], caches[i])
                tok = self._sample(logits, req.temperature)
                req.output.append(int(tok[0]))
                last_tok[i] = tok
        return requests

    def _sample(self, logits: torch.Tensor,
                temperature: float) -> torch.Tensor:
        if temperature <= 0.0:
            return logits.argmax(dim=-1)
        # Gumbel-max: argmax(logits / T + G) with G = -log(-log U)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device, dtype=torch.float32)
        u = u.clamp_(min=torch.finfo(torch.float32).tiny)
        return (logits / temperature - torch.log(-torch.log(u))).argmax(-1)


def batched_decode_fn(cfg: ModelConfig) -> Callable:
    """The fixed-batch decode step (one batched cache for every
    sequence); it writes the cache it is given, as ``decode_step``."""
    def step(params, batch, cache):
        return M.decode_step(params, batch, cache, cfg)
    return step


@dataclasses.dataclass(frozen=True)
class ServeResilience:
    """Resilience knobs for :class:`PageRankQueryEngine` — pass an instance
    (or just ``ServeResilience()``) to turn the serving path from
    raise-on-anything into validate / quarantine / degrade-gracefully.

    ``validation`` screens every pushed delta
    (:func:`repro_torch.graph.validate.validate_delta`); ``retry`` bounds
    the exponential-backoff update retries; ``snapshots`` is the last-
    known-good ring size; ``healthy_atol`` the sum-to-1 tolerance of the
    serve health checks; ``dead_letter_maxlen`` the quarantine audit
    window."""

    validation: ValidationPolicy = ValidationPolicy()
    retry: RetryPolicy = RetryPolicy()
    snapshots: int = 4
    healthy_atol: float = 1e-3
    dead_letter_maxlen: int = 256


@dataclasses.dataclass
class PPRQuery:
    uid: int
    seeds: np.ndarray             # int indices of the user's seed proteins
    top_k: int = 10
    result: tuple | None = None   # (indices, scores) once served
    # resilience tags, stamped at serve time (resilient mode only):
    # "fresh"    — ranks include every accepted delta
    # "stale"    — last refresh failed; ranks predate the pending deltas
    # "degraded" — personalized serve unhealthy; global last-known-good
    #              ranks substituted
    status: str = "unserved"
    graph_version: int = -1       # RankStore version the result was built on
    # cache-enabled engines stamp how the answer was produced:
    # "hit" (served from cache) / "miss" (solved this flush); None when
    # the engine runs without a cache
    cache_outcome: str | None = None


def _topk(ranks, k: int) -> tuple[np.ndarray, np.ndarray]:
    idx, scores = top_k_proteins(ranks, k=k)
    return idx.numpy(), scores.numpy()


class PageRankQueryEngine:
    """Multi-user personalized-PageRank serving over one prepared
    :class:`~repro_torch.pagerank.engine.PageRankEngine`.

    ``submit`` queues a query and flushes at ``max_batch``; ``flush``
    serves the queue with one batched solve, after applying any pending
    graph deltas; ``query_batch`` is the one-shot form; ``push_update`` /
    ``refresh`` take live graph updates (a dynamic engine only).
    ``resilience`` (a :class:`ServeResilience`) turns on the resilient
    mode of the module docstring; with ``None`` the path raises on any
    error, as the JAX package's legacy mode does.  ``cache`` and
    ``landmarks`` are optional, as in the JAX package; every query is
    stamped ``cache_outcome`` when a cache is attached, and flushes record
    per-outcome counters and latency histograms.
    """

    def __init__(self, engine, n_iters: int = 100, max_batch: int = 8,
                 refresh_tol: float = 1e-6,
                 resilience: ServeResilience | None = None, metrics=None,
                 cache: ResultCache | None = None, landmarks=None):
        self.engine = engine
        self.n_iters = n_iters
        self.max_batch = max_batch
        self.refresh_tol = refresh_tol
        self._queue: list[PPRQuery] = []
        self._pending_deltas: list = []
        self.n_refreshes = 0
        self.last_update_info = None
        self.resilience = resilience
        self.last_refresh_outcome = None
        self._stale = False
        self.cache = cache
        self.landmarks = landmarks
        # cache-consistency clock: bumped on every applied refresh
        self.graph_version = 0
        self._last_flush_stats: dict | None = None
        # metrics sink: share the engine's registry by default so solves
        # and serves land in one event log
        self.metrics = (metrics if metrics is not None
                        else getattr(engine, "metrics", None)
                        or default_registry())
        # freshness clock: when the served ranks last matched the graph
        self._last_refresh_t = time.monotonic()
        if resilience is not None:
            self.dead_letters = DeadLetterQueue(
                maxlen=resilience.dead_letter_maxlen)
            self.refresher = ResilientRefresher(
                store=RankStore(maxlen=resilience.snapshots),
                retry=resilience.retry,
                healthy_atol=resilience.healthy_atol)
            self._ensure_baseline()

    # ----------------------- resilience plumbing ----------------------- #
    def _recoverable(self) -> bool:
        return hasattr(self.engine, "rebuild_and_solve")

    def _ensure_baseline(self) -> None:
        """Record the engine's current state as the first restore target
        (no-op until the engine has healthy solved ranks)."""
        if self._recoverable() and len(self.refresher.store) == 0:
            self.refresher.baseline(self.engine)

    def submit(self, uid: int, seeds, top_k: int = 10) -> PPRQuery:
        """Queue one user's query; flushed automatically at ``max_batch``.
        Rejects bad seed sets here, before they can poison a batch."""
        seeds = np.unique(np.asarray(seeds, np.int64).ravel())
        if seeds.size == 0:
            raise ValueError(f"uid {uid}: empty seed set")
        if seeds.min() < 0 or seeds.max() >= self.engine.n:
            raise ValueError(f"uid {uid}: seed index out of range "
                             f"[0, {self.engine.n})")
        q = PPRQuery(uid, seeds, top_k)
        self._queue.append(q)
        if len(self._queue) >= self.max_batch:
            self.flush()
        return q

    def push_update(self, delta):
        """Queue a streamed :class:`~repro_torch.graph.delta.GraphDelta`;
        it is folded into the graph at the next :meth:`refresh` /
        :meth:`flush`, before any queued query is served.  A malformed
        delta is handled here, before it can poison the pending batch: the
        legacy path raises; in resilient mode the delta runs through
        :func:`~repro_torch.graph.validate.validate_delta` — invalid edges
        land in ``dead_letters`` with structured reasons, the clean
        remainder is queued, and the
        :class:`~repro_torch.graph.validate.ValidationResult` is returned
        (a ``"reject"`` validation policy still raises
        :class:`~repro_torch.graph.validate.DeltaRejected`)."""
        if not hasattr(self.engine, "update"):
            raise TypeError(
                "push_update needs a DynamicPageRankEngine; "
                f"got a static {type(self.engine).__name__}")
        if self.resilience is None:
            self._pending_deltas.append(delta.canonical(
                self.engine.n, symmetric=self.engine.symmetric))
            return None
        result = validate_delta(delta, self.engine.n,
                                self.resilience.validation)
        self.dead_letters.extend(result.dead_letters)
        if result.dead_letters:
            n_edges = sum(dl.n_edges for dl in result.dead_letters)
            self.metrics.counter("serve.dead_letters").inc(n_edges)
            self.metrics.event(
                "dead_letter", n_edges=n_edges,
                reasons=sorted({dl.reason for dl in result.dead_letters}))
        if result.delta is not None:
            self._pending_deltas.append(result.delta.canonical(
                self.engine.n, symmetric=self.engine.symmetric))
        return result

    def refresh(self) -> list:
        """Apply every pending delta to the live engine now — coalesced
        into ONE update (``compose`` keeps the in-order semantics), so a
        backlog of k stream ticks costs one solve, not k.

        Legacy mode returns the
        :class:`~repro_torch.pagerank.dynamic.UpdateInfo` records (one
        entry when anything was pending); on an exception the deltas are
        re-queued, ahead of anything pushed meanwhile, and the exception
        propagates.  Resilient mode runs the update through the
        :class:`~repro_torch.pagerank.resilience.ResilientRefresher` ladder
        and returns its
        :class:`~repro_torch.pagerank.resilience.RefreshOutcome` (also kept
        as ``last_refresh_outcome``); if the delta could not be applied it
        is re-queued and later serves are tagged ``"stale"`` until a
        refresh succeeds.  It raises only a fault of the card, with the
        deltas re-queued."""
        deltas, self._pending_deltas = self._pending_deltas, []
        if not deltas:
            return []
        merged = deltas[0] if len(deltas) == 1 else compose(
            deltas, self.engine.n, symmetric=self.engine.symmetric)
        # pre-update out-degrees anchor the per-column perturbation
        # weights of the delta-aware cache invalidation
        old_outdeg = (np.asarray(self.engine._outdeg).copy()
                      if self.cache is not None else None)
        if self.resilience is None:
            try:
                _, info = self.engine.update(merged, tol=self.refresh_tol)
            except Exception:
                self._pending_deltas = deltas + self._pending_deltas
                raise
            self.n_refreshes += 1
            self.last_update_info = info
            self._last_refresh_t = time.monotonic()
            self.metrics.counter("serve.refresh.ok").inc()
            self.metrics.event("refresh", applied=True, attempts=1,
                               status="ok", strategy=info.strategy)
            self._after_refresh(merged, old_outdeg)
            return [info]
        self._ensure_baseline()
        try:
            outcome = self.refresher.refresh(self.engine, merged,
                                             tol=self.refresh_tol)
        except Exception:
            self._pending_deltas = deltas + self._pending_deltas
            raise
        self.last_refresh_outcome = outcome
        self._stale = not outcome.delta_applied
        info = outcome.update_info
        self.metrics.counter(f"serve.refresh.{outcome.status}").inc()
        self.metrics.event("refresh", applied=outcome.delta_applied,
                           attempts=outcome.attempts,
                           status=outcome.status,
                           strategy=getattr(info, "strategy", None))
        if info is not None and not info.healthy:
            self.metrics.event("watchdog", source="refresh",
                               strategy=info.strategy,
                               diverged=info.diverged,
                               nonfinite=info.nonfinite)
        if outcome.delta_applied:
            self.n_refreshes += 1
            self.last_update_info = info
            self._last_refresh_t = time.monotonic()
            if outcome.status == "ok":
                self._after_refresh(merged, old_outdeg)
            else:
                # "recovered": the engine was rebuilt from host bookkeeping
                # after a poisoned solve — the per-column story no longer
                # describes how far the graph moved, so flush wholesale
                self._invalidate_all()
        else:
            # the graph never took the delta (every retry raised, or the
            # engine was rolled back to the snapshot) — re-queue it ahead
            # of anything pushed meanwhile, so order is preserved
            self._pending_deltas = deltas + self._pending_deltas
            if outcome.status == "restored":
                # rollback may have moved the graph BEHIND the cached
                # entries (the snapshot can predate served answers)
                self._invalidate_all()
        return [outcome]

    # ------------------------ cache invalidation ----------------------- #
    def _after_refresh(self, merged, old_outdeg) -> None:
        """Bump the cache-consistency clock after an applied delta and run
        the delta-aware invalidation: the transition columns that changed
        are the delta's source endpoints, and a column's L1 perturbation
        is bounded by ``2·(#changed edges at u)/deg(u)``.  Entries holding
        enough rank mass on perturbed columns are dropped, the rest
        re-stamped (:meth:`ResultCache.invalidate`)."""
        self.graph_version += 1
        if self.cache is None:
            return
        cols = np.concatenate([
            np.asarray(merged.insert_src, np.int64),
            np.asarray(merged.delete_src, np.int64)])
        uniq, counts = np.unique(cols, return_counts=True)
        new_deg = np.asarray(self.engine._outdeg)[uniq].astype(np.float64)
        old_deg = old_outdeg[uniq].astype(np.float64)
        w = np.minimum(2.0, 2.0 * counts
                       / np.maximum(np.maximum(old_deg, new_deg), 1.0))
        dropped, kept = self.cache.invalidate(uniq, w, self.graph_version)
        self.metrics.counter("serve.cache.invalidations").inc(dropped)
        self.metrics.event("cache_invalidate", cols=int(uniq.size),
                           dropped=dropped, kept=kept,
                           version=self.graph_version)

    def _invalidate_all(self) -> None:
        """Escape hatch for recovery paths with no per-column story: bump
        the clock and drop every cached answer."""
        self.graph_version += 1
        if self.cache is None:
            return
        dropped, kept = self.cache.invalidate(None, None,
                                              self.graph_version)
        self.metrics.counter("serve.cache.invalidations").inc(dropped)
        self.metrics.event("cache_invalidate", cols=None, dropped=dropped,
                           kept=kept, version=self.graph_version)

    def flush(self) -> list[PPRQuery]:
        """Serve every queued query with one batched solve — after folding
        in any pending graph deltas, so in-flight queries never see ranks
        staler than one refresh interval.

        Resilient mode additionally health-checks the batched PPR matrix
        (finite, non-negative, every column sum-to-1).  An unhealthy or
        raising serve triggers ONE engine recovery and a re-serve; if that
        also fails, queries are answered from the last good *global* rank
        vector, tagged ``"degraded"``.  Only a fault of the card raises.

        Every non-empty flush records one ``serve`` event and a
        ``serve.batch_ms`` latency sample (refresh included), bumps the
        batch/query counters (per-status in resilient mode), and sets the
        ``serve.freshness_lag_s`` gauge."""
        t0 = time.perf_counter()
        batch = self._flush()
        if not batch:
            return batch
        ms = (time.perf_counter() - t0) * 1e3
        lag = time.monotonic() - self._last_refresh_t
        status = "legacy" if self.resilience is None else batch[0].status
        m = self.metrics
        m.histogram("serve.batch_ms").observe(ms)
        m.gauge("serve.freshness_lag_s").set(lag)
        m.counter("serve.batches").inc()
        m.counter("serve.queries").inc(len(batch))
        if self.resilience is not None:
            m.counter(f"serve.queries.{status}").inc(len(batch))
        extra = {}
        if self.cache is not None:
            st = self._last_flush_stats or {}
            m.counter("serve.cache.hits").inc(st.get("hits", 0))
            m.counter("serve.cache.misses").inc(st.get("misses", 0))
            m.counter("serve.cache.evictions").inc(st.get("evictions", 0))
            if st.get("hit_ms") is not None:
                m.histogram("serve.cache.hit_ms").observe(st["hit_ms"])
            if st.get("miss_ms") is not None:
                m.histogram("serve.cache.miss_ms").observe(st["miss_ms"])
            # additive optional fields: the event schema stays v=1 and
            # cache-less logs carry the same keys as the JAX package's
            extra = dict(cache_hits=st.get("hits", 0),
                         cache_misses=st.get("misses", 0),
                         cache_evictions=st.get("evictions", 0),
                         hit_ms=st.get("hit_ms"), miss_ms=st.get("miss_ms"))
        m.event("serve", batch=len(batch), freshness_lag_s=lag,
                graph_version=batch[0].graph_version, ms=ms,
                status=status,
                precision=getattr(self.engine, "precision", "f32"),
                **extra)
        return batch

    def _flush(self) -> list[PPRQuery]:
        if self._pending_deltas:
            self.refresh()
        batch, self._queue = self._queue, []
        if not batch:
            return []
        if self.cache is None:
            self._serve_queries(batch)
            return batch
        # cache-enabled path: answer repeats from the cache (no device
        # work), solve only the misses, and cache what the misses produced
        precision = str(getattr(self.engine, "precision", "f32"))
        t0 = time.perf_counter()
        hits: list[tuple[PPRQuery, np.ndarray]] = []
        misses: list[tuple[PPRQuery, tuple]] = []
        for q in batch:
            key = ResultCache.key(q.seeds, precision)
            ranks = self.cache.get(key, self.graph_version)
            if ranks is not None:
                hits.append((q, ranks))
            else:
                misses.append((q, key))
        st = {"hits": len(hits), "misses": len(misses), "evictions": 0,
              "hit_ms": None, "miss_ms": None}
        if hits:
            status = "stale" if self._stale else "fresh"
            version = (self.refresher.store.version
                       if self.resilience is not None else -1)
            for q, ranks in hits:
                q.result = _topk(ranks, q.top_k)
                q.cache_outcome = "hit"
                if self.resilience is not None:
                    q.status = status
                    q.graph_version = version
            st["hit_ms"] = (time.perf_counter() - t0) * 1e3
        if misses:
            t1 = time.perf_counter()
            PPR = self._serve_queries([q for q, _ in misses])
            for j, (q, key) in enumerate(misses):
                q.cache_outcome = "miss"
                if PPR is not None and q.status != "degraded":
                    st["evictions"] += self.cache.put(
                        key, np.asarray(PPR[:, j], np.float32),
                        self.graph_version)
            st["miss_ms"] = (time.perf_counter() - t1) * 1e3
        self._last_flush_stats = st
        return batch

    def _serve_queries(self, batch) -> np.ndarray | None:
        """Answer ``batch`` in place (results and, in resilient mode, the
        tags) with one batched solve; returns the solved (N, Q) host
        matrix so the cache path can keep the full rank vectors (``None``
        when the resilient path degraded to global ranks — never
        cached)."""
        if self.resilience is None:
            PPR = self._solve_batch([q.seeds for q in batch])  # (N, Q)
            for j, q in enumerate(batch):
                q.result = _topk(PPR[:, j], q.top_k)
            return PPR
        PPR = self._serve_ppr(batch)
        if PPR is None and self._recoverable():
            # one recovery attempt, then one re-serve — bounded work per
            # flush, no retry storm.  Recovery rebuilds or rolls back the
            # engine, so any cached answer may now describe a different
            # graph: flush wholesale (no per-column story exists)
            self.refresher.recover(self.engine, tol=self.refresh_tol)
            self._invalidate_all()
            PPR = self._serve_ppr(batch)
        version = self.refresher.store.version
        if PPR is not None:
            status = "stale" if self._stale else "fresh"
            for j, q in enumerate(batch):
                q.result = _topk(PPR[:, j], q.top_k)
                q.status = status
                q.graph_version = version
            return PPR
        # degraded: answer from the last-known-good global ranks (or the
        # uniform distribution if no snapshot exists yet) — finite and
        # sum-to-1 by construction, explicitly tagged
        snap = self.refresher.store.latest()
        if snap is not None and snap.ranks is not None:
            ranks = np.asarray(snap.ranks, np.float32)
        else:
            ranks = np.full(self.engine.n, 1.0 / self.engine.n, np.float32)
        for q in batch:
            q.result = _topk(ranks, q.top_k)
            q.status = "degraded"
            q.graph_version = version
        return None

    def _solve_batch(self, seed_sets) -> np.ndarray:
        """The cold-solve choke point: hub-combination + bounded residual
        push when a landmark index is attached (exact-solve fallback per
        column lives inside ``answer``), else the classic batched power
        iteration, copied to the host once."""
        if self.landmarks is not None:
            self.landmarks.ensure(self.graph_version)
            X, _ = self.landmarks.answer(seed_sets)
            return X
        return self.engine.ppr(seed_sets, n_iters=self.n_iters).cpu().numpy()

    def _serve_ppr(self, batch) -> np.ndarray | None:
        """One batched PPR solve, health-checked: the (N, Q) host matrix,
        or ``None`` if the solve raised or produced a poisoned batch.  A
        fault of the card propagates."""
        try:
            PPR = self._solve_batch([q.seeds for q in batch])
        except Exception as e:  # noqa: BLE001 — degradation contract
            if is_kernel_fault(e):
                raise
            return None
        atol = self.resilience.healthy_atol
        return PPR if ppr_healthy(PPR, atol=atol) else None

    def query_batch(self, seed_sets, top_k: int = 10) -> list[tuple]:
        """One-shot convenience: serve ``seed_sets`` now, return per-user
        ``(indices, scores)`` ranked top-k."""
        queries = [self.submit(uid, s, top_k=top_k)
                   for uid, s in enumerate(seed_sets)]
        self.flush()
        return [q.result for q in queries]
