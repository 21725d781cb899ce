"""An open loop of personalized-PageRank queries into
``PageRankQueryEngine`` (result cache, landmark index), flushing whatever
is queued whenever no arrival is due."""
from __future__ import annotations

import time

import numpy as np

from perfbench import checks, loadgen
from perfbench.drivers import Served


class Driver(Served):
    def __init__(self, *a):
        super().__init__(*a)
        from repro_torch.pagerank import PageRankEngine
        self.eng = self._engine(PageRankEngine)
        self._serve_engine(self.eng)
        self._warm_queries(self.eng)
        self.answers: list = []
        self.plan = self._queries(self.seconds, "arrivals")

    def _loop(self, due: np.ndarray, sets: list) -> dict:
        """Send each query at its due time; returns per-query latency,
        lag and the answered queries."""
        qe, n = self.qe, len(due)
        lat = np.full(n, np.nan)
        lag = np.zeros(n)
        failed = np.zeros(n, bool)
        pending: list = []
        flush_s: list = []
        done: list = []
        t0 = time.perf_counter()

        def stamp():
            now = time.perf_counter() - t0
            keep = []
            for i, q in pending:
                if q.result is not None:
                    lat[i] = now - due[i]
                    done.append((i, q))
                else:
                    keep.append((i, q))
            pending[:] = keep

        def lose(err):
            self._fail(err)
            now = time.perf_counter() - t0
            for i, _ in pending:
                failed[i] = True
                lat[i] = now - due[i]
            pending.clear()

        sent = 0
        while sent < n or pending:
            now = time.perf_counter() - t0
            if sent < n and due[sent] <= now:
                lag[sent] = now - due[sent]
                answered = len(done)
                f0 = time.perf_counter()
                try:
                    q = qe.submit(sent, sets[sent], top_k=self.top_k)
                    pending.append((sent, q))
                except Exception as err:  # noqa: BLE001 — counted failed
                    pending.append((sent, None))
                    lose(err)
                sent += 1
                stamp()
                if len(done) > answered:        # the submit filled a batch
                    flush_s.append(time.perf_counter() - f0)
                continue
            if pending:
                f0 = time.perf_counter()
                try:
                    qe.flush()
                except Exception as err:  # noqa: BLE001 — counted failed
                    lose(err)
                flush_s.append(time.perf_counter() - f0)
                stamp()
                continue
            time.sleep(max(0.0, due[sent] - (time.perf_counter() - t0)))
        window = time.perf_counter() - t0
        return {"window_s": window, "latencies_s": lat, "lags_s": lag,
                "failed": failed, "flush_s": flush_s, "done": done}

    def window(self) -> None:
        due, sets = self.plan
        out = self._loop(due, sets)
        self.answers = [(sets[i], q.result) for i, q in out["done"]]
        self.rec.update(window_s=out["window_s"], attempted=len(due),
                        failed=int(out["failed"].sum()),
                        completed=len(out["done"]),
                        latencies_s=out["latencies_s"].tolist(),
                        lags_s=out["lags_s"].tolist(),
                        calls=len(out["flush_s"]))
        self.rec["spans"]["flush"] = out["flush_s"]

    def stretch(self, seconds: float, stream: str) -> dict:
        due, sets = self._queries(seconds, stream)
        out = self._loop(due, sets)
        return {"requests": len(due), "calls": len(out["flush_s"])}

    def outputs(self) -> dict:
        out = {"answers": self.answers}
        del self.eng, self.qe, self.landmarks
        return out

    def judge(self, out: dict, limits: dict) -> dict:
        return checks.judge_answers(self.graph, self.cfg, out["answers"],
                                    self.top_k, limits)

    @staticmethod
    def control(cfg: dict, traffic: dict, graph, seed: int,
                seconds: float) -> dict:
        _, sets = loadgen.plan(graph, traffic, seed, seconds, "arrivals")
        op = checks.operator(graph.src_t, graph.dst_t, graph.n, cfg, "tf32")
        k = int(traffic["top_k"])
        return checks.judge_answers(
            graph, cfg, checks.answers(op, sets, float(cfg["d"]), k), k, {})
