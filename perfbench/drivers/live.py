"""An open loop of ticks into ``PageRankQueryEngine`` over a
``DynamicPageRankEngine``: each tick pushes one edge delta (a frozen copy
of the program's ``EdgeStream`` rule) and submits its queries; a backlog
of ticks is folded in as one refresh."""
from __future__ import annotations

import time

import numpy as np

from perfbench import checks, loadgen
from perfbench.drivers import Reservoir, Served, sync_all
from perfbench.graphs.stream import EdgeStream
from perfbench.reference import pagerank as rpr


def stream_of(graph, traffic: dict, seed: int) -> EdgeStream:
    return EdgeStream(graph.src, graph.dst, graph.n,
                      loadgen.rng_for(seed, "stream"),
                      int(traffic["arrivals_per_tick"]),
                      int(traffic["expiries_per_tick"]))


class Driver(Served):
    def __init__(self, *a):
        super().__init__(*a)
        from repro_torch.pagerank import DynamicPageRankEngine
        t = self.traffic
        self.eng = self._engine(DynamicPageRankEngine)
        self.eng.run_tol(tol=float(t["refresh_tol"]))
        self._serve_engine(self.eng)
        self._warm_queries(self.eng)
        self._warm_update()
        self.stream = stream_of(self.graph, t, self.seed)
        self.ticks: list = []           # (inserted, deleted) in order
        self.kept = Reservoir(int(t["compare_refreshes"]),
                              loadgen.rng_for(self.seed, "compare"))
        self.plan = self._plan(self.seconds, "arrivals")

    def _delta(self, ins: np.ndarray, dele: np.ndarray):
        from repro_torch.graph.delta import GraphDelta
        return GraphDelta(ins[:, 0], ins[:, 1], dele[:, 0], dele[:, 1])

    def _warm_update(self) -> None:
        """The update path once: one edge absent from the graph inserted
        and deleted again, so the graph ends as it began."""
        n = self.graph.n
        have = set((self.graph.src.astype(np.int64) * n
                    + self.graph.dst).tolist())
        u, v = next((u, v) for u in range(n) for v in range(u + 1, n)
                    if u * n + v not in have)
        pair = np.array([[u, v]], np.int32)
        none = np.zeros((0, 2), np.int32)
        for ins, dele in ((pair, none), (none, pair)):
            self.qe.push_update(self._delta(ins, dele))
            self.qe.refresh()
        sync_all(self.devices)

    def _loop(self, due: np.ndarray, ticks: list, sets: list,
              record: bool) -> dict:
        qe, n = self.qe, len(due)
        per = int(self.traffic["queries_per_tick"])
        lat = np.full(n, np.nan)
        lag = np.zeros(n)
        failed = np.zeros(n, bool)
        refresh_s, sweeps = [], []
        base = len(self.ticks) - n       # ticks applied before this loop
        t0 = time.perf_counter()
        sent = 0
        while sent < n:
            now = time.perf_counter() - t0
            if due[sent] > now:
                time.sleep(due[sent] - now)
                continue
            batch = []
            while sent < n and due[sent] <= now:
                lag[sent] = now - due[sent]
                batch.append(sent)
                sent += 1
            queries = []
            try:
                for i in batch:
                    qe.push_update(self._delta(*ticks[i]))
                r0 = time.perf_counter()
                infos = qe.refresh()
                sync_all(self.devices)
                refresh_s.append(time.perf_counter() - r0)
                sweeps.extend(info.iters for info in infos)
                for i in batch:
                    queries += [(j, qe.submit(j, sets[j], top_k=self.top_k))
                                for j in range(i * per, (i + 1) * per)]
                qe.flush()
                ok = all(q.result is not None for _, q in queries)
            except Exception as err:  # noqa: BLE001 — counted failed
                self._fail(err)
                ok = False
            end = time.perf_counter() - t0
            for i in batch:
                lat[i] = end - due[i]
                failed[i] = not ok
            if record and ok:
                self.kept.offer((base + sent, self.eng.ranks,
                                 [(sets[j], q.result) for j, q in queries]))
        return {"window_s": time.perf_counter() - t0, "latencies_s": lat,
                "lags_s": lag, "failed": failed, "refresh_s": refresh_s,
                "sweeps": sweeps}

    def _plan(self, seconds: float, stream: str) -> tuple:
        """Due times, deltas and seed sets of the ticks of ``seconds``."""
        due, sets = self._queries(seconds, stream)
        ticks = [self.stream.step() for _ in range(len(due))]
        self.ticks.extend(ticks)
        return due, ticks, sets

    def window(self) -> None:
        out = self._loop(*self.plan, True)
        self.rec.update(window_s=out["window_s"],
                        attempted=len(out["lags_s"]),
                        failed=int(out["failed"].sum()),
                        completed=int((~out["failed"]).sum()),
                        latencies_s=out["latencies_s"].tolist(),
                        lags_s=out["lags_s"].tolist(), sweeps=out["sweeps"],
                        calls=len(out["refresh_s"]))
        self.rec["spans"]["refresh"] = out["refresh_s"]

    def stretch(self, seconds: float, stream: str) -> dict:
        due, ticks, sets = self._plan(seconds, stream)
        out = self._loop(due, ticks, sets, False)
        return {"requests": len(due), "calls": len(out["refresh_s"])}

    def outputs(self) -> dict:
        out = {"refreshes": [(k, ranks.detach().double().cpu(), answers)
                             for k, ranks, answers in self.kept.sample()],
               "ticks": self.ticks}
        del self.eng, self.qe, self.landmarks, self.kept
        return out

    def judge(self, out: dict, limits: dict) -> dict:
        return checks.judge_live(self.graph, self.cfg, out["ticks"],
                                 out["refreshes"], self.top_k, limits)

    @staticmethod
    def control(cfg: dict, traffic: dict, graph, seed: int,
                seconds: float) -> dict:
        """The reference in TF32 at the refreshes a window would sample:
        the same ticks and queries, the same draw of refreshes."""
        k, d = int(traffic["top_k"]), float(cfg["d"])
        due, sets = loadgen.plan(graph, traffic, seed, seconds, "arrivals")
        stream = stream_of(graph, traffic, seed)
        ticks = [stream.step() for _ in range(len(due))]
        per = int(traffic["queries_per_tick"])
        rng = loadgen.rng_for(seed, "compare")
        counts = sorted(set(rng.choice(
            np.arange(1, len(ticks) + 1),
            size=min(len(ticks), int(traffic["compare_refreshes"])),
            replace=False).tolist()) | {len(ticks)})
        refreshes = []
        for c, (src, dst) in checks.live_graphs(graph, ticks, counts):
            op = checks.operator(src, dst, graph.n, cfg, "tf32")
            ranks = rpr.pagerank(op, d, checks.FIXED_POINT_ITERS)
            refreshes.append((c, ranks, checks.answers(
                op, sets[(c - 1) * per:c * per], d, k)))
        return checks.judge_live(graph, cfg, ticks, refreshes, k, {})
