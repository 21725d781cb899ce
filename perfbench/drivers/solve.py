"""A closed loop of one caller: ``PageRankEngine.run(n_iters)`` and the
top-k of its vector read to the host, again and again."""
from __future__ import annotations

import time

from perfbench import checks, loadgen
from perfbench.drivers import Driver as Base
from perfbench.drivers import Reservoir, sync_all


class Driver(Base):
    def __init__(self, *a):
        super().__init__(*a)
        from repro_torch.pagerank import PageRankEngine
        from repro_torch.pagerank.sparse import top_k_proteins
        self._top = top_k_proteins
        self.n_iters = int(self.cfg["n_iters"])
        self.eng = self._engine(PageRankEngine)
        self._solve()
        sync_all(self.devices)
        self.kept = Reservoir(int(self.traffic["compare_solves"]),
                              loadgen.rng_for(self.seed, "compare"))

    def _solve(self):
        pr = self.eng.run(self.n_iters)
        idx, scores = self._top(pr, self.top_k)
        return pr, idx.cpu().numpy(), scores.cpu().numpy()

    def window(self) -> None:
        count = 0
        t0 = time.perf_counter()
        while True:
            self.kept.offer(self._solve())
            count += 1
            if time.perf_counter() - t0 >= self.seconds:
                break
        self.rec.update(window_s=time.perf_counter() - t0, attempted=count,
                        completed=count, failed=0, calls=count)

    def stretch(self, seconds: float, stream: str) -> dict:
        count = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._solve()
            count += 1
        return {"iterations": count * self.n_iters, "requests": count,
                "calls": count}

    def outputs(self) -> dict:
        out = {"solves": [(pr.detach().double().cpu(), idx, scores)
                          for pr, idx, scores in self.kept.sample()]}
        del self.eng, self.kept
        return out

    def judge(self, out: dict, limits: dict) -> dict:
        ref = checks.global_ranks(self.graph, self.cfg, self.n_iters,
                                  "f64").cpu()
        return checks.judge_solves(out["solves"], ref, self.top_k, limits)

    @staticmethod
    def control(cfg: dict, traffic: dict, graph, seed: int,
                seconds: float) -> dict:
        k, n_iters = int(traffic["top_k"]), int(cfg["n_iters"])
        x = checks.global_ranks(graph, cfg, n_iters, "tf32")
        ref = checks.global_ranks(graph, cfg, n_iters, "f64")
        return checks.judge_solves([(x, *checks.top(x, k))], ref, k, {})
