"""The port's token server against the JAX package's: the scenarios of
``tests/test_serve.py`` through both ``ServeEngine``\\ s on the llama3-8b
smoke config with the same weights (JAX ``init_params``, carried by
``repro_torch.models.convert``).  Greedy tokens are equal token for token;
temperature sampling draws from another random stream, so its tokens are
checked for structure.  Also the launcher and the example, on the CPU."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jget
from repro.launch import serve as jlaunch
from repro.models import model as JM
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config as tget
from repro_torch.launch import serve as tlaunch
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import Request, ServeEngine, batched_decode_fn

from lm_parity import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
ARCH = "llama3-8b"


@pytest.fixture(scope="module")
def engines():
    jcfg, tcfg = jget(ARCH), tget(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = params_from_numpy(tcfg, jax.tree.map(np.asarray, jp), device="cpu")
    return (JServeEngine(jcfg, jp, max_len=64),
            ServeEngine(tcfg, tp, max_len=64), tcfg, tp)


def test_greedy_matches_teacher_forcing_and_jax(engines):
    jeng, teng, cfg, params = engines
    prompt = np.array([1, 2, 3, 4, 5], np.int32)
    out = teng.generate(prompt, max_new_tokens=6)
    assert out == jeng.generate(prompt, max_new_tokens=6)
    seq = np.concatenate([prompt, np.array(out[:-1], np.int32)])
    # calling the module runs forward
    logits, _ = params({"tokens": torch.from_numpy(seq)[None]})
    preds = logits[0].argmax(-1).numpy()
    for i in range(6):
        assert preds[len(prompt) - 1 + i] == out[i], (i, out, preds)


def test_generation_deterministic(engines):
    _, teng, _, _ = engines
    p = np.array([7, 8, 9], np.int32)
    assert teng.generate(p, 5) == teng.generate(p, 5)


def test_temperature_sampling_in_vocab_and_seeded(engines):
    jeng, teng, cfg, params = engines
    out = teng.generate(np.array([1, 2], np.int32), 5, temperature=1.0)
    jout = jeng.generate(np.array([1, 2], np.int32), 5, temperature=1.0)
    assert len(out) == len(jout) == 5
    assert all(0 <= t < cfg.vocab_size for t in out)
    # the same seed draws the same stream; another seed another one
    runs = [ServeEngine(cfg, params, max_len=64, seed=s).generate(
        np.array([1, 2], np.int32), 12, temperature=1.0) for s in (3, 3, 4)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


def test_sampling_follows_the_softmax():
    """Gumbel-max over the scaled logits samples softmax(logits / T)."""
    cfg = tget(ARCH)
    eng = ServeEngine(cfg, TM.init_params(cfg, 0, device="cpu"), seed=1)
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]]).expand(20000, 4)
    draws = eng._sample(logits, 0.5)
    freq = np.bincount(draws.numpy(), minlength=4) / 20000
    want = torch.softmax(logits[0] / 0.5, -1).numpy()
    np.testing.assert_allclose(freq, want, atol=0.01)


def test_continuous_batching_completes_all_as_jax(engines):
    jeng, teng, _, _ = engines

    def reqs(cls):
        return [cls(uid=i, prompt=np.arange(1 + i, 6 + i, dtype=np.int32),
                    max_new_tokens=4 + i % 3) for i in range(7)]
    done = teng.serve(reqs(Request), n_slots=3)
    jdone = jeng.serve(reqs(JRequest), n_slots=3)
    assert all(r.done for r in done)
    for r, j in zip(done, jdone):
        assert len(r.output) >= r.max_new_tokens
        assert r.output == j.output


def test_batched_serving_matches_single(engines):
    _, teng, _, _ = engines
    prompt = np.array([3, 1, 4, 1, 5], np.int32)
    single = teng.generate(prompt, 5)
    req = Request(uid=0, prompt=prompt, max_new_tokens=5)
    teng.serve([req], n_slots=2)
    assert req.output[:5] == single


def test_eos_stops_generation(engines):
    jeng, _, cfg, params = engines
    eng = ServeEngine(cfg, params, max_len=64, eos_id=None)
    out_free = eng.generate(np.array([1, 2, 3], np.int32), 8)
    eos = out_free[2]
    eng2 = ServeEngine(cfg, params, max_len=64, eos_id=eos)
    out_eos = eng2.generate(np.array([1, 2, 3], np.int32), 8)
    assert out_eos == out_free[:3]
    jeng2 = JServeEngine(jeng.cfg, jeng.params, max_len=64, eos_id=eos)
    assert jeng2.generate(np.array([1, 2, 3], np.int32), 8) == out_eos


def test_drained_slots_release_kv_caches(engines):
    _, teng, _, _ = engines
    reqs = [Request(uid=i, prompt=np.arange(1, 5, dtype=np.int32),
                    max_new_tokens=3) for i in range(5)]
    done = teng.serve(reqs, n_slots=2)
    assert all(r.done for r in done)
    assert all(c is None for c in teng._caches)


def test_batched_decode_fn_matches_per_sequence_decode(engines):
    """The fixed-batch step over one batched cache gives each sequence's
    batch-1 logits (its cache written in place: clone to reuse one)."""
    _, _, cfg, params = engines
    tokens = torch.tensor([[5, 6, 7, 8], [9, 10, 11, 12]])
    _, cache = TM.prefill(params, {"tokens": tokens}, cfg, 16)
    step = batched_decode_fn(cfg)
    nxt = torch.tensor([[3], [4]])
    batched, after = step(params, {"tokens": nxt},
                          {k: v.clone() for k, v in cache.items()})
    assert int(after["len"]) == 5 and int(cache["len"]) == 4
    for b in range(2):
        _, one = TM.prefill(params, {"tokens": tokens[b:b + 1]}, cfg, 16)
        single, _ = TM.decode_step(params, {"tokens": nxt[b:b + 1]}, one,
                                   cfg)
        # a batch of 2 takes another matmul blocking than a batch of 1:
        # measured largest difference 1.2e-5 on logits of magnitude ~3
        np.testing.assert_allclose(batched[b].numpy(), single[0].numpy(),
                                   rtol=1e-5, atol=1e-4)


def test_launcher_serves_the_jax_launchers_tokens(capsys):
    """The launcher's default traffic (6 requests, 3 slots, 16 tokens) on
    the JAX launcher's own weights gives the JAX launcher's tokens."""
    jreqs = jlaunch.run(["--arch", ARCH, "--smoke"])
    cfg = tget(ARCH)
    jp = JM.init_params(jget(ARCH), jax.random.PRNGKey(0))
    model = params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    capsys.readouterr()
    treqs = tlaunch.run(["--arch", ARCH, "--smoke", "--device", "cpu"],
                        model=model)
    out = capsys.readouterr().out
    assert "served 6 requests, 96 tokens" in out
    assert [r.output for r in treqs] == [r.output for r in jreqs]
    assert [r.prompt.tolist() for r in treqs] == \
        [r.prompt.tolist() for r in jreqs]
    with pytest.raises(ValueError, match="the flags ask for"):
        tlaunch.run(["--arch", "yi-34b", "--smoke", "--device", "cpu"],
                    model=model)


def _run(*args):
    # one intra-op thread: the model is tiny, and the test workers share
    # the host's cores
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": os.environ["PATH"],
           "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=120, cwd=ROOT, env=env)


def test_launcher_module_runs_on_cpu():
    out = _run("-m", "repro_torch.launch.serve", "--arch", ARCH, "--smoke",
               "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "served 6 requests, 96 tokens" in out.stdout
    assert out.stdout.count("  req ") == 3


def test_example_runs_on_cpu():
    out = _run("examples/torch_serve_lm.py", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert out.stdout.rstrip().endswith("serve_lm: OK")
    assert "CPU, eager" in out.stdout
