"""The port's LM serving engine and ``serve`` launcher on the CPU, held
against the JAX reference's ``ServingEngine``.

Both engines take the same weights (the reference's ``init_params`` of the
reduced float32 qwen2-vl-2b, carried over by ``params_from_jax``) and the
same 6 requests, drawn from ``np.random.default_rng(0)`` as the
reference's launcher draws them, and are driven by the launcher's loop.
Every decode call's logits agree within 1e-5 × max|logits|, and the
engines emit the same tokens.  Tie tolerance: two logits within twice that
(2e-5 × max|logits|) could swap places between the packages, so the test
also checks, on the reference's logits, that every slot's winning token
beat the runner-up by more than that: the equal tokens are no coin toss.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jax_model
from repro.serving import engine as jax_engine
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import launch_counts
from repro_torch.launch import serve
from repro_torch.models.convert import params_from_jax
from repro_torch.serving import Request, ServingEngine, greedy_sample

CPU = torch.device("cpu")
LOGIT_RTOL = 1e-5
TIE = 2 * LOGIT_RTOL


def reduced(get, **kw):
    return dataclasses.replace(get("qwen2-vl-2b").reduced(), dtype="float32", **kw)


def launcher_requests(cls, n, vocab, max_new):
    rng = np.random.default_rng(0)
    return [cls(rid=i, prompt=rng.integers(0, vocab, size=rng.integers(2, 8)),
                max_new=max_new) for i in range(n)]


class Recorder:
    """Wraps an engine's step function and keeps every call's logits."""

    def __init__(self, step):
        self.step, self.logits = step, []

    def __call__(self, params, tokens, cache):
        logits, cache = self.step(params, tokens, cache)
        self.logits.append(np.array(logits, dtype=np.float32))
        return logits, cache


def drive(eng, pending, n):
    """The launcher's loop; returns the number of step() calls."""
    done = steps = 0
    while done < n:
        while pending and eng.submit(pending[0]):
            pending.pop(0)
        eng.step()
        steps += 1
        done = n - len(pending) - sum(r is not None for r in eng.requests)
    return steps


@pytest.mark.parametrize("slots,max_len", [(4, 64), (2, 16)])
def test_engine_emits_the_reference_tokens(slots, max_len):
    """Slots 4 (the launcher's) and 2 with a 16-slot ring, which wraps and
    recycles slots while other requests still decode."""
    cfg = reduced(get_config)
    jcfg = reduced(jax_get_config)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_jax(cfg, jax.tree.map(np.asarray, jparams), device=CPU)
    n, max_new = 6, 16
    jreqs = launcher_requests(jax_engine.Request, n, cfg.vocab, max_new)
    reqs = launcher_requests(Request, n, cfg.vocab, max_new)
    for a, b in zip(jreqs, reqs):
        assert np.array_equal(a.prompt, b.prompt)

    jeng = jax_engine.ServingEngine(jcfg, jparams, batch_slots=slots, max_len=max_len, eos=-1)
    eng = ServingEngine(cfg, params, batch_slots=slots, max_len=max_len, eos=-1)
    jeng._step, eng._step = Recorder(jeng._step), Recorder(eng._step)
    jsteps = drive(jeng, list(jreqs), n)
    steps = drive(eng, list(reqs), n)
    assert steps == jsteps
    assert len(eng._step.logits) == len(jeng._step.logits) == steps + sum(
        len(r.prompt) for r in reqs)
    for out, ref in zip(eng._step.logits, jeng._step.logits):
        np.testing.assert_allclose(out, ref, atol=LOGIT_RTOL * np.abs(ref).max(), rtol=0)
    assert all(r.done and len(r.out) == max_new for r in reqs)
    for jr, r in zip(jreqs, reqs):
        assert r.out == jr.out, f"request {r.rid}"
    # no near-tie hid behind the equality: every emitted token won by more
    # than TIE (checked on the reference's logits)
    gaps = [np.diff(np.sort(lg[..., :cfg.vocab], axis=-1)[..., -2:], axis=-1).min()
            / np.abs(lg).max() for lg in jeng._step.logits]
    assert min(gaps) > TIE


def test_greedy_sample_takes_the_first_of_tied_maxima():
    logits = torch.tensor([[[0.0, 2.0, 2.0, 1.0, 9.0]]])
    assert greedy_sample(logits, vocab=4).tolist() == [[1]]
    assert greedy_sample(logits, vocab=4).dtype == torch.int32


def test_engine_recycles_slots():
    """The reference's test_serving_engine_end_to_end, on one layer."""
    cfg = reduced(get_config, n_layers=1)
    from repro_torch.models.model import init_params

    eng = ServingEngine(cfg, init_params(cfg, device=CPU), batch_slots=2, max_len=32, eos=-1)
    assert eng.submit(Request(rid=1, prompt=np.asarray([1, 2, 3]), max_new=4))
    assert eng.submit(Request(rid=2, prompt=np.asarray([4, 5]), max_new=3))
    assert not eng.submit(Request(rid=9, prompt=np.asarray([6]), max_new=1))
    emitted = []
    for _ in range(6):
        emitted += eng.step()
    assert {r for r, _ in emitted} == {1, 2}
    assert all(0 <= t < cfg.vocab for _, t in emitted)
    assert eng.submit(Request(rid=3, prompt=np.asarray([7]), max_new=2))


def test_serve_main_runs_on_cpu(capsys):
    before = launch_counts()
    assert serve.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "served 6 requests, 96 tokens" in out and "tok/s on cpu" in out
    rep = serve.run(["--device", "cpu", "--requests", "3", "--max-new", "4"])
    assert rep["finished"] == rep["requests"] == 3 and rep["tokens"] == 12
    assert rep["decode_calls"] > rep["steps"] > 0
    assert launch_counts() == before  # serving runs no kernel


def test_serve_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.run([])


def test_serve_refuses_an_unported_arch():
    with pytest.raises(SystemExit):
        serve.run(["--arch", "whisper-medium", "--device", "cpu"])
