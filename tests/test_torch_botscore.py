"""The bot-score head (models/botscore.py) in the port, against the JAX
package's `models/botscore.py`.

  * `extract_features` is bit-equal on `generate_traffic` batches of the
    reference's seeds and on empty, long (past the field's capacity)
    and non-ASCII user agents.
  * `score` agrees within 1e-6 from `params_from_reference` of the JAX
    package's `init_params(PRNGKey(seed))`.
  * The npz weights load both ways between the packages.
  * Ten AdamW steps of each package from the same weights and features
    agree within 1e-5 (optax.adamw's defaults on torch.optim.AdamW).
  * VerdictService(bot_score_params=) gives every request the JAX
    package's service's score within 1e-5 (the reference test's bound)
    under PINGOO_PIPELINE=off, on with full and with compact staging,
    and PINGOO_MEGASTEP=force, and the same verdicts as without the
    head; `score_errors` stays 0, and a scorer failure serves 0.0 and is
    counted, as in the JAX package.

CPU only, small batches.
"""

import asyncio
import dataclasses

import jax
import numpy as np
import pytest
import torch

from pingoo_tpu.compiler import compile_ruleset as ref_compile
from pingoo_tpu.config.schema import Action as RefAction
from pingoo_tpu.config.schema import RuleConfig as RefRuleConfig
from pingoo_tpu.engine import encode_requests as ref_encode
from pingoo_tpu.engine.batch import RequestTuple as RefRequestTuple
from pingoo_tpu.engine.service import VerdictService as RefVerdictService
from pingoo_tpu.expr import compile_expression as ref_compile_expression
from pingoo_tpu.models import botscore as ref_bot
from pingoo_tpu.utils.crs import generate_traffic as ref_generate_traffic
from pingoo_tpu_torch.compiler.plan import compile_ruleset
from pingoo_tpu_torch.config.schema import Action, RuleConfig
from pingoo_tpu_torch.engine.batch import (RequestTuple, batch_tensors,
                                           encode_requests)
from pingoo_tpu_torch.engine.service import VerdictService
from pingoo_tpu_torch.expr import compile_expression
from pingoo_tpu_torch.models import botscore
from torch_ledgers import cost_ledger_per_module, cost_ledger_per_test  # noqa: F401

torch.set_num_threads(1)

SEEDS = (7, 1234, 999983, 31337, 2026)
CLEARED_ENV = ("PINGOO_PIPELINE", "PINGOO_PIPELINE_DEPTH", "PINGOO_STAGING",
               "PINGOO_STAGING_DEPTH", "PINGOO_MEGASTEP", "PINGOO_MEGASTEP_K",
               "PINGOO_DFA", "PINGOO_PREFILTER", "PINGOO_SCHED_PIPELINE",
               "PINGOO_PARITY_SAMPLE", "PINGOO_CHAOS", "PINGOO_MESH")
RULES = ('http_request.path.starts_with("/admin")',
         'http_request.path == "/login"',
         'http_request.method == "POST"')
EXECUTORS = {"off": {"PINGOO_PIPELINE": "off"},
             "on": {"PINGOO_PIPELINE": "on"},
             "compact": {"PINGOO_PIPELINE": "on", "PINGOO_STAGING": "compact"},
             "force": {"PINGOO_PIPELINE": "on", "PINGOO_MEGASTEP": "force"}}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for name in CLEARED_ENV:
        monkeypatch.delenv(name, raising=False)


def as_port(reqs):
    return [RequestTuple(**{f.name: getattr(r, f.name)
                            for f in dataclasses.fields(RequestTuple)})
            for r in reqs]


def edge_requests():
    """User agents empty, past the 256-byte capacity, non-ASCII (and
    outside latin-1), and every byte class; paths with slashes, dots and
    percent signs; odd methods, countries, ASNs and ports."""
    uas = ["", "x" * 300, "Mozilla/5.0 (é; ü) ÆØÅ", "bot 中文 ☃",
           "0123456789ABCDEFabcdef !\"#$%&'()*+,-./", "A" * 256, "a"]
    return [RequestTuple(user_agent=ua, path=f"/a/b.c/%2e{i}" * (i + 1),
                         url=f"/a/b.c/%2e{i}?q={i}", host="h" * (3 * i),
                         method=("GET", "POST", "PROPFIND", "")[i % 4],
                         country=("US", "XX", "FR", "")[i % 4],
                         asn=(0, 1, 2**31 - 1, 4294967295, 2**40 + 7)[i % 5],
                         remote_port=(0, 443, 65535)[i % 3])
            for i, ua in enumerate(uas)]


def ref_params(seed):
    return ref_bot.init_params(jax.random.PRNGKey(seed))


def port_params(params):
    return botscore.params_from_reference(*map(np.asarray, params),
                                          device="cpu")


@pytest.mark.parametrize("seed", SEEDS)
def test_features_equal_the_reference(seed):
    reqs = ref_generate_traffic(64, attack_fraction=0.3, seed=seed)
    want = np.asarray(ref_bot.extract_features(ref_encode(reqs).arrays))
    got = botscore.extract_features(batch_tensors(
        encode_requests(as_port(reqs)).arrays, "cpu")).numpy()
    assert got.shape == (64, botscore.NUM_FEATURES) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_features_of_edge_user_agents_equal_the_reference():
    reqs = edge_requests()
    ref_reqs = [RefRequestTuple(**dataclasses.asdict(r)) for r in reqs]
    want = np.asarray(ref_bot.extract_features(ref_encode(ref_reqs).arrays))
    got = botscore.extract_features(batch_tensors(
        encode_requests(reqs).arrays, "cpu")).numpy()
    np.testing.assert_array_equal(got, want)
    # The empty user agent sets its flag; every one-hot has one bit.
    assert got[0, 4] == 1.0 and (got[1:, 4] == 0.0).all()
    for lo, n in ((13, 8), (21, 16), (37, 8)):
        np.testing.assert_array_equal(got[:, lo:lo + n].sum(axis=1), 1.0)


@pytest.mark.parametrize("seed", SEEDS)
def test_score_equals_the_reference(seed):
    params = ref_params(seed)
    reqs = ref_generate_traffic(64, attack_fraction=0.5, seed=seed)
    want = np.asarray(ref_bot.score(params, ref_encode(reqs).arrays))
    got = botscore.score(port_params(params), batch_tensors(
        encode_requests(as_port(reqs)).arrays, "cpu")).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert ((got >= 0) & (got <= 1)).all()


def test_npz_round_trip_both_ways(tmp_path):
    reqs = ref_generate_traffic(16, seed=SEEDS[0])
    ref_arrays = ref_encode(reqs).arrays
    arrays = batch_tensors(encode_requests(as_port(reqs)).arrays, "cpu")
    ref_p = ref_params(SEEDS[1])
    ref_bot.save_params(ref_p, str(tmp_path / "ref.npz"))
    loaded = botscore.load_params(str(tmp_path / "ref.npz"), device="cpu")
    for a, b in zip(loaded, ref_p):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    port_p = botscore.init_params(torch.Generator().manual_seed(SEEDS[2]),
                                  device="cpu")
    botscore.save_params(port_p, str(tmp_path / "port.npz"))
    back = ref_bot.load_params(str(tmp_path / "port.npz"))
    for a, b in zip(port_p, back):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_allclose(
        botscore.score(port_p, arrays).numpy(),
        np.asarray(ref_bot.score(back, ref_arrays)), rtol=0, atol=1e-6)


def test_train_steps_equal_the_reference():
    clean = ref_generate_traffic(64, attack_fraction=0.0, seed=SEEDS[3])
    bots = ref_generate_traffic(64, attack_fraction=1.0, seed=SEEDS[4])
    reqs = clean + bots
    labels = np.array([0.0] * 64 + [1.0] * 64, dtype=np.float32)
    ref_feats = ref_bot.extract_features(ref_encode(reqs).arrays)
    feats = botscore.extract_features(batch_tensors(
        encode_requests(as_port(reqs)).arrays, "cpu"))
    ref_p = ref_params(SEEDS[0])
    p = port_params(ref_p)
    tx, step = ref_bot.make_train_step(1e-2)
    ref_state = tx.init(ref_p)
    step = jax.jit(step)
    ptx, pstep = botscore.make_train_step(1e-2)
    state = ptx.init(p)
    for _ in range(10):
        ref_p, ref_state, ref_loss = step(ref_p, ref_state, ref_feats, labels)
        p, state, loss = pstep(p, state, feats, torch.from_numpy(labels))
        assert abs(float(loss) - float(ref_loss)) < 1e-5
    for a, b in zip(p, ref_p):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)


@pytest.fixture(scope="module")
def plans():
    ref = ref_compile([RefRuleConfig(name=f"r{i}", actions=(RefAction.BLOCK,),
                                     expression=ref_compile_expression(src))
                       for i, src in enumerate(RULES)], {})
    port = compile_ruleset([RuleConfig(name=f"r{i}", actions=(Action.BLOCK,),
                                       expression=compile_expression(src))
                            for i, src in enumerate(RULES)], {},
                           device="cpu")
    return ref, port


def serve(service, reqs):
    async def run():
        await service.start()
        try:
            return await asyncio.gather(*map(service.evaluate, reqs))
        finally:
            await service.stop()
    return asyncio.run(run())


def service_requests():
    reqs = ref_generate_traffic(48, attack_fraction=0.4, seed=SEEDS[1])
    return reqs + [RefRequestTuple(**dataclasses.asdict(r))
                   for r in edge_requests()]


@pytest.mark.parametrize("arm", sorted(EXECUTORS))
def test_service_scores_equal_the_reference(plans, monkeypatch, arm):
    ref, port = plans
    for name, value in EXECUTORS[arm].items():
        monkeypatch.setenv(name, value)
    params = ref_params(SEEDS[2])
    ref_reqs = service_requests()
    want = serve(RefVerdictService(ref, {}, use_device=True, max_batch=16,
                                   max_wait_us=200, bot_score_params=params),
                 ref_reqs)
    reqs = as_port(ref_reqs)
    service = VerdictService(port, {}, max_batch=16, max_wait_us=200,
                             device="cpu",
                             bot_score_params=port_params(params))
    if arm == "compact":
        # The user agent's cap is narrower than the long agents, whose
        # fractions then divide a capped count by the true length.
        assert service.stage_caps["user_agent"] < 300
    got = serve(service, reqs)
    plain = serve(VerdictService(port, {}, max_batch=16, max_wait_us=200,
                                 device="cpu"), reqs)
    np.testing.assert_allclose([v.bot_score for v in got],
                               [v.bot_score for v in want], rtol=0,
                               atol=1e-5)
    assert len({round(v.bot_score, 6) for v in got}) > 10
    assert [v.action for v in got] == [v.action for v in plain] \
        == [v.action for v in want]
    np.testing.assert_array_equal(np.stack([v.matched for v in got]),
                                  np.stack([v.matched for v in plain]))
    assert all(v.bot_score == 0.0 for v in plain)
    assert service.stats.snapshot()["score_errors"] == 0


def test_explain_carries_the_score(plans):
    _, port = plans
    params = botscore.init_params(torch.Generator().manual_seed(5),
                                  device="cpu")
    service = VerdictService(port, {}, max_batch=8, device="cpu",
                             bot_score_params=params)
    req = RequestTuple(path="/admin/x", url="/admin/x", user_agent="curl/8")

    async def run():
        await service.start()
        try:
            return await service.evaluate(req), await service.explain(req)
        finally:
            await service.stop()

    verdict, payload = asyncio.run(run())
    assert payload["bot_score"] == verdict.bot_score > 0.0
    assert payload["action"] == verdict.action == 1


def test_scorer_failure_fails_the_batch(plans, monkeypatch):
    """A broken head fails no verdict: as in the JAX package the batch is
    served with a score of 0.0 and `score_errors` counts the failure; the
    next batch is scored. A kernel build failure still fails the batch."""
    from pingoo_tpu_torch.ops._build import KernelBuildError

    _, port = plans
    params = botscore.init_params(torch.Generator().manual_seed(6),
                                  device="cpu")
    service = VerdictService(port, {}, max_batch=8, device="cpu",
                             bot_score_params=params)
    real = botscore.score

    def broken(*args):
        raise RuntimeError("scorer lost")

    def unbuilt(*args):
        raise KernelBuildError("nvcc exited 2")

    async def run():
        await service.start()
        try:
            monkeypatch.setattr(botscore, "score", broken)
            lost = await service.evaluate(RequestTuple(path="/x"))
            monkeypatch.setattr(botscore, "score", unbuilt)
            with pytest.raises(KernelBuildError, match="nvcc"):
                await service.evaluate(RequestTuple(path="/x"))
            monkeypatch.setattr(botscore, "score", real)
            return lost, await service.evaluate(RequestTuple(path="/x"))
        finally:
            await service.stop()

    lost, verdict = asyncio.run(run())
    assert lost.bot_score == 0.0 and lost.action == verdict.action
    assert 0.0 < verdict.bot_score < 1.0
    assert service.stats.snapshot()["score_errors"] == 1
