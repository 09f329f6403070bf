"""The controls of tests/test_witness_paths.py, held against the port (CPU).

Each control of the JAX package's witness-path tests runs on the JAX
``ServingEngine`` and on the port's (reduced qwen3-1.7b, the same float32
parameters bridged by ``params_from_jax``), keeps the reference test's own
assertions on both, and the two runs' observations must be equal
(``test_torch_failure_paths.observe``: the projected ordered events,
``fail_closed_total``, statuses, errors, output tokens, claim states and
the pool's refcounts).  The controls are the ones the paper's 0/41
false-positive count is made of, plus the mode boundaries: ordinary
offload without a claim, an unclaimed failure, a wrong-claim failure, the
sliding-window acceptance check, expiry, demotion, hard-protection victim
exclusion and soft-priority order.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_config, reduced
from repro.core.claims import ClaimRejected as JClaimRejected
from repro.models.registry import build_model as jax_build_model
from repro.serving.engine import ServingEngine as JaxEngine
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch.core.claims import ClaimRejected
from repro_torch.models.registry import build_model
from repro_torch.params import params_from_jax
from repro_torch.serving.engine import ServingEngine
from test_torch_failure_paths import PREFIX, both, observe, pkgs  # noqa: F401  (fixture)
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)


def _offload_cycle(pkg, eng, fail=False):
    """accept -> materialize (via request) -> offload -> reuse request."""
    claim = eng.accept_claim(PREFIX, pkg.ClaimMode.OFFLOADABLE)
    r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=2)
    eng.run(r1)
    assert r1.status == "finished"
    assert claim.state == pkg.ClaimState.MATERIALIZED
    assert eng.offload_claim(claim.claim_id, request_id=r1.request_id)
    assert claim.state == pkg.ClaimState.OFFLOADED
    if fail:
        eng.connector.injection.resident_claim_load_failure = True
        eng.connector.injection.fail_claim_id = claim.claim_id
    r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=2)
    eng.run(r2)
    return claim, r1, r2


def _ordinary_offload(pkg, eng):
    r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
    eng.run(r1)
    blocks = eng.pool.lookup_prefix(PREFIX, eng.block_size)
    job = eng.connector.store(blocks, claim_id=None, request_id=r1.request_id)
    eng.connector.complete_job(job)
    r2 = eng.submit(PREFIX + (40, 41), max_new_tokens=1)
    eng.run(r2)
    return r1, r2


def _control_ordinary_offload(pkg):
    """Offload machinery used with NO accepted claim -> zero claim outcomes."""
    with pkg.make() as eng:
        r1, r2 = _ordinary_offload(pkg, eng)
        assert r2.status == "finished"
        v = pkg.analyzer.check_no_claim_outcome(eng.events)
        assert v.passed, v.reasons
        return observe(eng, [r1, r2], verdict=v.passed)


def test_control_ordinary_offload_without_claim(pkgs):
    both(pkgs, _control_ordinary_offload)


def _control_unclaimed_failure(pkg):
    inj = pkg.offload.FailureInjectionConfig(unclaimed_generic_failure=True)
    with pkg.make(injection=inj) as eng:
        r1, r2 = _ordinary_offload(pkg, eng)
        assert r2.status == "error"  # the request fails...
        # ...but with NO claim-scoped scheduler outcome
        assert not eng.events.named("scheduler_resident_claim_restoration_failed")
        assert not eng.events.named("scheduler_active_request_refused")
        return observe(eng, [r1, r2])


def test_control_unclaimed_failure_is_not_claim_outcome(pkgs):
    both(pkgs, _control_unclaimed_failure)


def _control_wrong_claim(pkg):
    """A failure injected on claim X must not satisfy path B for claim Y."""
    with pkg.make() as eng:
        claim, r1, r2 = _offload_cycle(pkg, eng, fail=True)
        other = eng.accept_claim(tuple(range(300, 316)), pkg.ClaimMode.OFFLOADABLE)
        v = pkg.analyzer.check_failure_outcome_path(eng.events, other.claim_id, r2.request_id)
        assert not v.passed
        right = pkg.analyzer.check_failure_outcome_path(eng.events, claim.claim_id, r2.request_id)
        assert right.passed, right.reasons
        return observe(eng, [r1, r2], [claim, other], verdict=(v.passed, list(v.reasons)))


def test_control_wrong_claim_failure_rejected(pkgs):
    both(pkgs, _control_wrong_claim)


@pytest.fixture(scope="module")
def danube():
    """Reduced h2o-danube-1.8b (sliding window) engines in both packages,
    over the same float32 parameters."""
    cfg = reduced(get_config("h2o-danube-1.8b"))
    jb = jax_build_model(cfg)
    jp = jax.tree.map(lambda a: a.astype("float32"), jb.init_params(jax.random.PRNGKey(0)))
    tb = build_model(t_reduced(t_get_config("h2o-danube-1.8b")), device="cpu")
    tp = params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(block_size=4, device_blocks=32, cache_len=32)
    return cfg, {"jax": (lambda: JaxEngine(jb, jp, **kw), JClaimRejected),
                 "port": (lambda: ServingEngine(tb, tp, device="cpu", **kw), ClaimRejected)}


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_acceptance_fails_closed_on_window(pkgs, danube, pkg):
    """SWA arch: a leading-prefix claim deeper than the window is rejected,
    in both packages, with no claim registered; one within the window is
    accepted."""
    cfg, engines = danube
    make, rejected = engines[pkg]
    with make() as eng:
        deep = tuple(range(cfg.sliding_window + 4))
        with pytest.raises(rejected):
            eng.accept_claim(deep, pkgs[pkg].ClaimMode.OFFLOADABLE, predicate_k=len(deep))
        assert not eng.events.named("resident_claim_accepted")
        shallow = tuple(range(cfg.sliding_window - 4))
        eng.accept_claim(shallow, pkgs[pkg].ClaimMode.OFFLOADABLE, predicate_k=len(shallow))
        assert len(eng.events.named("resident_claim_accepted")) == 1


def _expiry(pkg):
    with pkg.make() as eng:
        claim = eng.accept_claim(PREFIX, pkg.ClaimMode.EXPIRING, duration_s=0.0)
        r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
        eng.run(r1)
        eng.scheduler.sweep_expiry()
        assert claim.state == pkg.ClaimState.EXPIRED
        exp = eng.events.named("resident_claim_expired")
        assert exp and exp[0].claim_id == claim.claim_id
        # post-expiry loss is non-responsibility: evicting now emits no harm
        eng.scheduler.apply_pressure(2)
        assert not eng.events.named("resident_claim_harmed")
        return observe(eng, [r1], [claim])


def test_expiry_boundary_before_loss(pkgs):
    both(pkgs, _expiry)


def _demotion(pkg):
    with pkg.make() as eng:
        claim = eng.accept_claim(PREFIX, pkg.ClaimMode.DEMOTABLE)
        r1 = eng.submit(PREFIX + (30, 31), max_new_tokens=1)
        eng.run(r1)
        eng.scheduler.apply_pressure(2)
        demote = eng.events.named("resident_claim_demoted")
        evict = eng.events.named("pressure_eviction")
        assert demote and evict
        assert demote[0].seq < evict[0].seq, "demotion must be ordered BEFORE loss"
        assert claim.state == pkg.ClaimState.DEMOTED
        return observe(eng, [r1], [claim])


def test_demotion_before_loss(pkgs):
    both(pkgs, _demotion)


def _hard_protection(pkg):
    with pkg.make(device_blocks=8) as eng:
        claim = eng.accept_claim(PREFIX, pkg.ClaimMode.HARD_PROTECTED)
        r1 = eng.submit(PREFIX, max_new_tokens=1)
        eng.run(r1)
        # 4 protected blocks of 8: a request needing more than 4 new blocks
        # hits the active/resident conflict -> explicit refusal
        r2 = eng.submit(tuple(range(500, 532)), max_new_tokens=4)
        eng.run(r2)
        assert r2.status == "refused"
        refusals = eng.events.named("scheduler_admission_refused")
        assert refusals and claim.claim_id in refusals[0].payload["blocking_claim_ids"]
        assert eng.events.named("allocator_victim_excluded"), "victim exclusion must be evidenced"
        assert claim.state == pkg.ClaimState.MATERIALIZED
        return observe(eng, [r1, r2], [claim])


def test_hard_protection_victim_exclusion(pkgs):
    both(pkgs, _hard_protection)


def _soft_priority(pkg):
    """Controlled pressure: the lower-priority claim's blocks go first."""
    with pkg.make() as eng:
        hi_prefix, lo_prefix = tuple(range(600, 616)), tuple(range(700, 716))
        hi = eng.accept_claim(hi_prefix, pkg.ClaimMode.SOFT_PRIORITY, priority=5)
        lo = eng.accept_claim(lo_prefix, pkg.ClaimMode.SOFT_PRIORITY, priority=1)
        reqs = [eng.run(eng.submit(pfx, max_new_tokens=1)) for pfx in (hi_prefix, lo_prefix)]
        eng.scheduler.apply_pressure(4)
        # claimless decode-tail partials (priority 0) are lost before any
        # claim-covered block; among claim-covered blocks the lower
        # priority's go first
        claimed = [e.claim_id for e in eng.events.named("pressure_eviction")
                   if e.claim_id is not None]
        assert claimed and all(c == lo.claim_id for c in claimed[:2]), claimed
        return observe(eng, reqs, [hi, lo], claimed=claimed)


def test_soft_priority_pressure_order(pkgs):
    both(pkgs, _soft_priority)
