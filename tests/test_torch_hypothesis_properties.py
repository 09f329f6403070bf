"""tests/test_hypothesis_properties.py held against the port.

Two of the JAX package's hypothesis properties, on the port:

* the flash-attention property: over randomly drawn GQA / window /
  odd-length configs, the port's K5 route on a CPU tensor (its plain
  version) equals the reference's oracle ``ref.flash_attention_ref``
  (float32, 2e-5: the reference test's tolerance; the reference test
  holds its Pallas kernel to the same oracle), and the tiled model of the
  tensor-core kernel's arithmetic equals the plain version (weights kept
  in f32, 2e-5);
* the claim state machine: no sequence of transitions reaches an outcome
  state off the legal edges; each drawn transition is legal in the port
  exactly when it is legal in the reference, and both claims end in the
  same state.

The MoE dispatch invariant is held in tests/test_torch_moe.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from repro_torch.kernels import flash_attention as fa  # noqa: E402
from torch_one_thread import one_torch_thread  # noqa: F401  (autouse fixture)


@settings(max_examples=10, deadline=None)
@given(
    seq=st.integers(9, 48),
    kv=st.sampled_from([1, 2]),
    g=st.integers(1, 3),
    window=st.sampled_from([0, 8]),
)
def test_flash_attention_property(seq, kv, g, window):
    rng = np.random.default_rng(seq * 100 + kv * 10 + g)
    H, D = kv * g, 16
    draws = [rng.normal(size=s).astype(np.float32)
             for s in ((1, H, seq, D), (1, kv, seq, D), (1, kv, seq, D))]
    jargs = [jnp.asarray(a) for a in draws]
    targs = [torch.from_numpy(a) for a in draws]
    got = fa.flash_attention(*targs, causal=True, window=window).numpy()
    expect = np.asarray(ref.flash_attention_ref(*jargs, causal=True, window=window))
    np.testing.assert_allclose(got, expect, rtol=2e-5, atol=2e-5)
    tiled = fa.flash_attention_tiled_ref(*targs, causal=True, window=window, block_k=16,
                                         p_dtype=torch.float32)
    np.testing.assert_allclose(tiled.numpy(), got, rtol=2e-5, atol=2e-5)


def _claim(claims):
    return claims.ResidentClaim(
        claim_id="c", object_id="o",
        predicate=claims.MaterializationPredicate("leading_prefix_at_least", 4),
        mode=None, cache_identity=claims.CacheIdentity("m", "t"),
    )


@settings(max_examples=20, deadline=None)
@given(data=st.data())
def test_claim_state_machine_never_skips_acceptance(data):
    import repro.core.claims as jc
    import repro_torch.core.claims as tc

    assert {s.value: sorted(t.value for t in ts) for s, ts in tc._TRANSITIONS.items()} == \
        {s.value: sorted(t.value for t in ts) for s, ts in jc._TRANSITIONS.items()}
    port, want = _claim(tc), _claim(jc)
    for _ in range(data.draw(st.integers(1, 6))):
        target = data.draw(st.sampled_from([s.value for s in tc.ClaimState]))
        legal = tc.ClaimState(target) in tc._TRANSITIONS[port.state]
        assert legal == (jc.ClaimState(target) in jc._TRANSITIONS[want.state])
        if legal:
            port.transition(tc.ClaimState(target))
            want.transition(jc.ClaimState(target))
        else:
            with pytest.raises(tc.InvalidClaimTransition):
                port.transition(tc.ClaimState(target))
            with pytest.raises(jc.InvalidClaimTransition):
                want.transition(jc.ClaimState(target))
        assert port.state.value == want.state.value
