from repro_torch.core.claims import (  # noqa: F401
    CacheIdentity,
    ClaimMode,
    ClaimRegistry,
    ClaimRejected,
    ClaimState,
    InvalidClaimTransition,
    MaterializationPredicate,
    ResidentClaim,
)
from repro_torch.core.events import E, EventLog  # noqa: F401
