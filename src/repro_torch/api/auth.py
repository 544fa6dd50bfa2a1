"""TrustAuthority: token auth + per-contributor rate quotas for the
gateway (trust plane, gateway layer).

A hub operator issues bearer tokens per contributor; an auth-enabled
``HubGateway`` asks the authority to ``admit`` every request BEFORE it
touches any ``JobRepo``.  Admission answers in trust-plane error codes —
``unauthorized`` (missing / revoked token, banned contributor) or
``quota_exceeded`` (token-bucket empty) — which the gateway turns into
typed error envelopes, never exceptions.

Quotas are per CONTRIBUTOR, not per token: all of a contributor's tokens
drain one shared ``TokenBucket``, so re-issuing tokens does not multiply
the allowance.  The clock is injectable (monotonic seconds) so tests and
replays drive admission deterministically.
"""
from __future__ import annotations

import math
import secrets
import time
from typing import Callable, Dict, Optional, Tuple

from repro_torch.api.types import ERR_QUOTA_EXCEEDED, ERR_UNAUTHORIZED
from repro_torch.core.trust import TokenBucket


class TrustAuthority:
    """Issues/revokes contributor tokens and meters per-contributor quotas.

    ``rate`` is the sustained allowance in requests/second, ``burst`` the
    bucket capacity (how far a contributor can run ahead of the sustained
    rate).  ``clock`` must be monotonic; it defaults to
    ``time.monotonic``.
    """

    def __init__(self, *, rate: float = 50.0, burst: float = 100.0,
                 clock: Callable[[], float] = time.monotonic):
        if rate <= 0 or burst <= 0:
            raise ValueError("rate and burst must be positive")
        self.rate = float(rate)
        self.burst = float(burst)
        self._clock = clock
        self._tokens: Dict[str, str] = {}        # token -> contributor id
        self._buckets: Dict[str, TokenBucket] = {}
        self._banned: set = set()
        self._operators: set = set()

    # ------------------------- admin surface ------------------------------
    def issue_token(self, contributor_id: str) -> str:
        """Mint a bearer token for ``contributor_id`` (one contributor may
        hold several; they share one quota bucket)."""
        cid = str(contributor_id)
        if not cid:
            raise ValueError("contributor_id must be non-empty")
        token = secrets.token_hex(16)
        self._tokens[token] = cid
        return token

    def revoke_token(self, token: str) -> bool:
        """Invalidate one token; returns whether it was active."""
        return self._tokens.pop(token, None) is not None

    def ban(self, contributor_id: str) -> None:
        """Refuse ALL of this contributor's tokens until ``unban``."""
        self._banned.add(str(contributor_id))

    def unban(self, contributor_id: str) -> bool:
        cid = str(contributor_id)
        if cid in self._banned:
            self._banned.remove(cid)
            return True
        return False

    def grant_operator(self, contributor_id: str) -> None:
        """Mark a contributor as a hub OPERATOR: authorized for store
        lifecycle operations (``CompactRequest``) on an auth-enabled
        gateway.  Operator standing rides the same token auth — the
        contributor still needs an issued token; this only widens what an
        admitted identity may do."""
        cid = str(contributor_id)
        if not cid:
            raise ValueError("contributor_id must be non-empty")
        self._operators.add(cid)

    def revoke_operator(self, contributor_id: str) -> bool:
        """Withdraw operator standing; returns whether it was held."""
        cid = str(contributor_id)
        if cid in self._operators:
            self._operators.remove(cid)
            return True
        return False

    # ------------------------- inspection ---------------------------------
    def identify(self, token: Optional[str]) -> Optional[str]:
        """Contributor id behind an active token, else None."""
        return None if token is None else self._tokens.get(token)

    def known(self, contributor_id: str) -> bool:
        """Does this contributor hold at least one active token?"""
        return str(contributor_id) in self._tokens.values()

    def is_banned(self, contributor_id: str) -> bool:
        return str(contributor_id) in self._banned

    def is_operator(self, contributor_id: str) -> bool:
        return str(contributor_id) in self._operators

    def quota_remaining(self, contributor_id: str) -> float:
        """Tokens currently available in the contributor's bucket (the
        full ``burst`` for a contributor who has never been metered)."""
        bucket = self._buckets.get(str(contributor_id))
        if bucket is None:
            return self.burst
        return bucket.remaining(self._clock())

    # ------------------------- admission ----------------------------------
    def admit(self, token: Optional[str], cost: float = 1.0
              ) -> Tuple[Optional[str], str, str]:
        """Authenticate + meter one request.

        Returns ``(contributor_id, "", "")`` on admission, else
        ``(None, error_code, detail)`` with a trust-plane error code the
        gateway can put straight into an error envelope."""
        if token is None or not token:
            return None, ERR_UNAUTHORIZED, (
                "authentication required: wrap the request in an "
                "AuthedRequest carrying an issued token")
        cid = self._tokens.get(token)
        if cid is None:
            return None, ERR_UNAUTHORIZED, "unknown or revoked token"
        if cid in self._banned:
            return None, ERR_UNAUTHORIZED, f"contributor {cid!r} is banned"
        bucket = self._buckets.get(cid)
        if bucket is None:
            bucket = self._buckets[cid] = TokenBucket(self.rate, self.burst)
        if not bucket.admit(self._clock(), cost=cost):
            return None, ERR_QUOTA_EXCEEDED, (
                f"rate quota exhausted for contributor {cid!r} "
                f"(sustained {self.rate:g}/s, burst {self.burst:g})")
        return cid, "", ""


#: quota_remaining value reported by gateways WITHOUT an authority
UNMETERED = math.inf
