"""Hysteresis policy: turning a noisy hint stream into calm decisions —
the port's copy of ``ptype_tpu/reconciler/policy.py``.

The gateway's :class:`~ptype_tpu_torch.gateway.slo.ScaleHint` is computed
per poll from windowed stats, so it FLAPS: a queue hovering at half
depth emits grow/steady/grow/steady, and a fleet at the shrink
threshold alternates shrink hints with steady ones. Acting on every
hint would thrash — spawn, drain, spawn — which is strictly worse
than holding, because every churn costs a prefill-cold replica and a
drain window. This module is the pure decision math between hints and
actions (unit-testable with no cluster, no clock — callers pass
``now``):

- **margin voting** — a decision needs the winning direction to LEAD
  the opposite one by at least ``margin`` votes among the last
  ``window`` observations (with at least ``quorum`` votes seen). A
  flapping stream — alternating or near-balanced — never builds a
  margin whatever its phase, so the count holds steady; a plain
  more-than-half rule fails this, because any odd slice of a strict
  alternation has a one-vote "majority" for whichever sign started
  it;
- **urgency ranking** — a shed-class hint (the gateway is actively
  refusing traffic) outranks any idle-shrink votes in the window and
  bypasses the quorum: capacity that is provably short must not wait
  for consensus while the SLO budget burns;
- **cooldown** — after any transition, further decisions are
  suppressed for ``cooldown_s``: whatever the hint stream does, at
  most ONE transition per cooldown window, which bounds churn even
  when the voting window is fooled;
- **min/max bounds** — the decision is clamped so the fleet can never
  scale below ``min_replicas`` (availability floor) or above
  ``max_replicas`` (budget ceiling).

The policy never actuates: the reconciler owns spawning and draining
(and its drain-deadline escalation); this class owns only "should the
fleet change size, and by how much".
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ScaleDecision:
    """One policy output: change the fleet by ``delta`` replicas."""

    delta: int
    reason: str
    #: A shed-class hint forced this (skip-the-queue semantics at the
    #: actuation layer too: prefer warm-pool activation over spawn).
    urgent: bool = False
    #: The vote tally that carried the decision (debuggability: the
    #: KVLogger line and the reconcile span both carry it).
    votes: dict = field(default_factory=dict)


#: Hint-reason substrings that mark a vote URGENT: the gateway is
#: actively shedding (or its admission queue is about to force it to).
#: An urgent up-vote outranks every down-vote in the window and skips
#: the quorum — but never the cooldown.
URGENT_REASONS = ("shed",)


class HysteresisPolicy:
    """Majority-vote + cooldown hysteresis over a scale-hint stream.

    ``observe`` is the whole surface: feed it every hint (or
    alert-derived synthetic hint) with the CURRENT replica count and a
    monotonic ``now``; it returns a :class:`ScaleDecision` when the
    window earns one, else None. State is a bounded vote deque plus
    the last-transition stamp — no threads, no clock reads.
    """

    def __init__(self, min_replicas: int = 1, max_replicas: int = 8,
                 cooldown_s: float = 30.0, window: int = 5,
                 quorum: int = 3, margin: int = 2,
                 vote_ttl_s: float | None = None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas must be >= 1, "
                             f"got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.cooldown_s = float(cooldown_s)
        self.window = int(window)
        self.quorum = int(quorum)
        self.margin = int(margin)
        #: Votes older than this never count (default: one cooldown —
        #: a stale burst from before a quiet stretch must not combine
        #: with one fresh hint into a phantom margin; a zero cooldown
        #: means no expiry, not instant expiry).
        self.vote_ttl_s = (float(vote_ttl_s) if vote_ttl_s is not None
                           else self.cooldown_s or float("inf"))
        #: (now, sign, |delta|, reason, urgent) — newest last.
        self._votes: list[tuple[float, int, int, str, bool]] = []
        self._last_transition = float("-inf")

    # -------------------------------------------------------------- input

    def observe(self, hint, n_replicas: int,
                now: float) -> ScaleDecision | None:
        """Fold one hint; return a decision when one is earned.

        ``hint`` needs only ``delta`` and ``reason`` attributes (a
        :class:`~ptype_tpu_torch.gateway.slo.ScaleHint`, or anything
        duck-shaped — the reconciler synthesizes votes from health
        alerts the same way). Steady hints (delta == 0) are real
        votes: they dilute a majority, which is exactly how a
        marginal signal fails to act."""
        delta = int(hint.delta)
        reason = str(hint.reason)
        urgent = delta > 0 and any(u in reason for u in URGENT_REASONS)
        sign = (delta > 0) - (delta < 0)
        self._votes.append((now, sign, abs(delta), reason, urgent))
        cut = now - self.vote_ttl_s
        self._votes = [v for v in self._votes
                       if v[0] >= cut][-self.window:]
        return self._decide(int(n_replicas), now)

    def in_cooldown(self, now: float) -> bool:
        return now - self._last_transition < self.cooldown_s

    # ----------------------------------------------------------- decision

    def _decide(self, n_replicas: int,
                now: float) -> ScaleDecision | None:
        if self.in_cooldown(now):
            return None
        votes = list(self._votes)
        up = [v for v in votes if v[1] > 0]
        down = [v for v in votes if v[1] < 0]
        urgent_up = [v for v in up if v[4]]
        tally = {"up": len(up), "down": len(down),
                 "steady": len(votes) - len(up) - len(down),
                 "urgent": len(urgent_up), "window": len(votes)}
        lead = len(up) - len(down)
        direction = 0
        if urgent_up:
            # Shed-burst outranks idle-shrink: capacity is PROVABLY
            # short (requests are being refused) — down-votes in the
            # same window are a stale utilization reading.
            direction, basis = 1, urgent_up[-1]
        elif len(votes) >= self.quorum and lead >= self.margin:
            direction, basis = 1, up[-1]
        elif len(votes) >= self.quorum and -lead >= self.margin:
            direction, basis = -1, down[-1]
        if direction == 0:
            return None
        if direction > 0:
            # Grow by the largest step the winning votes asked for
            # (the gateway sizes its delta to the standing queue).
            magnitude = max(v[2] for v in (urgent_up or up))
        else:
            # Shrink ONE replica at a time whatever the votes say:
            # shrinking is cheap to repeat and expensive to overdo (a
            # too-deep shrink pays a spawn to undo).
            magnitude = 1
        target = max(self.min_replicas,
                     min(self.max_replicas,
                         n_replicas + direction * magnitude))
        delta = target - n_replicas
        if delta == 0:
            return None  # bounds ate the whole step: no transition
        self._last_transition = now
        self._votes.clear()
        return ScaleDecision(delta=delta, reason=basis[3],
                             urgent=bool(urgent_up), votes=tally)
