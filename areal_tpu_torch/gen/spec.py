"""Self-speculative decoding: prompt-lookup drafting and the draft-length
controller (the port's copy of `areal_tpu/gen/spec.py`, numpy only).

Two host-side pieces, both model-free:

* :func:`propose_draft`, the prompt-lookup (n-gram) drafter.  For a slot
  whose token history (prompt + generated, the pending last token
  included) ends in some n-gram, find the RIGHTMOST earlier occurrence of
  that n-gram and propose the tokens that followed it.  Math and code
  rollouts restate the prompt and loop over identifiers, so the
  continuation after a repeated n-gram is a strong guess, and drafting
  costs no model forward.

* :class:`SpecController` picks the draft length D from a small static
  ladder (default ``(0, 3, 7)``) by a windowed acceptance rate.  The
  ladder keeps the verify shapes few (one T = D + 1 a rung), so the
  kernel's gate is checked once, at the largest rung.

Correctness does not depend on the drafter or the controller: the verify
step samples every position with the counter-keyed sampler plain decode
uses (key = f(seed, stream, cache position)), so any draft, good, bad or
empty, yields the same output stream.  These pieces only decide how much
verification work is worth dispatching.
"""

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# Draft-length ladder: 0 = plain decode; each nonzero rung is one verify
# width T = D + 1.
DEFAULT_SPEC_LADDER: Tuple[int, ...] = (0, 3, 7)

# Windowed-acceptance thresholds: rate >= HI -> top of the ladder, >= LO ->
# the lowest nonzero rung, below -> plain decode (with periodic probing).
DEFAULT_ACCEPT_HI = 0.5
DEFAULT_ACCEPT_LO = 0.2
# A tier parked at D = 0 re-probes with a draft every N chunks, so a
# workload that turns repetitive mid-stream is detected again.
DEFAULT_PROBE_EVERY = 8
# Acceptance window: recent (drafted, accepted) pairs per tier.
DEFAULT_WINDOW = 16


def propose_draft(
    history: np.ndarray,
    max_draft: int,
    ngram_max: int = 3,
    ngram_min: int = 1,
) -> np.ndarray:
    """Prompt-lookup draft for one slot.

    ``history`` is the slot's full token history INCLUDING the pending last
    token (the one decode is about to attend from), as a 1-D int array.
    Tries suffix n-grams from ``ngram_max`` down to ``ngram_min``; for the
    first n with an earlier occurrence, returns up to ``max_draft`` tokens
    that followed the RIGHTMOST such occurrence with a full ``max_draft``
    continuation (falling back to the overall-rightmost occurrence when no
    match has that much follow-up).  Deterministic, and safe on empty or
    short histories (returns an empty draft).
    """
    h = np.asarray(history, dtype=np.int32).ravel()
    n_hist = h.shape[0]
    if max_draft <= 0 or n_hist < ngram_min + 1:
        return np.zeros((0,), dtype=np.int32)
    for n in range(min(ngram_max, n_hist - 1), ngram_min - 1, -1):
        suffix = h[n_hist - n:]
        # candidate starts: the occurrence ends before the suffix itself
        # and leaves at least one follow-up token to draft
        limit = n_hist - n  # exclusive upper bound on the start index
        if limit <= 0:
            continue
        windows = np.lib.stride_tricks.sliding_window_view(h[:limit + n - 1], n)
        matches = np.nonzero((windows == suffix).all(axis=1))[0]
        if matches.size == 0:
            continue
        # prefer the rightmost occurrence whose continuation fills the
        # whole draft: on a stream cycling with a period below max_draft,
        # the overall-rightmost match sits so close to the end of the
        # history that every draft would be cut to one period
        full = matches[matches + n + max_draft <= n_hist]
        i = int(full[-1] if full.size else matches[-1])
        draft = h[i + n: i + n + max_draft]
        if draft.size:
            return draft.astype(np.int32)
    return np.zeros((0,), dtype=np.int32)


class SpecController:
    """Per-tier draft-length selection from a windowed acceptance rate.

    Tracks (drafted, accepted) for the last ``window`` verify dispatches of
    each tier and maps the rate onto the ladder: ``rate >= hi`` -> the
    ladder's top, ``rate >= lo`` -> its lowest nonzero rung, else 0.  A
    tier parked at D = 0 drafts a probe every ``probe_every`` chunks so it
    can climb back.  It starts optimistic (the top): a fresh tier's first
    chunks carry no signal, and a wasted probe costs one verify dispatch.

    A pure speed policy: streams are the same for any choice of D at every
    chunk (see the module docstring), so tests may pin D while production
    adapts.
    """

    def __init__(
        self,
        ladder: Sequence[int] = DEFAULT_SPEC_LADDER,
        accept_hi: float = DEFAULT_ACCEPT_HI,
        accept_lo: float = DEFAULT_ACCEPT_LO,
        probe_every: int = DEFAULT_PROBE_EVERY,
        window: int = DEFAULT_WINDOW,
    ):
        lad = sorted(set(int(d) for d in ladder))
        if not lad or lad[0] < 0:
            raise ValueError(f"spec ladder must be non-negative: {ladder}")
        if lad[-1] == 0:
            raise ValueError("spec ladder needs at least one nonzero rung")
        self.ladder = tuple(lad)
        self.nonzero = tuple(d for d in lad if d > 0)
        self.accept_hi = float(accept_hi)
        self.accept_lo = float(accept_lo)
        self.probe_every = max(1, int(probe_every))
        self.window = max(1, int(window))
        # per tier: (drafted, accepted) pairs, newest last
        self._hist: Dict[int, List[Tuple[int, int]]] = {}
        self._idle_chunks: Dict[int, int] = {}

    def draft_len(self, tier: int) -> int:
        """Pick D for this tier's next chunk."""
        hist = self._hist.get(tier)
        if not hist:
            return self.nonzero[-1]  # optimistic start
        drafted = sum(d for d, _ in hist)
        accepted = sum(a for _, a in hist)
        if drafted <= 0:
            return self.nonzero[-1]
        rate = accepted / drafted
        if rate >= self.accept_hi:
            return self.nonzero[-1]
        if rate >= self.accept_lo:
            return self.nonzero[0]
        # parked: probe periodically so a newly repetitive stream re-climbs
        idle = self._idle_chunks.get(tier, 0)
        if idle + 1 >= self.probe_every:
            self._idle_chunks[tier] = 0
            return self.nonzero[0]
        self._idle_chunks[tier] = idle + 1
        return 0

    def record(self, tier: int, drafted: int, accepted: int) -> None:
        """Feed back one verify dispatch's totals for a tier."""
        if drafted <= 0:
            return
        hist = self._hist.setdefault(tier, [])
        hist.append((int(drafted), int(accepted)))
        if len(hist) > self.window:
            del hist[: len(hist) - self.window]

    def acceptance_rate(self, tier: int) -> Optional[float]:
        """Windowed acceptance rate for telemetry; None before any signal."""
        hist = self._hist.get(tier)
        if not hist:
            return None
        drafted = sum(d for d, _ in hist)
        if drafted <= 0:
            return None
        return sum(a for _, a in hist) / drafted
