"""Admission control of the batch engine (port of
``cake_tpu/runtime/admission.py``, the continuous scheduler's step budget).

``StepBudget`` is the continuous scheduler's per-step prefill grant: how
many prompt tokens of join and restore prefill one engine step may dispatch
before decode resumes (runtime/serving.py ``_take_restores`` /
``_take_joins``). The reference's tenants, fair queue, wait estimator and
stall guard are not ported yet (ROADMAP.md, the admission item): the
engine's queue is the single-tenant FIFO, and with no SLO tracker and no
deadlines the engine grants with ``burning=False`` and no slack.
"""

from __future__ import annotations

__all__ = ["StepBudget"]


class StepBudget:
    """SLO-aware prefill-vs-decode split for the continuous scheduler.

    Each engine step grants at most ``grant()`` prompt tokens of join /
    restore prefill work before decode resumes. Two feedback signals move
    it:

      * **Burn**: while some tenant's SLO burn is high (queue waits are
        missing the TTFT objective) the grant DOUBLES, so admissions drain
        faster at the cost of slightly slower decode.
      * **Deadline slack**: while a RUNNING stream's deadline slack is
        inside ``SLACK_CHUNKS`` recent chunk walls, the grant QUARTERS
        (floor ``MIN_TOKENS``): a stream about to miss needs decode steps,
        not prefill stalls.

    Engine-thread only (no locks): ``observe_chunk`` feeds the chunk-wall
    EWMA the slack comparison is measured in.
    """

    AUTO_TOKENS = 512     # default base grant (~ a few joins per step)
    MIN_TOKENS = 64       # never starve admission entirely
    SLACK_CHUNKS = 8.0    # deadline pressure threshold in chunk walls

    def __init__(self, base_tokens: int = 0, alpha: float = 0.3):
        self.base = int(base_tokens)
        self.alpha = alpha
        self.chunk_ewma = 0.0

    def observe_chunk(self, wall_s: float) -> None:
        if self.chunk_ewma <= 0.0:
            self.chunk_ewma = wall_s
        else:
            self.chunk_ewma += self.alpha * (wall_s - self.chunk_ewma)

    def grant(
        self, burning: bool = False, tightest_slack_s: float | None = None
    ) -> int:
        out = self.base or self.AUTO_TOKENS
        if burning:
            out *= 2
        if (
            tightest_slack_s is not None
            and self.chunk_ewma > 0.0
            and tightest_slack_s < self.SLACK_CHUNKS * self.chunk_ewma
        ):
            out = max(self.MIN_TOKENS, out // 4)
        return out
