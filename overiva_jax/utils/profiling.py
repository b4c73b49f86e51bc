"""Tracing / profiling utilities (SURVEY.md §5.1).

The reference's observability is `time.perf_counter` around each separation
call in ``mbss_sim.py``; here that is formalized: per-phase wall timers with
a report that waits for the device through ``jax.block_until_ready``, and
an optional ``jax.profiler`` trace context for XLA-level profiles.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np

__all__ = ["PhaseTimer", "profile_trace", "ConvergenceRecorder"]


class PhaseTimer:
    """Accumulating per-phase wall-clock timer.

    >>> timer = PhaseTimer()
    >>> with timer("stft"): X = stft(...)
    >>> with timer("iterate", sync_on=W): W = run(...)
    >>> print(timer.report())

    ``sync_on``: arrays (any pytree) the phase produced; the timer waits
    for them with ``jax.block_until_ready`` before stopping the clock, so
    the phase measures execution, not dispatch.
    """

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def __call__(self, phase: str, sync_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync_on is not None:
                import jax

                jax.block_until_ready(sync_on)
            self.totals[phase] += time.perf_counter() - t0
            self.counts[phase] += 1

    def report(self) -> str:
        lines = []
        for phase, total in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[phase]
            lines.append(f"{phase:>16s}: {total*1e3:9.1f} ms  ({n}x, {total/n*1e3:.1f} ms avg)")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: {"total_s": v, "count": self.counts[k]} for k, v in self.totals.items()}


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """``jax.profiler.trace`` context, no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(str(log_dir)):
        yield


class ConvergenceRecorder:
    """Callback recording per-iteration SDR/SIR (the reference's
    ``example.py`` convergence-monitoring pattern, SURVEY.md §4.2).

    Pass ``recorder`` as ``callback=`` to any algorithm; it iSTFTs each
    snapshot and scores it against the reference signals.
    """

    def __init__(self, refs: np.ndarray, nfft: int, hop: int | None = None,
                 n_samples: int | None = None, filter_length: int = 512):
        self.refs = np.asarray(refs)  # (n_src, n_samples) mic-0 images
        self.nfft = nfft
        self.hop = hop or nfft // 2
        self.n_samples = n_samples or self.refs.shape[1]
        self.filter_length = filter_length
        self.sdr: list[np.ndarray] = []
        self.sir: list[np.ndarray] = []

    def __call__(self, Y: np.ndarray) -> None:
        from ..metrics import bss_eval_sources
        from ..oracle import synthesis

        y = synthesis(Y, self.nfft, self.hop)
        start = self.nfft - self.hop
        y = y[start : start + self.n_samples]
        K = Y.shape[2]
        refs = self.refs[:K, : y.shape[0]]
        est = y.T[:, : refs.shape[1]]
        sdr, sir, _, perm = bss_eval_sources(
            refs, est, filter_length=self.filter_length
        )
        self.sdr.append(sdr)
        self.sir.append(sir)
