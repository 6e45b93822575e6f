"""Experiment — the round counter of one federated run, a copy of
:mod:`tpfl.experiment`, with the per-experiment profiling capture: the
experiment snapshots ``Settings.PROFILING_TRACE_DIR`` at creation, so
the stage workflow can wrap the whole run (StartLearning through finish)
in a ``torch.profiler`` trace without re-reading mutable global state
mid-experiment. Empty means no trace."""

from __future__ import annotations


class Experiment:
    def __init__(
        self, exp_name: str, total_rounds: int, profile_dir: "str | None" = None
    ) -> None:
        self.exp_name = exp_name
        self.total_rounds = int(total_rounds)
        self.round: int = 0
        if profile_dir is None:
            from tpfl_torch.settings import Settings

            profile_dir = Settings.PROFILING_TRACE_DIR
        self.profile_dir: str = profile_dir or ""

    def increase_round(self) -> None:
        if self.round is None:
            raise ValueError("Experiment round not initialized")
        self.round += 1

    def __repr__(self) -> str:
        return (
            f"Experiment(name={self.exp_name}, round={self.round}/"
            f"{self.total_rounds})"
        )
