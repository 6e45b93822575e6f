"""Stage ABC + workflow engine — a copy of :mod:`tpfl.stages.stage`.

Parity with reference ``stages/stage.py:26-66`` and
``stages/workflows.py:37-60``: a stage's ``execute`` returns the next
stage class (or None to finish); the workflow records the visited stage
names as ``history`` — the only built-in execution trace, asserted
verbatim by the reference's convergence test (node_test.py:108-123).

No StageFactory here: stages receive the node facade duck-typed, so
there are no import cycles to break (reference stage_factory.py:26-59
exists only for that).
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import TYPE_CHECKING, Optional, Type

from tpfl_torch.management import tracing
from tpfl_torch.management.logger import logger

if TYPE_CHECKING:
    from tpfl_torch.node import Node


class Stage(ABC):
    name: str = "Stage"

    @staticmethod
    @abstractmethod
    def execute(node: "Node") -> Optional[Type["Stage"]]:
        """Run this stage; return the next stage class or None."""


def check_early_stop(node: "Node", raise_exception: bool = False) -> bool:
    """Round cleared (StopLearning) → abort the workflow (reference
    stage.py:46-66)."""
    stopped = node.state.round is None or node.state.status != "Learning"
    if stopped and raise_exception:
        raise EarlyStopException("Learning stopped")
    return stopped


class EarlyStopException(Exception):
    pass


class StageWorkflow:
    def __init__(self, first_stage: Type[Stage]) -> None:
        self.first_stage = first_stage
        self.history: list[str] = []
        self.finished = False

    def run(self, node: "Node") -> None:
        stage: Optional[Type[Stage]] = self.first_stage
        self.finished = False
        try:
            while stage is not None:
                self.history.append(stage.name)
                logger.debug(node.addr, f"Stage: {stage.name}")
                # Round spans: every stage execution is a span in the
                # node's flight ring, tagged with the round it served —
                # the timeline's per-node backbone that the payload hop
                # spans hang between.
                with tracing.maybe_span(
                    f"stage:{stage.name}", node.addr,
                    round=node.state.round if node.state.round is not None else -1,
                ):
                    stage = stage.execute(node)
        except EarlyStopException:
            logger.info(node.addr, "Workflow stopped early")
        finally:
            self.finished = True


class LearningWorkflow(StageWorkflow):
    def __init__(self) -> None:
        from tpfl_torch.stages.base_node import StartLearningStage

        super().__init__(StartLearningStage)
