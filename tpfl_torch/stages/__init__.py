"""Round-protocol stage FSM — the port of :mod:`tpfl.stages` (reference
``p2pfl/stages/``).

Stage graph::

    StartLearning → Vote → (Train | WaitAggregatedModels)
                  → GossipModel → RoundFinished → (Vote | done)
"""

from tpfl_torch.stages.stage import Stage, StageWorkflow, LearningWorkflow

__all__ = ["Stage", "StageWorkflow", "LearningWorkflow"]
