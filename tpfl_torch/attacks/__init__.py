"""Attack injection — the port of :mod:`tpfl.attacks`, with its export
names.

- :func:`sign_flip` / :func:`additive_noise`: parameter transforms on
  the leaves' device; :func:`poison_model`, one-shot corruption;
- :class:`AdversarialLearner`: a persistent model-poisoning adversary
  around any learner;
- :class:`AttackPlan` / :class:`AttackSpec` / :class:`PlannedAdversary`
  / :func:`apply_attack_plan` / :class:`SlowLearner`: seeded per-peer
  attack schedules and the ground-truth adversary map.

Not ported, raising ``NotImplementedError`` naming ``ROADMAP.md`` §1
item 2 (node runtime B): :func:`make_adversary`, :func:`apply_chaos`,
:func:`apply_speed_plan` and the seeded-experiment harness
(``run_seeded_experiment``, ``adversary_map``,
``controller_trajectories``, ``metric_table``, ``flatten_table``,
``assert_tables_allclose``), which drive ``Node`` federations.
"""

from typing import Any

from tpfl_torch.attacks.attacks import (
    AdversarialLearner,
    additive_noise,
    make_adversary,
    not_ported,
    poison_model,
    sign_flip,
)
from tpfl_torch.attacks.plan import (
    AttackPlan,
    AttackSpec,
    PlannedAdversary,
    SlowLearner,
    apply_attack_plan,
    apply_chaos,
    apply_speed_plan,
)


def _harness(name: str):
    def refused(*args: Any, **kwargs: Any) -> Any:
        raise not_ported(f"attacks.harness.{name}")

    refused.__name__ = name
    refused.__doc__ = f"The harness's ``{name}`` — drives ``Node`` federations; not ported."
    return refused


run_seeded_experiment = _harness("run_seeded_experiment")
adversary_map = _harness("adversary_map")
controller_trajectories = _harness("controller_trajectories")
metric_table = _harness("metric_table")
flatten_table = _harness("flatten_table")
assert_tables_allclose = _harness("assert_tables_allclose")

__all__ = [
    "sign_flip",
    "additive_noise",
    "poison_model",
    "AdversarialLearner",
    "make_adversary",
    "AttackPlan",
    "AttackSpec",
    "PlannedAdversary",
    "SlowLearner",
    "apply_attack_plan",
    "apply_chaos",
    "apply_speed_plan",
    "run_seeded_experiment",
    "adversary_map",
    "controller_trajectories",
    "metric_table",
    "flatten_table",
    "assert_tables_allclose",
]
