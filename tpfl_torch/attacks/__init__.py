"""Attack injection — the port of :mod:`tpfl.attacks`, with its export
names.

- :func:`sign_flip` / :func:`additive_noise`: parameter transforms on
  the leaves' device; :func:`poison_model`, one-shot corruption;
- :class:`AdversarialLearner`: a persistent model-poisoning adversary
  around any learner; :func:`make_adversary` turns a ``Node`` into one;
- :class:`AttackPlan` / :class:`AttackSpec` / :class:`PlannedAdversary`
  / :func:`apply_attack_plan` / :class:`SlowLearner` /
  :func:`apply_speed_plan` / :func:`apply_chaos`: seeded per-peer attack
  schedules, trainer-speed skew and fault plans wired into one
  federation, with the ground-truth adversary map;
- the seeded-experiment harness (:mod:`tpfl_torch.attacks.harness`):
  :func:`run_seeded_experiment` (``device=None`` means the card),
  :func:`adversary_map`, :func:`final_model_digests`,
  :func:`controller_trajectories`, :func:`metric_table`,
  :func:`flatten_table`, :func:`assert_tables_allclose`.
"""

from tpfl_torch.attacks.attacks import (
    AdversarialLearner,
    additive_noise,
    make_adversary,
    poison_model,
    sign_flip,
)
from tpfl_torch.attacks.harness import (
    adversary_map,
    assert_tables_allclose,
    controller_trajectories,
    final_model_digests,
    flatten_table,
    metric_table,
    run_seeded_experiment,
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
