"""Parameter-poisoning attacks as pure tree transforms — the port of
:mod:`tpfl.attacks.attacks`.

``sign_flip`` negates every parameter; ``additive_noise`` adds ``N(0,
std)`` noise drawn from the port's copy of ``jax.random``
(:mod:`tpfl_torch.utils.threefry`) on the leaves' own device, keyed per
(seed, application counter, leaf index in JAX's pytree order) as the
reference's is, so the same seed poisons with the same bits up to the
normals' last roundings. :func:`poison_model` is the one-shot
corruption; :class:`AdversarialLearner` a persistent adversary that
poisons every fit of the learner it wraps.

:func:`make_adversary` wraps a node's learner; the node runtime is not
ported, so it raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Union

import torch

from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
from tpfl_torch.learning.learner import Learner
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.utils import threefry
from tpfl_torch.utils.tree import canonical_leaves, canonical_map, canonical_unflatten

AttackFn = Callable[[Any], Any]  # tree -> tree

NODE_ITEM = "ROADMAP.md §1 item 7, the node runtime"


def not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"tpfl_torch attacks: {what} is not ported yet ({NODE_ITEM})")


def add_noise(params: Any, base: tuple[int, int], std: float) -> Any:
    """Each leaf ``i`` (JAX's pytree order) plus ``std · normal(fold_in(
    base, i))`` cast to the leaf's dtype, drawn on the leaf's device."""
    leaves = canonical_leaves(params)
    out = []
    with torch.no_grad():
        for i, leaf in enumerate(leaves):
            noise = threefry.normal(threefry.fold_in(base, i), tuple(leaf.shape), leaf.device)
            out.append(leaf + (std * noise).to(leaf.dtype))
    return canonical_unflatten(params, out)


def sign_flip() -> AttackFn:
    """Negate every parameter."""

    def attack(params: Any) -> Any:
        return canonical_map(lambda x: -x, params)

    attack.name = "sign_flip"  # type: ignore[attr-defined]
    return attack


def additive_noise(std: float = 0.1, seed: int = 0) -> AttackFn:
    """Add ``N(0, std)`` noise to every parameter, deterministic per
    (seed, application counter, leaf index). The counter is closure
    state: create one instance per adversary."""
    counter = {"n": 0}

    def attack(params: Any) -> Any:
        base = threefry.fold_in(threefry.PRNGKey(seed), counter["n"])
        counter["n"] += 1
        return add_noise(params, base, std)

    attack.name = f"additive_noise(std={std})"  # type: ignore[attr-defined]
    return attack


def poison_model(model: TpflModel, attack: AttackFn) -> TpflModel:
    """One-shot in-place corruption of ``model``'s parameters."""
    model.set_parameters(attack(model.get_parameters()))
    return model


class AdversarialLearner(Learner):
    """Persistent model-poisoning adversary: every ``fit()`` trains
    honestly through the wrapped learner, then applies ``attack`` to the
    fitted parameters before the model enters aggregation. With
    ``once=True`` only the first fit is poisoned."""

    def __init__(self, inner: Learner, attack: AttackFn, once: bool = False) -> None:
        # No super().__init__: a pure proxy — state, callbacks and data
        # live on the wrapped learner.
        self._inner = inner
        self._attack = attack
        self._once = once
        self._fired = False
        self._last_fit_model = None

    # --- the attack seam ---

    def fit(self) -> TpflModel:
        model = self._inner.fit()
        if self._once and self._fired:
            self._last_fit_model = model
            return model
        self._fired = True
        model.set_parameters(self._attack(model.get_parameters()))
        self._last_fit_model = model
        return model

    # --- pure delegation ---

    def set_addr(self, addr: str) -> None:
        self._inner.set_addr(addr)

    def get_addr(self) -> str:
        return self._inner.get_addr()

    def set_model(self, model: Union[TpflModel, list, bytes]) -> None:
        self._inner.set_model(model)

    def get_model(self) -> TpflModel:
        return self._inner.get_model()

    def set_data(self, data: TpflDataset) -> None:
        self._inner.set_data(data)

    def get_data(self) -> TpflDataset:
        return self._inner.get_data()

    def set_epochs(self, epochs: int) -> None:
        self._inner.set_epochs(epochs)

    def set_fit_group_hint(self, peers: "int | list[str]") -> None:
        self._inner.set_fit_group_hint(peers)

    def update_callbacks_with_model_info(self) -> None:
        self._inner.update_callbacks_with_model_info()

    def add_callback_info_to_model(self, model: Optional[TpflModel] = None) -> None:
        self._inner.add_callback_info_to_model(model)

    def interrupt_fit(self) -> None:
        self._inner.interrupt_fit()

    def evaluate(self) -> dict[str, float]:
        return self._inner.evaluate()

    def get_framework(self) -> str:
        return self._inner.get_framework()

    def get_num_samples(self) -> int:
        return self._inner.get_num_samples()

    @property
    def callbacks(self):  # type: ignore[override]
        return self._inner.callbacks

    @property
    def epochs(self):  # type: ignore[override]
        return self._inner.epochs

    @epochs.setter
    def epochs(self, value: int) -> None:
        self._inner.epochs = value


def make_adversary(node: Any, attack: AttackFn, once: bool = False) -> Any:
    """Wrap a node's learner — needs the node runtime."""
    raise not_ported("make_adversary (a Node)")


__all__ = ["AdversarialLearner", "AttackFn", "additive_noise", "make_adversary",
           "poison_model", "sign_flip"]
