"""TorchLearner — local training and evaluation on the card, the port of
:mod:`tpfl.learning.jax_learner`, with its loss and local optimizer
(``cross_entropy_loss``, ``default_optimizer``).

The optimizer is functional over trees of tensors (a nested dict of
params, the same structure of momentum traces); the engine uses it on
node-stacked trees, where one step updates every node's model at once.

:class:`TorchLearner` runs ONE model on the node-stacked zoo modules with
a node axis of 1 (``params[None]``, ``x[None]``), so ``CNN(conv_impl=
"pallas")`` trains through the ``conv_dw`` / ``conv_dx`` kernels on the
card at N = 1. Its train step is the reference's ``make_train_step``:
the batch's mean loss, gradients ``g + c + mu·(p − a)`` in the
gradient's dtype (SCAFFOLD's correction ``c``, FedProx's pull toward the
round-start anchor ``a``), the optimizer step, BatchNorm state
threading, and the raw gradients summed when a callback
``wants_avg_grad``. The optimizer state is created again on every fit;
batches come from ``Batches.stacked(epoch=round·10 000 + epoch)`` with
the seed ``(Settings.SEED or 0) + crc32(addr)``. Evaluation is the
reference's masked confusion-matrix pass over every test sample. The
train-epoch and evaluation functions are shared by every learner of one
configuration (``_SHARED_PROGRAMS``, as the reference shares its jitted
programs), behind the compile observatory. Under
``Settings.LEDGER_ENABLED`` each epoch's loss feeds the ledger's
convergence monitor (``ledger.convergence.observe_loss``).
"""

from __future__ import annotations

import logging
import threading
import zlib
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from tpfl_torch import DeviceLike, resolve_device
from tpfl_torch.learning.dataset.tpfl_dataset import TpflDataset
from tpfl_torch.learning.learner import Learner
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.management import ledger, profiling
from tpfl_torch.management.logger import logger
from tpfl_torch.models.zoo import apply
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import Tree, canonical_map, tree_leaves, tree_map


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-sample softmax cross entropy on f32 logits ``[..., C]`` and
    integer labels ``[...]`` -> losses ``[...]`` (training takes the
    mean, evaluation weighs each sample)."""
    flat = F.cross_entropy(
        logits.reshape(-1, logits.shape[-1]).to(torch.float32),
        labels.reshape(-1).to(torch.long),
        reduction="none",
    )
    return flat.reshape(labels.shape)


class SGDMomentum:
    """``optax.sgd(lr, momentum)`` on stacked tensors: per leaf
    ``t = g + momentum·t`` and ``p = p + (-lr)·t``, with the trace
    starting at zero."""

    def __init__(self, lr: float, momentum: float = 0.9) -> None:
        self.lr = float(lr)
        self.momentum = float(momentum)

    def init(self, params: Tree) -> Tree:
        return tree_map(torch.zeros_like, params)

    @torch.no_grad()
    def step(self, params: Tree, grads: Tree, trace: Tree) -> tuple[Tree, Tree]:
        """(new params, new trace); the inputs are left unchanged."""
        new_t = tree_map(lambda g, t: g + self.momentum * t, grads, trace)
        new_p = tree_map(lambda p, t: p + t * (-self.lr), params, new_t)
        return new_p, new_t


def default_optimizer(lr: float) -> SGDMomentum:
    """Canonical local optimizer: SGD + momentum 0.9."""
    return SGDMomentum(lr, momentum=0.9)


OptimizerFactory = Callable[[float], SGDMomentum]


def module_key(module: Any) -> tuple:
    """A hashable description of a zoo module: its class and its public
    configuration (a zoo module holds no parameters)."""
    config = tuple(sorted((k, repr(v)) for k, v in vars(module).items()
                          if not k.startswith("_") and k != "training"))
    return (type(module).__qualname__, config, repr(module))


#: Train-epoch and evaluation functions shared by every learner of one
#: configuration (the reference's compiled-program cache).
_SHARED_PROGRAMS: dict[tuple, Callable] = {}


def _shared_program(key: tuple, build: Callable[[], Callable]) -> Callable:
    fn = _SHARED_PROGRAMS.get(key)
    profiling.observatory.cache_event("shared_programs", hit=fn is not None)
    if fn is None:
        fn = _SHARED_PROGRAMS[key] = build()
    return fn


def clear_compiled_caches() -> None:
    """Drop the process program caches: the shared learner programs and
    the pool's batched programs (``SuperLearnerPool.reset``); counted in
    ``tpfl_compiled_cache_clears_total``."""
    dropped = len(_SHARED_PROGRAMS)
    _SHARED_PROGRAMS.clear()
    from tpfl_torch.simulation import batched_fit

    dropped += len(batched_fit._programs)
    batched_fit.clear_programs()
    profiling.observatory.cache_cleared(dropped)


def _addr_seed(addr: str) -> int:
    """Stable per-node seed component (crc32: deterministic across
    processes, unlike hash())."""
    return zlib.crc32(addr.encode())


class TrainState:
    """One model's training state: params, optimizer trace and aux
    (BatchNorm) state, each a tree of tensors."""

    __slots__ = ("params", "trace", "aux")

    def __init__(self, params: Tree, trace: Tree, aux: Tree) -> None:
        self.params, self.trace, self.aux = params, trace, aux


def _single(tree: Tree) -> Tree:
    """A node axis of 1 on every leaf."""
    return tree_map(lambda v: v[None], tree)


def _unstack(tree: Tree) -> Tree:
    return tree_map(lambda v: v[0], tree)


def _rows(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A [n] vector shaped to broadcast over a node-stacked leaf."""
    return v.reshape((-1,) + (1,) * (like.dim() - 1))


def _keep_rows(keep: torch.Tensor, new: Tree, old: Tree) -> Tree:
    """``new`` on the rows where ``keep``, ``old`` elsewhere."""
    return tree_map(lambda n, o: torch.where(_rows(keep, n), n, o), new, old)


def make_train_step(module: Any, loss_fn: Callable, has_aux: bool, opt: SGDMomentum,
                    with_grads: bool = False) -> Callable:
    """THE local SGD step (the reference's ``make_train_step``), over a
    node axis: ``step(state, x, y, correction, anchor, mu, keep=None) ->
    (state, loss [n], acc [n][, raw grads])`` on node-stacked trees
    (``x [n, b, ...]``). Each node's loss is its batch's mean and depends
    on its own params only, so one backward of the summed losses gives
    every node its own gradient. ``correction`` is the constant per-round
    gradient offset (SCAFFOLD's ``c - c_i``) or None; ``anchor`` / ``mu``
    ([n] f32, or None to skip) give the FedProx pull ``mu * (w_t -
    w_round_start)``. Rows where ``keep`` ([n] bool, None = all) is False
    come back unchanged: a padding batch is an exact no-op. With
    ``with_grads`` the step also returns the RAW mini-batch gradient
    (before correction and proximal terms). :class:`TorchLearner` runs it
    at n = 1; the simulation pool's batched fits
    (``parallel.engine.build_masked_local_fit``) run it over a chunk of
    learners."""

    def step(state: TrainState, x: torch.Tensor, y: torch.Tensor, correction: Optional[Tree],
             anchor: Tree, mu: Optional[torch.Tensor], keep: Optional[torch.Tensor] = None):
        leaves = tree_map(lambda v: v.detach().requires_grad_(True), state.params)
        logits, new_aux = apply(module, leaves, state.aux if has_aux else {}, x, train=True)
        per_sample = loss_fn(logits, y)
        n = per_sample.shape[0]
        loss = per_sample.reshape(n, -1).mean(1)
        flat = torch.autograd.grad(loss.sum(), tree_leaves(leaves))
        it = iter(flat)
        grads = tree_map(lambda _v: next(it), leaves)
        with torch.no_grad():
            corrected = grads
            if correction is not None:
                corrected = tree_map(lambda g, c: g + c.to(g.dtype), corrected, correction)
            if mu is not None:
                corrected = tree_map(lambda g, p, a: g + (_rows(mu, p) * (p - a)).to(g.dtype),
                                     corrected, state.params, anchor)
            params, trace = opt.step(state.params, corrected, state.trace)
            acc = (logits.argmax(-1) == y).to(torch.float32).reshape(n, -1).mean(1)
            new = TrainState(params, trace, new_aux if has_aux else state.aux)
            if keep is not None:
                new = TrainState(_keep_rows(keep, new.params, state.params),
                                 _keep_rows(keep, new.trace, state.trace),
                                 _keep_rows(keep, new.aux, state.aux) if has_aux else state.aux)
        if with_grads:
            return new, loss.detach(), acc, grads
        return new, loss.detach(), acc

    return step


def make_train_epoch(module: Any, loss_fn: Callable, has_aux: bool, opt: SGDMomentum,
                     track_grads: bool = False) -> Callable:
    """One epoch over node-stacked batches ``xs [n, n_batches, b, ...]``:
    ``epoch(state, xs, ys, correction, anchor, mu) -> (state, mean loss
    [n], mean acc [n][, summed raw grads])``; the gradient sum is in
    ``promote(p.dtype, f32)``."""
    step = make_train_step(module, loss_fn, has_aux, opt, with_grads=track_grads)

    def epoch(state: TrainState, xs: torch.Tensor, ys: torch.Tensor,
              correction: Optional[Tree], anchor: Tree, mu: Optional[torch.Tensor]):
        gsum = (tree_map(lambda p: torch.zeros(p.shape, device=p.device, dtype=torch.promote_types(
            p.dtype, torch.float32)), state.params) if track_grads else None)
        losses, accs = [], []
        for i in range(xs.shape[1]):
            out = step(state, xs[:, i], ys[:, i], correction, anchor, mu)
            state, loss, acc = out[:3]
            if track_grads:
                gsum = tree_map(lambda a, g: a.add_(g.to(a.dtype)), gsum, out[3])
            losses.append(loss)
            accs.append(acc)
        loss, acc = torch.stack(losses).mean(0), torch.stack(accs).mean(0)
        return (state, loss, acc, gsum) if track_grads else (state, loss, acc)

    return epoch


def make_eval(module: Any, loss_fn: Callable) -> Callable:
    """The reference's eval program: ``eval_batches(params, aux, xs, ys,
    ms) -> (mean loss over the masked samples, confusion matrix [C,
    C])`` over padded batches ``xs [n_batches, b, ...]`` with a 0/1
    sample mask ``ms``."""

    @torch.no_grad()
    def eval_batches(params: Tree, aux: Tree, xs: torch.Tensor, ys: torch.Tensor,
                     ms: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        p1, a1 = _single(params), (_single(aux) if aux else {})
        loss_sum = torch.zeros((), dtype=torch.float32, device=xs.device)
        count = torch.zeros((), dtype=torch.int32, device=xs.device)
        cm = None
        for i in range(xs.shape[0]):
            logits = apply(module, p1, a1, xs[i][None], train=False)[0][0]
            y, m = ys[i], ms[i]
            losses = loss_fn(logits, y)
            preds = logits.argmax(-1)
            mm = m.reshape(m.shape + (1,) * (losses.dim() - 1)).expand(losses.shape)
            if cm is None:
                n_classes = logits.shape[-1]
                cm = torch.zeros((n_classes, n_classes), dtype=torch.int32, device=xs.device)
            cm.index_put_((y.reshape(-1).long(), preds.reshape(-1)), mm.reshape(-1),
                          accumulate=True)
            loss_sum = loss_sum + (losses * mm).sum()
            count = count + mm.sum(dtype=torch.int32)
        return loss_sum / torch.clamp(count, min=1), cm

    return eval_batches


class TorchLearner(Learner):
    """Learner for the port's zoo modules on one device.

    Args:
        model: TpflModel holding a zoo module + params.
        data: local dataset.
        addr: node address (metrics + seeding).
        aggregator: used only to build required callbacks.
        learning_rate / optimizer_factory: the factory receives the
            learning rate; default SGD + momentum 0.9.
        batch_size: training batch size (eval uses the same).
        loss_fn: (logits, labels) -> per-sample loss.
        device: ``None`` means the card; ``"cpu"`` asks for the CPU.
    """

    def __init__(
        self,
        model: Optional[TpflModel] = None,
        data: Optional[TpflDataset] = None,
        addr: str = "unknown-node",
        aggregator: Optional[Any] = None,
        learning_rate: float = 0.1,
        optimizer_factory: Optional[OptimizerFactory] = None,
        batch_size: int = 64,
        loss_fn: Callable = cross_entropy_loss,
        device: DeviceLike = None,
    ) -> None:
        self.device = resolve_device(device)
        super().__init__(model, data, addr, aggregator)
        self.learning_rate = float(learning_rate)
        self._optimizer_factory = optimizer_factory or default_optimizer
        self.batch_size = int(batch_size)
        self._loss_fn = loss_fn
        self._interrupt = threading.Event()
        self._round_counter = 0  # advances every fit() for shuffle seeding
        self._train_epoch_fn: Optional[Callable] = None
        # Whether the cached epoch function sums raw gradients — tracks
        # the callback set (the output arity differs).
        self._train_epoch_track = False
        self._train_batches: Optional[Any] = None
        self._eval_arrays: Optional[tuple] = None

    def set_data(self, data: TpflDataset) -> None:
        super().set_data(data)
        self._train_batches = None
        self._eval_arrays = None

    # --- train / eval functions ---

    def _module(self) -> Any:
        mod = self.get_model().module
        if mod is None:
            raise ValueError("TpflModel has no module attached")
        return mod

    def _has_aux(self) -> bool:
        return bool(self.get_model().aux_state)

    def _track_grads(self) -> bool:
        """True when any callback wants the true average local gradient
        (``wants_avg_grad`` — SCAFFOLD)."""
        return any(getattr(cb, "wants_avg_grad", False) for cb in self.callbacks)

    def _build_train_epoch(self) -> Callable:
        module, loss_fn, has_aux, track = (self._module(), self._loss_fn, self._has_aux(),
                                           self._track_grads())
        opt_factory, lr = self._optimizer_factory, self.learning_rate
        key = ("train_epoch", module_key(module), loss_fn, has_aux, track, opt_factory, lr)
        return _shared_program(key, lambda: profiling.observatory.wrap(
            make_train_epoch(module, loss_fn, has_aux, opt_factory(lr), track),
            f"train_epoch:{profiling.module_tag(module)}"))

    # --- data ---

    def _export_kwargs(self) -> dict:
        """Token models (TransformerLM) declare ``input_dtype``; export
        keeps integer ids integer instead of the float32 default."""
        dt = getattr(self.get_model().module, "input_dtype", None)
        if dt is None:
            return {}
        if isinstance(dt, torch.dtype):
            dt = torch.empty(0, dtype=dt).numpy().dtype
        return {"x_dtype": np.dtype(dt)}

    def _train_data(self, epoch_seed: int):
        if self._train_batches is None:
            self._train_batches = self.get_data().export(
                batch_size=self.batch_size, train=True, seed=epoch_seed,
                **self._export_kwargs(),
            )
        return self._train_batches

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # --- Learner API ---

    def prepare_fit(self) -> tuple[TpflModel, Any, Any, float, Any]:
        """Pre-fit lifecycle: callbacks see round-start params and may
        contribute a gradient correction. Returns (model, initial_params,
        correction or None, prox_mu, batches)."""
        model = self.get_model()
        initial_params = tree_map(lambda v: v.to(self.device), model.get_parameters())
        for cb in self.callbacks:
            cb.on_fit_start(initial_params, self.learning_rate)
        correction = None
        for cb in self.callbacks:
            c = cb.grad_correction(initial_params)
            if c is not None:
                correction = c if correction is None else canonical_map(
                    torch.add, correction, c)
        mu = sum(cb.prox_mu() for cb in self.callbacks)
        batches = self._train_data((Settings.SEED or 0) + _addr_seed(self._addr))
        return model, initial_params, correction, mu, batches

    def finish_fit(
        self,
        model: TpflModel,
        initial_params: Any,
        final_params: Any,
        final_aux: Any,
        n_steps: int,
        num_samples: int,
        avg_grad: Any = None,
    ) -> None:
        """Post-fit lifecycle (counterpart of prepare_fit): params, aux,
        contribution, callbacks' ``on_fit_end`` and info."""
        model.set_parameters(final_params)
        if final_aux:
            model.aux_state = final_aux
        model.set_contribution([self._addr], num_samples)
        for cb in self.callbacks:
            cb.on_fit_end(initial_params, final_params, n_steps, self.learning_rate,
                          avg_grad=avg_grad)
        self.add_callback_info_to_model(model)
        self._last_fit_model = model

    def skip_fit(self, model: Optional[TpflModel] = None) -> TpflModel:
        """Interrupted (or epochs=0) before any step: model unchanged,
        zero FL weight, and no callback info — a node that did no
        training must not move the global control variates or count in
        the weighted mean. Works on a copy (``model`` may be the live
        round aggregate)."""
        model = model if model is not None else self.get_model()
        skipped = model.build_copy(
            params=model.get_parameters(),
            contributors=[self._addr],
            num_samples=0,
            additional_info=dict(model.additional_info),
        )
        for cb in self.callbacks:
            skipped.additional_info.pop(cb.get_name(), None)
        self._last_fit_model = skipped
        return skipped

    def fit(self) -> TpflModel:
        """Run ``self.epochs`` local epochs (the round profiler's
        ``train`` component)."""
        with profiling.rounds.span(self._addr, "train"):
            return self._fit()

    def _fit(self) -> TpflModel:
        self._interrupt.clear()
        track = self._track_grads()
        if self._train_epoch_fn is None or track != self._train_epoch_track:
            self._train_epoch_fn = self._build_train_epoch()
            self._train_epoch_track = track

        model, initial_params, correction, mu, batches = self.prepare_fit()
        aux = tree_map(lambda v: v.to(self.device), model.aux_state or {})
        # Fresh optimizer state every fit (the reference's TrainState.create),
        # on a node axis of 1.
        params1 = _single(initial_params)
        state = TrainState(params1, tree_map(torch.zeros_like, params1), _single(aux))
        corr1 = None if correction is None else _single(correction)
        mu1 = (torch.tensor([float(mu)], dtype=torch.float32, device=self.device)
               if mu else None)
        in_exp = self._in_experiment()
        n_steps = 0
        gsum_total: Any = None
        for epoch in range(self.epochs):
            if self._interrupt.is_set():
                logger.info(self._addr, f"Training interrupted at epoch {epoch}")
                break
            xs, ys = batches.stacked(epoch=self._round_counter * 10_000 + epoch)
            out = self._train_epoch_fn(state, self._tensor(xs)[None], self._tensor(ys)[None],
                                       corr1, params1, mu1)
            if track:
                state, loss, acc, gsum = out
                gsum_total = gsum if gsum_total is None else tree_map(torch.add, gsum_total,
                                                                     gsum)
            else:
                state, loss, acc = out
            n_steps += xs.shape[0]
            if in_exp:
                logger.log_metric(self._addr, "train_loss", float(loss[0]), step=epoch)
            # Learning-plane fit seam: one attribute read when off.
            if Settings.LEDGER_ENABLED:
                ledger.convergence.observe_loss(self._addr, self._round_counter * 10_000 + epoch,
                                                float(loss[0]))
            if logger.get_level() <= logging.DEBUG:
                logger.debug(self._addr, f"epoch {epoch}: loss={float(loss[0]):.4f} "
                                         f"acc={float(acc[0]):.4f}")
        self._round_counter += 1

        if n_steps == 0:
            return self.skip_fit(model)

        avg_grad = None
        if gsum_total is not None:
            inv = float(np.float32(1.0 / max(n_steps, 1)))
            avg_grad = tree_map(lambda g: g * inv, _unstack(gsum_total))
        self.finish_fit(model, initial_params, _unstack(state.params),
                        _unstack(state.aux) if aux else aux, n_steps,
                        batches.num_samples, avg_grad=avg_grad)
        return model

    def _in_experiment(self) -> bool:
        info = logger.get_nodes().get(self._addr)
        return bool(info and info.get("experiment") is not None)

    def interrupt_fit(self) -> None:
        self._interrupt.set()

    def reset_interrupt(self) -> None:
        """Clear a stale interrupt (fit() does this on entry)."""
        self._interrupt.clear()

    def _eval_batches(self) -> tuple:
        """The test split padded to full batches, with a 0/1 sample mask
        so no tail sample is dropped and padding counts nowhere."""
        if self._eval_arrays is None:
            batches = self.get_data().export(batch_size=self.batch_size, train=False,
                                             drop_remainder=False, **self._export_kwargs())
            x, y = batches.x, batches.y
            bs = batches.batch_size
            n_batches = -(-len(x) // bs)
            pad = n_batches * bs - len(x)
            mask = np.concatenate([np.ones(len(x), np.int32), np.zeros(pad, np.int32)])
            x = np.concatenate([x, np.zeros((pad, *x.shape[1:]), x.dtype)])
            y = np.concatenate([y, np.zeros((pad, *y.shape[1:]), y.dtype)])
            self._eval_arrays = (
                self._tensor(x.reshape(n_batches, bs, *x.shape[1:])),
                self._tensor(y.reshape(n_batches, bs, *y.shape[1:])),
                self._tensor(mask.reshape(n_batches, bs)),
            )
        return self._eval_arrays

    def evaluate(self) -> dict[str, float]:
        """Loss + accuracy + macro precision/recall/F1 from one
        confusion-matrix pass over every test sample."""
        model = self.get_model()
        if self.get_data().num_samples(False) == 0:
            return {}
        xs, ys, ms = self._eval_batches()
        params = tree_map(lambda v: v.to(self.device), model.get_parameters())
        aux = tree_map(lambda v: v.to(self.device), model.aux_state or {})
        module = self._module()
        key = ("eval", module_key(module), self._loss_fn)
        eval_fn = _shared_program(key, lambda: profiling.observatory.wrap(
            make_eval(module, self._loss_fn), f"eval:{profiling.module_tag(module)}"))
        loss, cm = eval_fn(params, aux, xs, ys, ms)
        cm = cm.cpu().numpy().astype(np.float64)
        tp = np.diag(cm)
        support = cm.sum(axis=1)  # true counts per class
        predicted = cm.sum(axis=0)
        present = support > 0
        with np.errstate(divide="ignore", invalid="ignore"):
            precision = np.where(predicted > 0, tp / predicted, 0.0)
            recall = np.where(present, tp / support, 0.0)
            f1 = np.where(precision + recall > 0,
                          2 * precision * recall / (precision + recall), 0.0)
        metrics = {
            "test_loss": float(loss),
            "test_metric": float(tp.sum() / max(cm.sum(), 1.0)),  # accuracy
            "test_precision": float(precision[present].mean()),
            "test_recall": float(recall[present].mean()),
            "test_f1": float(f1[present].mean()),
        }
        if self._in_experiment():
            for k, v in metrics.items():
                logger.log_metric(self._addr, k, v)
        return metrics


__all__ = ["SGDMomentum", "TorchLearner", "TrainState", "clear_compiled_caches",
           "cross_entropy_loss", "default_optimizer", "make_eval", "make_train_epoch",
           "make_train_step", "module_key"]
