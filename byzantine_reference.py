"""The Byzantine federation cell's verdicts in the JAX package and in the port,
on the CPU.

    JAX_PLATFORMS=cpu python3 byzantine_reference.py [--rounds 6] [--skip-jax]

Runs the bench's ``byzantine`` tier recipe at the cell ``chip_smoke.py``'s
phase 14 runs on the card — ``run_seeded_experiment(4242, 10, rounds,
epochs=4, samples_per_node=200, batch_size=25, learning_rate=0.1)``,
STAR, ``ELECTION = "hash"``, ``TRAIN_SET_SIZE = 10``, the test profile,
``QUARANTINE_ENABLED`` and ``LEDGER_ENABLED``, sign flips on nodes 1 and
4 and additive noise (std 0.1) on nodes 6 and 8 at seed 4242 — with the
CNN cell's model (channels 32 / 64, dense 128, 10 classes, bf16) on the
same seeded synthetic CIFAR-shaped arrays, first in the JAX package
(``tpfl``), then in the port (``tpfl_torch``, ``device="cpu"``). Prints,
per package, the ledger's flagged peers (the deterministic verdict), the
replayed quarantine set, each adversary's range of robust z-scores of
its update norm against the defense's threshold ``LEDGER_ANOMALY_Z``,
the peers flagged at intake (the live verdicts that kept models out of
the folds) with their rounds, and how many distinct final models the
nodes ended with, as one JSON line each. It takes
a few minutes (the JAX package compiles each node's step).
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

SEED, NODES, ADVERSARIES = 4242, 10, (1, 4, 6, 8)


def summary(name: str, ledger, quarantine, settings, exp: str, digests, wall: float) -> dict:
    det = ledger.contrib.detections()
    intake: dict[str, list] = {}
    for e in ledger.contrib.entries():
        if e["single"] and e["flagged"]:
            intake.setdefault(e["peer"], []).append(int(e["round"]))
    z = {}
    for e in det["entries"]:
        idx = int(e["peer"].rsplit("n", 1)[1])
        if idx in ADVERSARIES:
            z.setdefault(e["peer"], []).append(float(e["z_norm"]))
    return {"package": name, "wall_s": wall, "flagged": sorted(det["flagged"]),
            "quarantined": sorted(quarantine.quarantined_from_replay(
                quarantine.replay_decisions())),
            "adversary_z_range": {p: [min(v), max(v)] for p, v in sorted(z.items())},
            "ledger_anomaly_z": settings.LEDGER_ANOMALY_Z,
            "flagged_at_intake": {p: sorted(set(r)) for p, r in sorted(intake.items())},
            "honest_flagged_at_intake": sorted(
                p for p in intake if int(p.rsplit("n", 1)[1]) not in ADVERSARIES),
            "distinct_final_digests": len(set(digests(exp).values()))}


def configure(settings) -> None:
    settings.set_test_settings()
    settings.DISABLE_SIMULATION = True
    settings.ELECTION = "hash"
    settings.TRAIN_SET_SIZE = NODES
    settings.QUARANTINE_ENABLED = settings.LEDGER_ENABLED = True


def run_jax(arrays, rounds: int) -> dict:
    from tpfl.attacks import AttackPlan, AttackSpec, run_seeded_experiment
    from tpfl.attacks.harness import final_model_digests
    from tpfl.learning.dataset import TpflDataset
    from tpfl.management import ledger, quarantine
    from tpfl.management.logger import logger
    from tpfl.models import CNN, create_model
    from tpfl.settings import Settings

    configure(Settings)
    logger.set_level("ERROR")
    plan = AttackPlan({1: AttackSpec("sign_flip"), 4: AttackSpec("sign_flip"),
                       6: AttackSpec("additive_noise", std=0.1),
                       8: AttackSpec("additive_noise", std=0.1)}, seed=SEED)
    t0 = time.perf_counter()
    exp = run_seeded_experiment(
        SEED, NODES, rounds, epochs=4, attack_plan=plan,
        model_fn=lambda s: create_model(CNN(out_channels=10), (32, 32, 3), seed=s),
        data_fn=lambda s: TpflDataset.from_arrays(*arrays), samples_per_node=200,
        batch_size=25, learning_rate=0.1, timeout=1200.0)
    return summary("tpfl (JAX)", ledger, quarantine, Settings, exp, final_model_digests,
                   time.perf_counter() - t0)


def run_port(arrays, rounds: int) -> dict:
    from tpfl_torch.attacks import (AttackPlan, AttackSpec, final_model_digests,
                                    run_seeded_experiment)
    from tpfl_torch.learning.dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.management import ledger, quarantine
    from tpfl_torch.management.logger import logger
    from tpfl_torch.models import CNN, init_params
    from tpfl_torch.settings import Settings

    configure(Settings)
    logger.set_level("ERROR")
    plan = AttackPlan({1: AttackSpec("sign_flip"), 4: AttackSpec("sign_flip"),
                       6: AttackSpec("additive_noise", std=0.1),
                       8: AttackSpec("additive_noise", std=0.1)}, seed=SEED)

    def model_fn(s):
        module = CNN(out_channels=10)
        return TpflModel(module, init_params(module, (32, 32, 3), seed=s, device="cpu"),
                         device="cpu")

    t0 = time.perf_counter()
    exp = run_seeded_experiment(
        SEED, NODES, rounds, epochs=4, attack_plan=plan, model_fn=model_fn,
        data_fn=lambda s: TpflDataset.from_arrays(*arrays), samples_per_node=200,
        batch_size=25, learning_rate=0.1, timeout=1200.0, device="cpu")
    return summary("tpfl_torch", ledger, quarantine, Settings, exp, final_model_digests,
                   time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--skip-jax", action="store_true")
    args = ap.parse_args()
    from tpfl_torch.learning.dataset.synthetic import synthetic_cifar10

    torch.set_num_threads(1)
    arrays = tuple(np.asarray(a) for a in synthetic_cifar10(n_train=200 * NODES, n_test=1200,
                                                            seed=SEED))
    if not args.skip_jax:
        print(json.dumps(run_jax(arrays, args.rounds)), flush=True)
    print(json.dumps(run_port(arrays, args.rounds)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
