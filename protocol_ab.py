"""Alternating A/B of the protocol and Byzantine rounds between two
checkouts of this repo on one card.

    python3 protocol_ab.py A_DIR B_DIR [--pairs 10] [--rounds 5]

Each trial is a fresh process that imports ``chip_smoke`` and
``tpfl_torch`` from the checkout it names and runs chip_smoke's protocol
round (``protocol_learners`` / ``protocol_round``: four CNN
``TorchLearner``s on the card, v3 wire, node 0 folds) for FedAvg and then
FedProx: one warm-up round, then ``--rounds`` timed rounds, each checked
as chip_smoke checks it. It then runs chip_smoke's Byzantine round
(``byzantine_arm``: ten CNN learners, two sign flips and two noisy
peers, v3 wire, node 0 folds) undefended and with ``QUARANTINE_ENABLED``
and ``LEDGER_ENABLED``: a warm-up round and ``B_ROUNDS`` timed ones
each, verdicts checked as chip_smoke checks them. Trials run A, B, B, A,
A, B, ... so neither arm always goes first; pair i is the i-th trial of
each arm. Both checkouts' kernels are built before the first trial.
Prints, per round kind and arm, the median and quartiles of the trials'
median round walls (and of the protocol round's fit times), and how many
pairs B lost, as one JSON line after the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

LABELS = ("fedavg", "fedprox")
BYZANTINE_LABELS = ("fedavg", "fedavg+quarantine")


def trial(tree: str, rounds: int) -> dict:
    import chip_smoke as cs

    out = {}
    for label in LABELS:
        _, codec, aggregator, lr = next(r for r in cs.P_ROUNDS if r[0] == label)
        learners, agg, params = cs.protocol_learners(aggregator, lr)
        with cs.setting("WIRE_CODEC", codec):
            _, state = cs.protocol_round(label, learners, agg, (params, None))
            walls, fits = [], []
            for _ in range(rounds):
                result, state = cs.protocol_round(label, learners, agg, state)
                walls.append(result["round_wall_ms"])
                fits.extend(result["fit_ms"])
        out[label] = {"round_ms": statistics.median(walls), "fit_ms": statistics.median(fits)}
    x, y, xt, yt = cs.synthetic_cifar10(n_train=cs.B_NODES * cs.B_TRAIN,
                                        n_test=cs.B_NODES * cs.B_TEST, seed=cs.B_SEED)
    parts = cs.TpflDataset.from_arrays(x, y, xt, yt).generate_partitions(
        cs.B_NODES, cs.RandomIIDPartitionStrategy, seed=cs.B_SEED)
    for label in BYZANTINE_LABELS:
        _, make_agg, defend = next(a for a in cs.B_ARMS if a[0] == label)
        arm = cs.byzantine_arm(label, make_agg, defend, parts)
        out[f"byzantine {label}"] = {"round_ms": statistics.median(arm["round_ms_each"])}
    return out


def run_child(tree: str, *args: str) -> dict:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, *args],
                          cwd=tree, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"trial in {tree} failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def quartiles(xs: list[float]) -> dict:
    q1, med, q3 = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": med, "q1": q1, "q3": q3}


def main(argv: list[str]) -> int:
    if argv[:1] == ["--child"]:
        tree = os.path.abspath(argv[1])
        sys.path[0] = tree  # this checkout's chip_smoke and tpfl_torch
        if argv[2:] == ["--build"]:
            from tpfl_torch.parallel import _build

            _build.build(_build.all_sources())
            print(json.dumps({"built": tree}))
        else:
            print(json.dumps(trial(tree, int(argv[3]))))
        return 0
    a, b = (os.path.abspath(p) for p in argv[:2])
    pairs = int(argv[argv.index("--pairs") + 1]) if "--pairs" in argv else 10
    rounds = argv[argv.index("--rounds") + 1] if "--rounds" in argv else "5"
    for tree in (a, b):
        run_child(tree, "--build")
    runs: dict[str, list[dict]] = {a: [], b: []}
    order = [(a, b) if i % 2 == 0 else (b, a) for i in range(pairs)]
    for first, second in order:
        for tree in (first, second):
            runs[tree].append(run_child(tree, "--rounds", rounds))
    report = {"pairs": pairs, "timed_rounds_per_trial": int(rounds), "a": a, "b": b}
    for label in (*LABELS, *(f"byzantine {x}" for x in BYZANTINE_LABELS)):
        entry = {}
        for arm, tree in (("a", a), ("b", b)):
            entry[arm] = {key: quartiles([r[label][key] for r in runs[tree]])
                          for key in ("round_ms", "fit_ms") if key in runs[tree][0][label]}
            entry[arm]["round_ms_trials"] = [r[label]["round_ms"] for r in runs[tree]]
        entry["b_slower_pairs"] = sum(rb[label]["round_ms"] > ra[label]["round_ms"]
                                      for ra, rb in zip(runs[a], runs[b]))
        report[label] = entry
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0])
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
