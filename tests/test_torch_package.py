"""Package rules of the PyTorch port: it imports nothing of JAX and
nothing of the JAX package, and it never runs on the CPU unless asked.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tpfl_torch

REPO = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import tpfl_torch
mods = [m.name for m in pkgutil.walk_packages(tpfl_torch.__path__, "tpfl_torch.")]
for m in mods:
    importlib.import_module(m)
import chip_smoke
banned = sorted(
    m for m in sys.modules
    if m in ("jax", "jaxlib", "flax", "optax", "tpfl", "msgpack", "datasets", "zstandard",
             "ml_dtypes", "psutil", "click", "grpc", "PIL", "matplotlib", "cryptography",
             "pyarrow", "pandas", "dateutil")
    or m.startswith(("jax.", "jaxlib.", "flax.", "optax.", "tpfl.", "msgpack.", "datasets.",
                     "zstandard.", "ml_dtypes.", "psutil.", "click.", "grpc.", "PIL.",
                     "matplotlib.", "cryptography.", "pyarrow.", "pandas.", "dateutil."))
)
print(json.dumps({"modules": mods, "banned": banned}))
"""


def test_port_imports_no_jax_and_nothing_of_tpfl():
    """Every tpfl_torch module and chip_smoke's imports, in a fresh
    interpreter (this test process has jax loaded by conftest)."""
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120, check=True,
    )
    report = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("parallel.conv_kernel", "parallel.engine", "parallel.flash_kernel",
                "parallel.ring_attention", "parallel.distributed", "parallel.mesh",
                "parallel.pipeline", "parallel.moe", "models.zoo", "utils.tree", "interop",
                "learning.compression", "settings", "exceptions", "concurrency",
                "learning.bufferpool", "learning._msgpack", "learning.serialization",
                "learning.model", "learning.callbacks", "learning.learner",
                "learning.torch_learner", "learning.dataset.export",
                "learning.dataset.rendered", "learning.dataset.dates",
                "learning.dataset.snappy", "learning.dataset.parquet",
                "learning.dataset.png", "learning.dataset.jpeg", "learning.dataset.images",
                "learning.dataset.hf_features",
                "learning.dataset.tpfl_dataset", "management.logger",
                "learning.aggregators.aggregator", "learning.aggregators.fedavg",
                "learning.aggregators.fedprox", "learning.aggregators.scaffold",
                "learning.aggregators.fedmedian", "learning.aggregators.robust",
                "learning.dataset.partition_strategies", "utils.threefry",
                "attacks", "attacks.attacks", "attacks.plan", "management.ledger",
                "management.quarantine", "experiment", "node", "node_state",
                "communication", "communication.base", "communication.commands",
                "communication.gossiper", "communication.heartbeater",
                "communication.memory", "communication.message",
                "communication.neighbors", "communication.protocol",
                "communication.resilience", "stages", "stages.stage", "stages.base_node",
                "utils.topologies", "utils.utils", "management.metric_storage",
                "management.profiling", "management.tracing", "simulation",
                "management.fleetobs", "management.node_monitor",
                "management.web_services", "parallel.crosshost", "parallel.ranksafe",
                "parallel.sharded", "parallel.scaling", "communication.tcp_transport",
                "utils.certificates", "cli", "examples", "examples.digits",
                "examples.multislice", "examples.node1", "examples.node2", "examples.scale"):
        assert f"tpfl_torch.{mod}" in report["modules"]
    assert report["banned"] == []


def test_sources_name_no_jax_package():
    """Belt and braces over the import probe: no source line of the
    port imports jax, flax, optax or the tpfl package, nor a package the
    card's machine lacks (msgpack, datasets, zstandard, ml_dtypes,
    pyarrow, pandas, dateutil) or the port stands without (psutil,
    click, grpc, PIL, matplotlib, cryptography)."""
    banned = {"jax", "jaxlib", "flax", "optax", "tpfl", "msgpack", "datasets", "zstandard",
              "ml_dtypes", "psutil", "click", "grpc", "PIL", "matplotlib", "cryptography",
              "pyarrow", "pandas", "dateutil"}
    files = list((REPO / "tpfl_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            words = line.split("#")[0].split()
            if len(words) >= 2 and words[0] in ("import", "from"):
                root = words[1].split(".")[0].rstrip(",")
                assert root not in banned, (str(f), line)


@pytest.mark.parametrize("entry", ["engine", "federation", "create_model", "interop",
                                   "transformer_lm", "resnet18_state", "scaffold",
                                   "tpfl_model", "torch_learner", "fedavg", "scaffold_agg",
                                   "fedmedian", "fedprox", "krum", "multikrum",
                                   "trimmedmean", "random_bits", "node", "dispatch_rtt",
                                   "timed_loop", "mfu", "crosshost_launch",
                                   "from_torch_state_dict", "from_keras_weights",
                                   "example_model"])
def test_entry_points_require_a_card_by_default(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from tpfl_torch.examples._common import make_model
    from tpfl_torch.interop import from_keras_weights, from_torch_state_dict, params_from_flax
    from tpfl_torch.learning.aggregators import (FedAvg, FedMedian, FedProx, Krum, MultiKrum,
                                                 Scaffold, TrimmedMean)
    from tpfl_torch.learning.dataset import TpflDataset
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner
    from tpfl_torch.management import profiling
    from tpfl_torch.node import Node
    from tpfl_torch.models import CNN, ResNet18, TransformerLM, create_model, init_state
    from tpfl_torch.parallel import FederationEngine, VmapFederation, crosshost
    from tpfl_torch.parallel.flash_kernel import flash_attention
    from tpfl_torch.utils import threefry

    calls = {
        "engine": lambda: FederationEngine(CNN(), 2),
        "federation": lambda: VmapFederation(CNN(), 2),
        "create_model": lambda: create_model("cnn", (32, 32, 3)),
        "interop": lambda: params_from_flax({}),
        "transformer_lm": lambda: VmapFederation(
            TransformerLM(attention_fn=flash_attention), 2).init_params((16,)),
        "resnet18_state": lambda: init_state(ResNet18(), (32, 32, 3)),
        "scaffold": lambda: VmapFederation(CNN(), 2, algorithm="scaffold"),
        "tpfl_model": lambda: TpflModel(CNN()),
        "torch_learner": lambda: TorchLearner(),
        "fedavg": lambda: FedAvg("n"),
        "scaffold_agg": lambda: Scaffold("n"),
        "fedmedian": lambda: FedMedian("n"),
        "fedprox": lambda: FedProx("n"),
        "krum": lambda: Krum("n"),
        "multikrum": lambda: MultiKrum("n"),
        "trimmedmean": lambda: TrimmedMean("n"),
        "random_bits": lambda: threefry.random_bits(threefry.PRNGKey(0), (4,)),
        "node": lambda: Node(TpflModel(CNN(), {}, device="cpu"), TpflDataset.from_arrays(
            np.zeros((2, 8, 8, 3), np.float32), np.zeros(2, np.int32),
            np.zeros((1, 8, 8, 3), np.float32), np.zeros(1, np.int32)), addr="no-card"),
        "dispatch_rtt": lambda: profiling.measure_dispatch_rtt(),
        "timed_loop": lambda: profiling.timed_loop(lambda c: c, torch.zeros(1), (), 1),
        "mfu": lambda: profiling.cost_model.record_round("no-card", 1.0, 1.0),
        "crosshost_launch": lambda: crosshost.launch(2),
        "from_torch_state_dict": lambda: from_torch_state_dict({}, {}),
        "from_keras_weights": lambda: from_keras_weights({}, []),
        "example_model": lambda: make_model("mlp", 0, None),
    }
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calls[entry]()


def test_cpu_is_explicit():
    assert tpfl_torch.resolve_device("cpu").type == "cpu"


def test_chip_smoke_refuses_without_a_card():
    """``python3 chip_smoke.py`` exits non-zero and prints no result
    line when no card is present."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
