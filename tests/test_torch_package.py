"""Package rules of the PyTorch port: it imports nothing of JAX and
nothing of the JAX package, and it never runs on the CPU unless asked.
"""

import json
import subprocess
import sys
from pathlib import Path

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
             "ml_dtypes")
    or m.startswith(("jax.", "jaxlib.", "flax.", "optax.", "tpfl.", "msgpack.", "datasets.",
                     "zstandard.", "ml_dtypes."))
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
                "parallel.ring_attention", "models.zoo", "utils.tree", "interop",
                "learning.compression", "settings", "exceptions", "concurrency",
                "learning.bufferpool", "learning._msgpack", "learning.serialization",
                "learning.model", "learning.callbacks", "learning.learner",
                "learning.torch_learner", "learning.dataset.export",
                "learning.dataset.tpfl_dataset", "management.logger",
                "learning.aggregators.aggregator", "learning.aggregators.fedavg",
                "learning.aggregators.fedprox", "learning.aggregators.scaffold",
                "learning.aggregators.fedmedian", "learning.aggregators.robust",
                "learning.dataset.partition_strategies", "utils.threefry",
                "attacks", "attacks.attacks", "attacks.plan", "management.ledger",
                "management.quarantine"):
        assert f"tpfl_torch.{mod}" in report["modules"]
    assert report["banned"] == []


def test_sources_name_no_jax_package():
    """Belt and braces over the import probe: no source line of the
    port imports jax, flax, optax or the tpfl package, nor a package the
    card's machine lacks (msgpack, datasets, zstandard, ml_dtypes)."""
    banned = {"jax", "jaxlib", "flax", "optax", "tpfl", "msgpack", "datasets", "zstandard",
              "ml_dtypes"}
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
                                   "trimmedmean", "random_bits"])
def test_entry_points_require_a_card_by_default(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from tpfl_torch.interop import params_from_flax
    from tpfl_torch.learning.aggregators import (FedAvg, FedMedian, FedProx, Krum, MultiKrum,
                                                 Scaffold, TrimmedMean)
    from tpfl_torch.learning.model import TpflModel
    from tpfl_torch.learning.torch_learner import TorchLearner
    from tpfl_torch.models import CNN, ResNet18, TransformerLM, create_model, init_state
    from tpfl_torch.parallel import FederationEngine, VmapFederation
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
