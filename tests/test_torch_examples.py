"""The port's CLI (tpfl_torch.cli) and examples (tpfl_torch.examples)
against the JAX package's, on the CPU.

- The CLI: ``experiment list`` prints exactly the names the JAX CLI
  lists; ``help`` prints an example's docstring; an unknown name exits
  non-zero for ``run`` and ``help``; ``run`` hands its arguments after
  ``--`` to the example's module and exits with its code.
- ``digits`` and ``scale`` in process, each run first as the JAX example
  (its MLP at f32, its data from ``rendered_digits``) and then as the
  port's, given through ``data_fn`` the very arrays the JAX example
  rendered (and once more with the port's default data, its own
  ``rendered_digits``) and through ``model_fn`` the JAX example's initial
  params,
  with the in-memory address counters of both packages started at the
  same value (learner shuffles and elections derive from addresses):
  every port node's final params allclose to the same node's in the JAX
  run (rtol 1e-4, atol 1e-5, as ``tests/test_torch_node.py``). ``scale``
  runs 6 nodes, all in the train set, so every aggregate folds the same
  models whatever order the partial aggregates arrive in.
- The two-process pairs over gRPC (``tests/test_examples.py:160, :192``):
  node1 as a passive subprocess with node2 driving in process, and
  multislice's slice mode the same way; each passive child stops on
  SIGTERM and exits 0. Multislice's engine mode as a 2-process
  ``gloo`` world.

Every subprocess wait is bounded; children are killed on failure.
"""

import itertools
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpfl.communication.memory as jax_memory
import tpfl.examples.digits as jax_digits
import tpfl.examples.scale as jax_scale
from tpfl.learning.dataset import rendered_digits
from tpfl.models import create_model as jax_create_model
from tpfl.settings import Settings as JaxSettings
from tpfl_torch import cli
from tpfl_torch.communication import memory
from tpfl_torch.examples import digits, multislice, node2, scale
from tpfl_torch.interop import model_state_from_jax
from tpfl_torch.learning.dataset import TpflDataset
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.models import MLP
from tpfl_torch.settings import Settings
from tpfl_torch.utils.tree import tree_items

REPO = Path(__file__).resolve().parents[1]
RTOL, ATOL = 1e-4, 1e-5


# Timing knobs both packages' examples read after their profile
# (``Settings.from_env``): shorter waits, the same results. The gossip
# stage's static exit bounds the push a finished peer's re-announced
# init status can prolong (30 periods in the standalone profile).
FAST_ENV = {"TPFL_WAIT_HEARTBEATS_CONVERGENCE": "0.5", "TPFL_GOSSIP_EXIT_ON_X_EQUAL_ROUNDS": "3",
            "TPFL_GOSSIP_MODELS_PERIOD": "0.2"}


@pytest.fixture(autouse=True)
def _settings(monkeypatch):
    for k, v in FAST_ENV.items():
        monkeypatch.setenv(k, v)
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    memory.clear_registry()
    jax_memory.clear_registry()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    memory.clear_registry()
    jax_memory.clear_registry()
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


# --- the CLI -----------------------------------------------------------------


def test_cli_lists_the_reference_examples(capsys):
    from click.testing import CliRunner

    from tpfl.cli import main as jax_cli

    assert cli.main(["experiment", "list"]) == 0
    ours = capsys.readouterr().out.split()
    theirs = CliRunner().invoke(jax_cli, ["experiment", "list"]).output.split()
    assert ours == theirs
    assert {"digits", "node1", "node2", "scale", "multislice"} <= set(ours)


def test_cli_help_shows_docstring(capsys):
    assert cli.main(["experiment", "help", "digits"]) == 0
    out = capsys.readouterr().out
    assert "digits" in out.lower() and "--protocol" in out


@pytest.mark.parametrize("command", ["run", "help"])
def test_cli_rejects_unknown_experiment(command, capsys):
    assert cli.main(["experiment", command, "nope"]) != 0
    assert "Unknown experiment 'nope'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["experiment"])  # no command


def test_cli_run_passes_arguments_and_exit_code():
    """``run NAME -- ARGS`` starts ``python -m tpfl_torch.examples.NAME
    ARGS``: a bad argument makes the example's parser exit 2, and the CLI
    exits with it."""
    out = subprocess.run([sys.executable, "-m", "tpfl_torch.cli", "experiment", "run",
                          "digits", "--", "--nodes", "not-a-number"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "--nodes: invalid int value" in out.stderr


# --- digits and scale against the JAX examples -------------------------------


def _arrays(ds):
    """A JAX-package TpflDataset's four arrays."""
    def col(train, name):
        return np.asarray(ds.get_split(train).with_format("numpy")[name])
    return col(True, "image"), col(True, "label"), col(False, "image"), col(False, "label")


def _same_addresses(monkeypatch):
    monkeypatch.setattr(jax_memory, "_addr_counter", itertools.count(1))
    monkeypatch.setattr(memory, "_addr_counter", itertools.count(1))


def _f32_jax_models(monkeypatch, module, **model_kw):
    """The JAX example's models at f32; returns the port's ``model_fn``
    giving the same initial params."""
    def f32_create_model(name, shape, seed=0, **kw):
        return jax_create_model(name, shape, seed=seed, compute_dtype=jnp.float32,
                                **{**kw, **model_kw})

    monkeypatch.setattr(module, "create_model", f32_create_model)

    def model_fn(seed):
        init = f32_create_model("mlp", (28, 28), seed=seed)
        port = MLP(hidden_sizes=tuple(init.module.hidden_sizes), out_channels=10,
                   compute_dtype=torch.float32)
        return TpflModel(port, **model_state_from_jax(init, device="cpu"))

    return model_fn


def _finals(nodes):
    return {nd.addr: {p: np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v)
                      for p, v in tree_items(nd.learner.get_model().get_parameters())}
            for nd in nodes}


def _assert_finals_close(got, want):
    assert sorted(got) == sorted(want)
    for addr in want:
        assert got[addr].keys() == want[addr].keys()
        for path in want[addr]:
            np.testing.assert_allclose(got[addr][path], want[addr][path], rtol=RTOL,
                                       atol=ATOL, err_msg=f"{addr} {path}")


DIGITS_ARGS = ["--nodes", "2", "--rounds", "1", "--epochs", "1", "--samples-per-node", "150",
               "--topology", "full", "--aggregator", "fedmedian", "--measure-time"]


def test_digits_matches_the_jax_example(monkeypatch, capsys):
    model_fn = _f32_jax_models(monkeypatch, jax_digits)
    args = jax_digits.parse_args(DIGITS_ARGS)
    rendered = _arrays(rendered_digits(n_train=300, n_test=100, seed=args.seed))
    _same_addresses(monkeypatch)
    want = _finals(jax_digits.digits(args))
    capsys.readouterr()

    def data_fn(n_train, n_test, seed):
        assert (n_train, n_test, seed) == (300, 100, 666)
        return TpflDataset.from_arrays(*rendered)

    _same_addresses(monkeypatch)
    nodes = digits.digits(digits.parse_args(DIGITS_ARGS + ["--device", "cpu"]),
                          data_fn=data_fn, model_fn=model_fn)
    out = capsys.readouterr().out
    assert "Final test accuracy per node" in out and "Global metrics" in out
    assert "seconds ---" in out
    got = _finals(nodes)
    _assert_finals_close(got, want)
    a, b = got.values()
    for path in a:
        np.testing.assert_allclose(a[path], b[path], atol=ATOL)


def test_digits_default_data_matches_the_jax_example(monkeypatch, capsys):
    """No ``data_fn``: the port's default data is the reference's
    ``rendered_digits`` call, so the run ends where the JAX example's does."""
    model_fn = _f32_jax_models(monkeypatch, jax_digits)
    _same_addresses(monkeypatch)
    want = _finals(jax_digits.digits(jax_digits.parse_args(DIGITS_ARGS)))
    _same_addresses(monkeypatch)
    nodes = digits.digits(digits.parse_args(DIGITS_ARGS + ["--device", "cpu"]),
                          model_fn=model_fn)
    assert "Final test accuracy per node" in capsys.readouterr().out
    _assert_finals_close(_finals(nodes), want)


def test_digits_over_tcp_with_a_profile(tmp_path, capsys):
    """The CLI's route in process: ``--protocol tcp`` and ``--profile``
    (a torch.profiler trace of the experiment in DIR/trace.json)."""
    nodes = digits.digits(digits.parse_args(
        ["--nodes", "2", "--rounds", "1", "--samples-per-node", "100", "--protocol", "tcp",
         "--no-show-metrics", "--profile", str(tmp_path), "--device", "cpu"]))
    assert all(nd.addr.startswith("127.0.0.1:") for nd in nodes)
    assert (tmp_path / "trace.json").stat().st_size > 0
    assert "Final test accuracy per node" in capsys.readouterr().out


SCALE_ARGS = ["--nodes", "6", "--rounds", "1", "--epochs", "1", "--samples-per-node", "32",
              "--train-set-size", "6", "--heartbeat-period", "0.5"]


def test_scale_matches_the_jax_example(monkeypatch):
    model_fn = _f32_jax_models(monkeypatch, jax_scale, hidden_sizes=(64,))
    rendered = _arrays(rendered_digits(n_train=6 * 32, n_test=200, seed=666))
    made = {}

    def keep(module, cls):
        class Kept(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.setdefault(module, []).append(self)
        monkeypatch.setattr(module, "Node", Kept)

    keep(jax_scale, jax_scale.Node)
    keep(scale, scale.Node)
    _same_addresses(monkeypatch)
    jax_stats = jax_scale.scale(jax_scale.parse_args(SCALE_ARGS))
    _same_addresses(monkeypatch)
    stats = scale.scale(scale.parse_args(SCALE_ARGS + ["--device", "cpu"]),
                        data_fn=lambda n_train, n_test, seed: TpflDataset.from_arrays(*rendered),
                        model_fn=model_fn)
    assert stats["nodes"] == 6 and stats["election"] == "hash" and stats["rounds_per_sec"] > 0
    assert 0 < jax_stats["model_agreement"] <= 1 and 0 < stats["model_agreement"] <= 1
    # Every node trains (train set = nodes), so every aggregate folds the
    # same six models; byte agreement varies with the fold order of the
    # partial aggregates (reported, not gated, as in the reference).
    _assert_finals_close(_finals(made[scale]), _finals(made[jax_scale]))


def test_scale_default_data_matches_the_jax_example(monkeypatch):
    """``scale`` without ``data_fn``: the port renders the reference's data."""
    model_fn = _f32_jax_models(monkeypatch, jax_scale, hidden_sizes=(64,))
    made = {}

    def keep(module, cls):
        class Kept(cls):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made.setdefault(module, []).append(self)
        monkeypatch.setattr(module, "Node", Kept)

    keep(jax_scale, jax_scale.Node)
    keep(scale, scale.Node)
    _same_addresses(monkeypatch)
    jax_scale.scale(jax_scale.parse_args(SCALE_ARGS))
    _same_addresses(monkeypatch)
    stats = scale.scale(scale.parse_args(SCALE_ARGS + ["--device", "cpu"]), model_fn=model_fn)
    assert stats["nodes"] == 6 and stats["rounds_per_sec"] > 0
    _assert_finals_close(_finals(made[scale]), _finals(made[jax_scale]))


# --- the two-process pairs over TCP ------------------------------------------


def _free_ports(n):
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def _spawn(module, args):
    """``python -m tpfl_torch.examples.<module> ARGS`` writing to a temp
    file (unbuffered, so the caller can poll for its banner)."""
    log = tempfile.NamedTemporaryFile(mode="w+", suffix=f"-{module}.log", delete=False)
    env = {**os.environ, "PYTHONUNBUFFERED": "1"}
    proc = subprocess.Popen([sys.executable, "-u", "-m", f"tpfl_torch.examples.{module}", *args],
                            stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO)
    return proc, log.name


def _wait_listening(proc, log_path, timeout=120):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and proc.poll() is None:
        if "listening" in Path(log_path).read_text():
            return
        time.sleep(0.2)
    raise AssertionError(f"passive child not listening within {timeout}s; log:\n"
                         + Path(log_path).read_text()[-2000:])


def _stop(proc, log_path):
    """SIGTERM the passive child: it stops its node and exits 0."""
    proc.send_signal(signal.SIGTERM)
    try:
        rc = proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)
        raise
    text = Path(log_path).read_text()
    os.unlink(log_path)
    assert rc == 0, text[-2000:]
    assert "listening" in text


def test_node1_node2_pair_over_tcp():
    """The node1 / node2 pair as a user runs it; both dial gRPC, as the
    reference's do (the name is kept from when the pair dialled TCP)."""
    p1, p2 = _free_ports(2)
    proc, log = _spawn("node1", ["--port", str(p1), "--samples", "200", "--device", "cpu"])
    try:
        _wait_listening(proc, log)
        metrics = node2.main(["--port", str(p2), "--connect-to", f"127.0.0.1:{p1}",
                              "--rounds", "1", "--epochs", "1", "--samples", "200",
                              "--device", "cpu"])
        assert np.isfinite(metrics["test_loss"])
    finally:
        if proc.poll() is None:
            _stop(proc, log)
    assert proc.returncode == 0


def test_multislice_pair_over_tcp():
    """The slice-mode pair (``--mode grpc``, the reference's only slice
    mode; the name is kept from when slice mode ran over TCP)."""
    p1, p2 = _free_ports(2)
    proc, log = _spawn("multislice", ["--port", str(p1), "--local-nodes", "4",
                                      "--samples", "400", "--device", "cpu"])
    try:
        _wait_listening(proc, log)
        metrics = multislice.main(["--port", str(p2), "--connect-to", f"127.0.0.1:{p1}",
                                   "--local-nodes", "4", "--rounds", "1", "--epochs", "1",
                                   "--samples", "400", "--device", "cpu"])
        assert np.isfinite(metrics["test_loss"])
    finally:
        if proc.poll() is None:
            _stop(proc, log)
    assert proc.returncode == 0


def test_multislice_engine_mode_two_processes():
    (port,) = _free_ports(1)
    args = ["--coordinator", f"127.0.0.1:{port}", "--num-processes", "2", "--rounds", "1",
            "--local-nodes", "2", "--samples", "400", "--device", "cpu"]
    procs = [subprocess.Popen([sys.executable, "-m", "tpfl_torch.examples.multislice", *args,
                               "--process-id", str(r)], cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=10)
    assert [p.returncode for p in procs] == [0, 0], outs
    assert "engine mode: 4 nodes over mesh {'hosts': 2, 'nodes': 1} (2 processes" in outs[0]
    assert "engine mode" not in outs[1]  # rank 0 reports
