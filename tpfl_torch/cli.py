"""tpfl_torch command-line interface — the port of :mod:`tpfl.cli`.

    tpfl-torch experiment list
    tpfl-torch experiment help NAME
    tpfl-torch experiment run [--profile DIR] NAME [-- ARGS...]

The same commands as the reference's (itself the parity of p2pfl's
``experiment list/run/help``), written with ``argparse`` (the port does
not import ``click``). ``run`` starts ``python -m
tpfl_torch.examples.<NAME> ARGS`` in a subprocess and exits with its
code; ``--profile DIR`` hands the child ``TPFL_PROFILING_TRACE_DIR``, so
its experiment writes a ``torch.profiler`` trace into DIR. SIGINT and
SIGTERM are passed on to the child.
"""

from __future__ import annotations

import argparse
import importlib
import os
import pkgutil
import signal
import subprocess
import sys
from typing import Any, Optional


def _discover_examples() -> dict[str, str]:
    import tpfl_torch.examples as ex

    return {m.name: f"tpfl_torch.examples.{m.name}"
            for m in pkgutil.iter_modules(ex.__path__) if not m.name.startswith("_")}


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpfl-torch",
                                description="tpfl_torch — peer-to-peer federated learning "
                                "on PyTorch.")
    groups = p.add_subparsers(dest="group", required=True)
    exp = groups.add_parser("experiment", help="Run bundled example experiments.")
    cmds = exp.add_subparsers(dest="command", required=True)
    cmds.add_parser("list", help="List bundled experiments.")
    help_cmd = cmds.add_parser("help", help="Show an experiment's description.")
    help_cmd.add_argument("name")
    run = cmds.add_parser("run", help="Run an experiment in a subprocess.")
    run.add_argument("--profile", dest="profile_dir", metavar="DIR", default=None,
                     help="write a torch.profiler trace of the run's experiment to DIR")
    run.add_argument("name")
    run.add_argument("args", nargs=argparse.REMAINDER,
                     help="arguments for the experiment (after --)")
    return p


def _run(name: str, profile_dir: Optional[str], args: list[str]) -> int:
    env = dict(os.environ)
    if profile_dir:
        # The trace happens in the CHILD: the examples apply
        # Settings.from_env() after their profile, and the stage workflow
        # wraps the experiment in torch.profiler.
        env["TPFL_PROFILING_TRACE_DIR"] = profile_dir
    if args[:1] == ["--"]:
        args = args[1:]
    child = subprocess.Popen([sys.executable, "-m", _discover_examples()[name], *args],
                             env=env)

    def forward(signum: int, frame: Any) -> None:
        child.send_signal(signum)

    previous = {s: signal.signal(s, forward) for s in (signal.SIGINT, signal.SIGTERM)}
    try:
        return child.wait()
    finally:
        for s, h in previous.items():
            signal.signal(s, h)


def main(argv: Optional[list[str]] = None) -> int:
    """The CLI's entry point (``[project.scripts] tpfl-torch``); returns
    the exit code (and exits with it when run as a script)."""
    ns = _parser().parse_args(argv)
    examples = _discover_examples()
    if ns.command == "list":
        for name in sorted(examples):
            print(name)
        return 0
    if ns.name not in examples:
        print(f"Error: Unknown experiment '{ns.name}'", file=sys.stderr)
        return 1
    if ns.command == "help":
        print(importlib.import_module(examples[ns.name]).__doc__ or "(no description)")
        return 0
    return _run(ns.name, ns.profile_dir, ns.args)


if __name__ == "__main__":
    sys.exit(main())
