"""What the port's examples share: the data they default to, the model
they build, the ``--device`` argument and the passive wait."""

from __future__ import annotations

import argparse
import signal
import time
from typing import Any

from tpfl_torch import DeviceLike
from tpfl_torch.learning.dataset.rendered import rendered_digits
from tpfl_torch.learning.model import TpflModel
from tpfl_torch.models import create_model


def default_data(n_train: int, n_test: int, seed: int) -> Any:
    """The data of a command-line run: the reference's ``rendered_digits``
    at its sample counts and seed, bit-equal to its images."""
    return rendered_digits(n_train=n_train, n_test=n_test, seed=seed)


def make_model(name: str, seed: int, device: DeviceLike, **module_kwargs: Any) -> TpflModel:
    """A zoo model on 28×28 inputs as a :class:`TpflModel` on ``device``."""
    module, params = create_model(name, (28, 28), seed=seed, device=device, **module_kwargs)
    return TpflModel(module, params, device=device)


def add_device_argument(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", type=str, default=None,
                   help="torch device (default: the card; 'cpu' runs the plain PyTorch path)")


def wait_until_stopped() -> None:
    """Sleep until Ctrl-C or SIGTERM (both end the passive wait the same
    way, so the caller's ``finally`` stops its node and the process
    exits 0). Signals after the first are ignored: a terminal's Ctrl-C
    reaches both the CLI and its child, and the CLI passes it on too."""
    def _interrupt(signum: int, frame: Any) -> None:
        for s in (signal.SIGINT, signal.SIGTERM):
            signal.signal(s, signal.SIG_IGN)
        raise KeyboardInterrupt

    for s in (signal.SIGINT, signal.SIGTERM):
        signal.signal(s, _interrupt)
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        pass
