"""The port's settings (tpfl_torch.settings.Settings) against the JAX
package's: every knob with the same default, the same values after each
of the three profiles, ``snapshot`` / ``restore`` round trips, and
``from_env`` parsing the same environment the same way."""

import ast
import inspect
import logging
import pathlib

import pytest

import tpfl.settings
import tpfl_torch.settings
from tpfl.settings import Settings as JaxSettings
from tpfl_torch.management.logger import _LazyFileHandler, _LazyQueueHandler
from tpfl_torch.settings import UNPORTED_KNOBS, UNPORTED_SWITCHES, Settings

PROFILES = ["set_test_settings", "set_standalone_settings", "set_scale_settings"]


def _knobs(cls) -> list[str]:
    return sorted(k for k in dir(cls) if k.isupper() and not k.startswith("_"))


def _class_defaults(module) -> dict:
    """The knobs' values as the class body writes them (read from the
    source: the live class holds whatever earlier tests assigned)."""
    tree = ast.parse(inspect.getsource(module))
    body = next(n for n in tree.body if isinstance(n, ast.ClassDef) and n.name == "Settings")
    return {n.target.id: eval(compile(ast.Expression(n.value), "<knob>", "eval"))
            for n in body.body if isinstance(n, ast.AnnAssign) and n.target.id.isupper()}


@pytest.fixture(autouse=True)
def _both_settings():
    snaps = (Settings.snapshot(), JaxSettings.snapshot())
    yield
    Settings.restore(snaps[0])
    JaxSettings.restore(snaps[1])


def test_every_knob_with_the_reference_default():
    want = _class_defaults(tpfl.settings)
    got = _class_defaults(tpfl_torch.settings)
    assert sorted(got) == sorted(want) == _knobs(Settings) == _knobs(JaxSettings)
    assert len(got) == 117
    for k, v in want.items():
        assert got[k] == v and type(got[k]) is type(v), k


@pytest.mark.parametrize("profile", PROFILES)
def test_profile_sets_the_reference_values(profile):
    for cls, module in ((Settings, tpfl_torch.settings), (JaxSettings, tpfl.settings)):
        cls.restore(_class_defaults(module))
        getattr(cls, profile)()
    assert Settings.snapshot() == JaxSettings.snapshot()


@pytest.mark.parametrize("first,second", [(a, b) for a in PROFILES for b in PROFILES if a != b])
def test_profile_switch_leaks_nothing(first, second):
    """Profile totality: switching profiles gives the second profile's
    values whatever ran first, as in the reference."""
    getattr(Settings, first)()
    getattr(Settings, second)()
    getattr(JaxSettings, second)()
    assert Settings.snapshot() == JaxSettings.snapshot()


def test_snapshot_restore_round_trip():
    snap = Settings.snapshot()
    assert set(snap) == set(_knobs(Settings))
    Settings.set_scale_settings()
    Settings.SEED = 1234
    assert Settings.snapshot() != snap
    Settings.restore(snap)
    assert Settings.snapshot() == snap


ENV = {"TPFL_DISABLE_SIMULATION": "true", "TPFL_TRAIN_SET_SIZE": "7",
       "TPFL_ROUND_QUORUM": "0.75", "TPFL_SEED": "42", "TPFL_AGGREGATION_STALL": "2.5",
       "TPFL_ELECTION": "hash", "TPFL_WIRE_DTYPE": "bfloat16", "TPFL_FILE_LOGGER": "0",
       "TPFL_LOG_LEVEL": "ERROR"}


@pytest.mark.parametrize("name", sorted(ENV))
def test_from_env_parses_like_the_reference(name, monkeypatch):
    Settings.restore(JaxSettings.snapshot())
    monkeypatch.setenv(name, ENV[name])
    Settings.from_env()
    JaxSettings.from_env()
    knob = name[len("TPFL_"):]
    got, want = getattr(Settings, knob), getattr(JaxSettings, knob)
    assert got == want and type(got) is type(want)
    assert Settings.snapshot() == JaxSettings.snapshot()


def _reads(package: str) -> set[str]:
    """The knobs a package's code reads as ``Settings.<KNOB>`` (code, not
    docs), outside its settings module."""
    root = pathlib.Path(__file__).resolve().parent.parent / package
    return {node.attr for path in root.rglob("*.py") if path.name != "settings.py"
            for node in ast.walk(ast.parse(path.read_text()))
            if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name)
            and node.value.id == "Settings"}


def test_every_knob_is_read_or_listed_unported():
    """A knob the port does not read is in UNPORTED_KNOBS (and then no
    port module reads it); every other knob has a reader or is a switch
    that ``Settings.refuse_unported`` checks."""
    port, reference = _reads("tpfl_torch"), _reads("tpfl")
    for knob in _knobs(Settings):
        if knob in UNPORTED_KNOBS:
            assert knob not in port, knob
            if UNPORTED_KNOBS[knob] is None:
                assert knob not in reference, knob
        else:
            assert knob in port or knob in UNPORTED_SWITCHES, knob
    assert not set(UNPORTED_KNOBS) & set(UNPORTED_SWITCHES)


def test_file_logger_writes_a_rotating_file_only_while_on(tmp_path):
    Settings.LOG_DIR = str(tmp_path / "logs")
    handler = _LazyFileHandler()
    record = logging.LogRecord("tpfl_torch", logging.INFO, __file__, 1, "hello", None, None)
    record.node = "n-0"
    Settings.FILE_LOGGER = False
    handler.emit(record)
    assert not (tmp_path / "logs").exists()
    Settings.FILE_LOGGER = True
    handler.emit(record)
    handler.close()
    (log,) = (tmp_path / "logs").iterdir()
    assert log.read_text().rstrip().endswith("|INFO|n-0] hello")


def test_async_logger_starts_its_listener_at_the_first_record():
    got = []

    class Keep(logging.Handler):
        def emit(self, record: logging.LogRecord) -> None:
            got.append(record.getMessage())

    handler = _LazyQueueHandler([Keep()])
    assert not handler.listener._thread
    handler.handle(logging.LogRecord("tpfl_torch", logging.INFO, __file__, 1, "hi %s",
                                     ("there",), None))
    assert handler.listener._thread is not None
    handler.stop()
    handler.stop()  # idempotent
    assert got == ["hi there"] and handler.listener._thread is None
