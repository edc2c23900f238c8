"""Shared test config.

If `hypothesis` is unavailable (bare CI/container environments), install a
minimal stand-in whose `@given` marks the property-based tests as skipped —
the rest of each module still collects and runs.
"""
import sys
import types

import pytest

try:
    import hypothesis  # noqa: F401
except ImportError:
    def given(*_args, **_kwargs):
        def deco(fn):
            return pytest.mark.skip(
                reason="hypothesis not installed; property test skipped")(fn)
        return deco

    def settings(*_args, **_kwargs):
        def deco(fn):
            return fn
        return deco

    def _strategy_stub(*_args, **_kwargs):
        return None

    strategies = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "booleans", "sampled_from", "lists",
                  "tuples", "just", "one_of", "composite", "data", "text"):
        setattr(strategies, _name, _strategy_stub)

    shim = types.ModuleType("hypothesis")
    shim.given = given
    shim.settings = settings
    shim.strategies = strategies
    sys.modules["hypothesis"] = shim
    sys.modules["hypothesis.strategies"] = strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "timeout(seconds): fail the test if it exceeds the wall-clock "
        "budget (SIGALRM stand-in for pytest-timeout, which this "
        "environment does not ship)")
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (the port's kernels); skips without one")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    """Arm a SIGALRM around @pytest.mark.timeout(N) tests so a hung engine
    sweep fails with a traceback instead of stalling the whole suite."""
    import signal
    marker = item.get_closest_marker("timeout")
    if marker is None or not hasattr(signal, "SIGALRM"):
        yield
        return
    seconds = int(marker.args[0]) if marker.args \
        else int(marker.kwargs.get("seconds", 60))

    def _on_alarm(signum, frame):
        raise TimeoutError(f"test exceeded {seconds}s wall-clock budget")

    old = signal.signal(signal.SIGALRM, _on_alarm)
    signal.alarm(seconds)
    try:
        yield
    finally:
        signal.alarm(0)
        signal.signal(signal.SIGALRM, old)
