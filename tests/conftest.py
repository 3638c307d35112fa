import os
import sys

# Tests run on the single real CPU device (the dry-run, and only the dry-run,
# forces 512 host devices in its own process).  Multi-device tests spawn
# subprocesses with their own XLA_FLAGS.
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; the test skips itself without one")

# ``hypothesis`` is not installable offline; install a stub that turns the
# property tests into clean skips so the rest of the suite still collects
# and runs everywhere.
try:
    import hypothesis  # noqa: F401
except ImportError:
    import functools
    import inspect
    import types

    import pytest

    def _given(*_args, **_kwargs):
        def deco(fn):
            @functools.wraps(fn)
            def skipped(*a, **k):
                pytest.skip("hypothesis not installed; property test skipped")
            # hide hypothesis-provided params so pytest doesn't demand
            # fixtures for them (an explicit __signature__ wins over
            # __wrapped__ during introspection)
            skipped.__signature__ = inspect.Signature()
            return skipped
        return deco

    def _settings(*_args, **_kwargs):
        return lambda fn: fn

    def _strategy(*_args, **_kwargs):
        return None

    _st = types.ModuleType("hypothesis.strategies")
    for _name in ("integers", "floats", "booleans", "sampled_from", "lists",
                  "tuples", "just", "composite", "one_of", "text", "data"):
        setattr(_st, _name, _strategy)

    _hyp = types.ModuleType("hypothesis")
    _hyp.given = _given
    _hyp.settings = _settings
    _hyp.strategies = _st
    _hyp.assume = lambda *_a, **_k: True
    _hyp.HealthCheck = types.SimpleNamespace(all=lambda: [])
    sys.modules["hypothesis"] = _hyp
    sys.modules["hypothesis.strategies"] = _st
