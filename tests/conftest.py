"""Tier-1 test configuration.

Markers
-------
``slow`` — kernel-sweep / integration tests that take minutes (Pallas
interpret mode, dry-run lowering). The CI smoke target skips them:

    PYTHONPATH=src python -m pytest -q -m "not slow"

The full tier-1 command (ROADMAP.md) runs everything.
"""
import pytest  # noqa: F401  (kept for fixture/plugin extensions)

# lint_fixtures holds intentionally-broken snippets for the laimr-lint
# self-tests (including files named test_*.py inside miniature project
# trees) — they are lint INPUTS, never test modules.
collect_ignore = ["lint_fixtures"]


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: multi-minute kernel/integration sweeps; deselect with "
        "-m 'not slow'")
    config.addinivalue_line(
        "markers",
        "cuda: runs a hand-written CUDA kernel of repro_torch; skips "
        "without a CUDA device (run on the card with -m cuda)")
