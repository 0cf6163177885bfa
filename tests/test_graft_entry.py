"""The multi-chip dryrun must be hermetic: forced CPU mesh, never the
accelerator.

A dryrun that fell back to ``jax.devices()`` would initialize (and hold)
the real accelerator. These tests pin the child environment contract
without paying for a real child compile.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import __graft_entry__ as graft


class _FakeProc:
    def __init__(self, rc):
        self.returncode = rc


def _capture_child(monkeypatch, rc=0):
    calls = {}

    def fake_run(argv, env=None, cwd=None, timeout=None):
        calls["argv"] = argv
        calls["env"] = env
        calls["cwd"] = cwd
        return _FakeProc(rc)

    monkeypatch.setattr(graft.subprocess, "run", fake_run)
    monkeypatch.delenv(graft._CHILD_ENV_FLAG, raising=False)
    return calls


def test_child_env_forces_cpu_mesh(monkeypatch):
    monkeypatch.setenv("XLA_FLAGS",
                       "--xla_force_host_platform_device_count=3 --foo=1")
    monkeypatch.setenv("PYTHONPATH", "extra_site")
    calls = _capture_child(monkeypatch)

    graft.dryrun_multichip(8)

    env = calls["env"]
    assert env["JAX_PLATFORM_NAME"] == "cpu"
    assert env["JAX_PLATFORMS"] == "cpu"
    # Stale force-host flags replaced with the requested count; other
    # XLA flags preserved.
    assert "--xla_force_host_platform_device_count=8" in env["XLA_FLAGS"]
    assert "device_count=3" not in env["XLA_FLAGS"]
    assert "--foo=1" in env["XLA_FLAGS"]
    # PYTHONPATH is additive: existing entries stay, repo root prepended.
    parts = env["PYTHONPATH"].split(os.pathsep)
    assert "extra_site" in parts
    assert calls["cwd"] in parts
    assert env[graft._CHILD_ENV_FLAG] == "1"
    assert "_dryrun_multichip_impl(8)" in calls["argv"][-1]


def test_child_failure_raises(monkeypatch):
    calls = _capture_child(monkeypatch, rc=7)
    with pytest.raises(RuntimeError, match="rc=7"):
        graft.dryrun_multichip(4)
    assert calls["env"][graft._CHILD_ENV_FLAG] == "1"


def test_no_default_backend_fallback_in_impl():
    """The impl must never query the default (accelerator) backend."""
    import inspect

    src = inspect.getsource(graft._dryrun_multichip_impl)
    assert 'jax.devices("cpu")' in src
    assert "jax.devices()" not in src
