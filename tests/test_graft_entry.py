"""Tests for the entry points in __graft_entry__.py.

dryrun_multichip must set up its own 8-device virtual CPU mesh, so these
tests also call it from a fresh interpreter with XLA_FLAGS stripped
(`python -c`); a regression in that set-up fails here first.
"""
import os
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _driver_env():
    env = dict(os.environ)
    # conftest may have set XLA_FLAGS for this process — strip it so the
    # subprocess must set up its devices on its own.
    env.pop("XLA_FLAGS", None)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_dryrun_multichip_fresh_interpreter():
    code = ("import __graft_entry__ as g; g.dryrun_multichip(8)")
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=_driver_env(),
        capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (
        "dryrun_multichip(8) failed from a bare interpreter:\n"
        "stdout:\n{}\nstderr:\n{}".format(proc.stdout, proc.stderr))
    assert "dryrun_multichip(8) OK" in proc.stdout


def test_dryrun_multichip_in_process():
    # Also callable in-process where conftest already set up the 8-device
    # CPU backend (the set-up must tolerate an initialized backend).
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_entry_forward_runs_on_seeded_weights():
    import jax

    import __graft_entry__ as g

    fn, (params, images) = g.entry()
    out = jax.jit(fn)(params, images)
    assert out.shape == images.shape[:3] + (1,)
    assert np.isfinite(np.asarray(out)).all()
    assert params["fuse_skip_layers"]["kernel"].shape == (1, 1, 160, 1)
