"""chip_smoke.py's phases on the CPU at tiny shapes.

On the CPU the product dispatch runs the plain references, so these tests
check the smoke run's own plumbing (CLI calls, file names, dataset
writer, oracles, the four-card comparisons) rather than the kernels; the
script itself refuses to report a result anywhere but on a GPU.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_TINY = """
import chip_smoke as cs
cs.H = cs.W = 32
cs.FRAME_4K = (600, 640)
cs.FRAME_8K = (48, 1152)
cs.K_COMPS = 64
cs.TRITON_CALL = ""      # the CPU path has no Triton call to find
"""


def _run(code, devices):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT,
               XLA_FLAGS="--xla_force_host_platform_device_count=%d"
               % devices)
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def test_refuses_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "no accelerator" in p.stderr


@pytest.mark.parametrize("devices,phases", [
    (1, "decompose filters whdr train"),
    (4, "four_cards"),
])
def test_phases_pass_at_tiny_shapes(devices, phases):
    code = _TINY + """
import os, tempfile
from reflectance_filtering.models.caffe_io import write_seeded_caffemodel
with tempfile.TemporaryDirectory() as d:
    ctx = {"work": d, "weights": write_seeded_caffemodel(
        os.path.join(d, "seeded.caffemodel"), 0)}
    for name in %r.split():
        getattr(cs, "phase_" + name)(ctx)
        print("PHASE", name, flush=True)
""" % phases
    p = _run(code, devices)
    assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
    done = [line.split()[1] for line in p.stdout.splitlines()
            if line.startswith("PHASE ")]
    assert done == phases.split()


@pytest.mark.parametrize("failing", [None, "whdr"])
def test_result_line_only_when_every_phase_passes(monkeypatch, capsys,
                                                  failing):
    """main() ends with exactly one JSON object naming the device, and
    prints none (exit 1) when a phase fails."""
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke as cs

    def phase(name):
        def run(ctx):
            if name == failing:
                raise RuntimeError("phase failed on purpose")
        return run

    class Dev:
        platform, device_kind = "gpu", "Test Card"

    monkeypatch.setattr("jax.devices", lambda *a: [Dev()])
    monkeypatch.setattr("subprocess.run", lambda *a, **k: type(
        "R", (), {"stdout": "Test Card, 700.00 W\n"})())
    for name in ("decompose", "filters", "whdr", "train"):
        monkeypatch.setattr(cs, "phase_" + name, phase(name))
    monkeypatch.setattr(
        "reflectance_filtering.utils.compile_cache."
        "enable_persistent_compilation_cache", lambda: "cache")
    rc = cs.main([])
    lines = capsys.readouterr().out.strip().splitlines()
    assert "card: Test Card, 700.00 W" in lines
    if failing:
        assert rc == 1
        assert not any(line.startswith("{") for line in lines)
        assert lines[-1] == "failed phases: " + failing
    else:
        assert rc == 0
        assert json.loads(lines[-1]) == {
            "ok": True, "device": {"platform": "gpu", "kind": "Test Card",
                                   "count": 1}}
