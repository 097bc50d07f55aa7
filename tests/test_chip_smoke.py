"""chip_smoke.py's phases at tiny sizes on the CPU.

Everything but the device check runs here: each phase drives the engine and
compares it exactly with its host reference, as it does on the card.  The
scripts that need a GPU are checked to refuse to run without one.
"""

import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as C

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_BLOOM = dict(m=1 << 20, k=1, B=512)


def test_phase_device_on_cpu():
    d = C.phase_device(backend="cpu")
    assert d["platform"] == "cpu" and d["count"] >= 1


def test_phase_device_refuses_without_gpu():
    with pytest.raises(RuntimeError):
        C.phase_device()


def test_phase_main_path_and_materialize(capsys):
    data = C.phase_main_path(5000, 40000)
    C.phase_materialize(*data)
    out = capsys.readouterr().out
    assert "[main PRO 5000x40000 q=1] tier=ht count=40000" in out
    assert "[materialize PRO 5000x40000] tier=materialize pairs=40000" in out


@pytest.mark.parametrize("phase,args", [
    ("phase_flagship", (20000, 200000, 0.01, SMALL_BLOOM)),
    ("phase_sortscan", (5000, 30000)),
    ("phase_ht_nonunique", (2000, 16000)),
    ("phase_key8b", (4096, 30000)),
    ("phase_fullspan", (5000, 40000, 0.01, SMALL_BLOOM)),
    ("phase_cli", ("cpu", 5000, 40000)),
])
def test_phase_exact_at_small_size(phase, args, capsys):
    getattr(C, phase)(*args)
    assert "| exact match vs" in capsys.readouterr().out


def test_phase_four_cards_on_virtual_mesh(eight_devices, capsys):
    C.phase_four_cards(8000, 64000, 0.01, 4, SMALL_BLOOM)
    assert "over 4 devices" in capsys.readouterr().out


def test_check_raises_on_mismatch():
    with pytest.raises(C.Mismatch, match="count: got 1, want 2"):
        C.check("count", 1, 2)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], capture_output=True,
                          text=True, timeout=300, cwd=cwd, env=env)


def _has_result_line(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            json.loads(line)
            return True
        except ValueError:
            pass
    return False


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_script_fails_without_gpu(script):
    proc = _run([script], ROOT)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
    assert "backend 'gpu'" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert not _has_result_line(proc.stdout)
