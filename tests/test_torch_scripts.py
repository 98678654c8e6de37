"""The port's scripts (``scripts/*_torch.py``) on the CPU.

``transport_smoke_torch.py`` runs as a CI gate runs it, in a process of its
own: at ``--device cpu`` its drill passes (exit 0) and its daemon child is
gone afterwards; with the daemon made to hang at start-up (a
``sitecustomize`` that sleeps in the daemon's interpreter only) the wall
clock ends it with exit 124 within ``--timeout``.

``perf_probe_torch.py`` writes the JSON of ``scripts/perf_probe.py`` (the
same keys, the same ``top_tensors`` entries) for one depth-scaled cell, and
its roofline is ``dryrun.run_cell_process``'s of the same cell at one
microbatch.  With no card both scripts refuse to run unless they are given
``--device cpu``."""

import json
import os
import runpy
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "scripts" / "transport_smoke_torch.py"
PROBE = ROOT / "scripts" / "perf_probe_torch.py"
# the keys scripts/perf_probe.py writes (its memory_pass only with --memory-pass)
PROBE_KEYS = {"tag", "arch", "shape", "layers", "mesh", "compile_s", "roofline",
              "collective_sites", "top_tensors"}
HANG = """import sys, time
if "repro_torch.core.daemon" in sys.orig_argv:
    time.sleep(600)  # the replica daemon never announces its port
"""


def _pid_gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    return False


def test_transport_smoke_passes_and_reaps_its_daemon():
    out = subprocess.run(
        [sys.executable, str(SMOKE), "--device", "cpu", "--merges", "2", "--rows", "200"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.strip().splitlines()
    assert lines[-1] == "transport smoke: PASS"
    evidence = json.loads("\n".join(lines[:-1]))
    assert evidence["converged_identical"] and evidence["child_reaped"]
    assert evidence["ledger"]["frames"] > 0 and evidence["ledger"]["nacks"] == 0
    assert evidence["delivery"]["status"] == "healthy"
    assert _pid_gone(evidence["child_pid"])


def test_transport_smoke_exits_124_when_the_daemon_hangs(tmp_path):
    (tmp_path / "sitecustomize.py").write_text(HANG)
    env = {**os.environ, "PYTHONPATH": str(tmp_path)}
    timeout = 5.0
    err_path = tmp_path / "stderr.txt"
    t0 = time.monotonic()
    # output to a file, not a pipe: the hung child inherits it and holds it open
    with open(err_path, "w") as err_file:
        proc = subprocess.Popen(
            [sys.executable, str(SMOKE), "--device", "cpu", "--timeout", str(timeout)],
            cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err_file,
            start_new_session=True)
    try:
        proc.wait(timeout=120)
        elapsed = time.monotonic() - t0
    finally:
        # the hung child outlives the script (os._exit skips its teardown):
        # end the whole session, as a CI job's teardown does
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    err = err_path.read_text()
    assert proc.returncode == 124, err
    assert f"exceeded the {timeout:.0f}s wall clock" in err
    assert elapsed < timeout + 60  # the clock starts after the imports


def test_perf_probe_writes_the_originals_keys_and_the_dryruns_roofline(tmp_path):
    argv = ["--device", "cpu", "--arch", "gemma-2b", "--shape", "train_4k", "--layers", "1",
            "--tag", "probe"]
    # the probe and the dry-run's own cell, each a child interpreter, at once
    probe = subprocess.Popen([sys.executable, str(PROBE), *argv], cwd=tmp_path,
                             env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        cell = dryrun.run_cell_process("gemma-2b", "train_4k", "single", layers=1,
                                       microbatches=1)
        out, err = probe.communicate(timeout=600)
    finally:
        probe.kill()
        probe.wait()
    assert "error" not in cell, cell.get("error")
    assert probe.returncode == 0, err
    assert out.splitlines()[-1] == "wrote results/perf_iters/probe.json"
    got = json.loads((tmp_path / "results" / "perf_iters" / "probe.json").read_text())
    assert set(got) == PROBE_KEYS
    assert (got["tag"], got["arch"], got["shape"], got["layers"], got["mesh"]) == (
        "probe", "gemma-2b", "train_4k", 1, "single")
    assert got["roofline"] == cell["roofline"]
    assert got["collective_sites"] == cell["collective_sites"]
    assert [(t["shape"], t["count"]) for t in got["top_tensors"]] == [
        (s, c) for s, _, c in cell["top_tensors"]]
    assert all(set(t) == {"shape", "GiB", "count"} for t in got["top_tensors"])


@pytest.mark.parametrize("script", [SMOKE, PROBE])
def test_script_refuses_without_a_card(script, monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    g = runpy.run_path(str(script), run_name=script.stem)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if script == SMOKE:
            g["drill"](1, 10, "cuda", {})
        else:
            g["main"](["--arch", "gemma-2b", "--tag", "t"])
