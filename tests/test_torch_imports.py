"""The port stands alone: every ``repro_torch`` module, ``chip_smoke`` and
``chip_profile`` import with JAX made unimportable, and load neither ``jax``
nor anything of the JAX package ``repro``.  Entry points default to the card
and raise when there is none."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

_PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any import of jax now raises
sys.path.insert(0, sys.argv[1])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke, chip_profile
leaked = sorted(k for k in sys.modules
                if k == "repro" or k.startswith(("repro.", "jax.", "jaxlib", "flax")))
print(json.dumps({"modules": names, "leaked": leaked,
                  "jax": sys.modules.get("jax", "absent") is None}))
"""


def test_port_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT)], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["leaked"] == [] and res["jax"]
    expected = {
        "repro_torch.core.featurestore", "repro_torch.core.online_store",
        "repro_torch.core.dsl", "repro_torch.convert",
        "repro_torch.kernels.online_lookup.ops", "repro_torch.kernels.rolling_agg.ops",
        "repro_torch.kernels.online_merge.ops", "repro_torch.runtime.supervisor",
        "repro_torch.data.sources",
    }
    assert expected <= set(res["modules"])


def test_no_source_line_imports_jax_or_repro():
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             ROOT / "chip_smoke.py", ROOT / "chip_profile.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith(("jax.", "repro."))
                            or mod == "repro"), f"{f.name}: {s}"


def test_default_device_is_cuda_and_raises_without_card(monkeypatch):
    from repro_torch.core.dsl import DslTransform, RollingAgg
    from repro_torch.core.featurestore import FeatureStore
    from repro_torch.core.online_store import OnlineStore
    from repro_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (
        lambda: FeatureStore("fs"),
        lambda: OnlineStore(),
        lambda: DslTransform("e", "ts", [RollingAgg("s", "x", 10, "sum")]),
        lambda: resolve_device(),
    ):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert OnlineStore(device="cpu").device == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_chip_smoke_refuses_without_card(tmp_path):
    """Without a card, and alone in a directory, the smoke script exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    env = {**os.environ, "PYTHONPATH": ""}
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"), (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            script.write_text((ROOT / "chip_smoke.py").read_text())
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
