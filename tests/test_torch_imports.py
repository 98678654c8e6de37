"""The port stands alone: every ``repro_torch`` module, ``chip_smoke``,
``chip_profile`` and the ``_torch`` examples and scripts import with JAX made
unimportable, and load neither ``jax``
nor anything of the JAX package ``repro``.  Entry points default to the card
and raise when there is none."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the port's counterparts of examples/*.py and scripts/*.py
PORT_SCRIPTS = [ROOT / "examples" / f"{n}_torch.py" for n in (
    "quickstart", "serving_front", "online_serving", "train_lm", "geo_failover")] + [
    ROOT / "scripts" / f"{n}_torch.py" for n in (
        "transport_smoke", "perf_probe", "render_experiments")]

_PROBE = r"""
import importlib, json, pkgutil, runpy, sys
sys.modules["jax"] = None  # any import of jax now raises
sys.path.insert(0, sys.argv[1])
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke, chip_profile
for path in sys.argv[2:]:  # loaded by path; run_name keeps main from running
    runpy.run_path(path, run_name="probe")
leaked = sorted(k for k in sys.modules
                if k == "repro" or k.startswith(("repro.", "jax.", "jaxlib", "flax")))
print(json.dumps({"modules": names, "leaked": leaked,
                  "jax": sys.modules.get("jax", "absent") is None}))
"""


def test_port_imports_without_jax_or_repro():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run(
        [sys.executable, "-c", _PROBE, str(ROOT), *map(str, PORT_SCRIPTS)], cwd=ROOT, env=env,
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
        "repro_torch.data.sources", "repro_torch.core.pit",
        "repro_torch.kernels.pit_join.ops",
        "repro_torch.models.lm", "repro_torch.models.attention",
        "repro_torch.kernels.flash_attn.ops", "repro_torch.launch.serve",
        "repro_torch.data.loader",
        "repro_torch.core.channel", "repro_torch.core.wire",
        "repro_torch.core.replication", "repro_torch.core.facade",
        "repro_torch.core.multihome", "repro_torch.core.daemon",
        "repro_torch.models.losses", "repro_torch.optim.adamw",
        "repro_torch.optim.schedules", "repro_torch.checkpoint.manager",
        "repro_torch.launch.steps", "repro_torch.launch.train",
        "repro_torch.models.mla", "repro_torch.models.moe", "repro_torch.models.ssm",
        "repro_torch.models.encdec",
        "repro_torch.launch.mesh", "repro_torch.models.pspec",
        "repro_torch.models.sharding", "repro_torch.optim.compression",
        "repro_torch.configs.shapes", "repro_torch.launch.specs",
        "repro_torch.launch.roofline", "repro_torch.launch.trace_tools",
        "repro_torch.launch.dryrun",
    }
    assert expected <= set(res["modules"])


def test_no_source_line_imports_jax_or_repro():
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")),
             ROOT / "chip_smoke.py", ROOT / "chip_profile.py", *PORT_SCRIPTS]
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the replica's GET runs the lookup kernel")
    return torch.device("cuda")


@pytest.mark.gpu
def test_geo_drain_and_replica_get_on_card(cuda_device):
    """A small GeoFeatureStore on the card: two write_batch frames drained to
    one replica, whose dump equals the home's; a GET routed to the replica
    launches the lookup kernel once and answers as the home does."""
    from repro_torch.core.assets import (
        Entity, Feature, FeatureSetSpec, MaterializationSettings)
    from repro_torch.core.dsl import UDFTransform
    from repro_torch.core.regions import GeoTopology, Region
    from repro_torch.core.replication import GeoFeatureStore
    from repro_torch.core.table import Table
    from repro_torch.data.sources import SyntheticEventSource
    from repro_torch.kernels.online_lookup import ops as lookup_ops

    topo = GeoTopology(regions={"home": Region("home"), "near": Region("near")},
                       link_latency_ms={("home", "near"): 30.0})
    g = GeoFeatureStore("geo", topology=topo, home_region="home",
                        replica_regions=("near",), device=cuda_device,
                        merge_engine="kernel", online_partitions=4)
    g.register_source(SyntheticEventSource("src"))
    g.create_feature_set(FeatureSetSpec(
        name="fs", version=1, entity=Entity("cust", ("entity_id",)),
        features=(Feature("f0"), Feature("f1")), source_name="src",
        transform=UDFTransform(lambda df, ctx: df, name="id"),
        materialization=MaterializationSettings(True, True)))
    rng = np.random.default_rng(0)
    for cr in (10**7, 10**7 + 1):
        g.write_batch("fs", 1, Table({
            "entity_id": rng.integers(0, 500, 800).astype(np.int64),
            "ts": rng.integers(0, 10**6, 800).astype(np.int64),
            "f0": rng.random(800).astype(np.float32),
            "f1": rng.random(800).astype(np.float32)}), creation_ts=cr)
    g.drain()
    home, near = g.fs.online.dump_all("fs", 1), g.replicator.stores["near"].dump_all("fs", 1)
    for c in home.names:
        np.testing.assert_array_equal(near[c], home[c], err_msg=c)
    ids = [np.arange(600, dtype=np.int64)]
    before = lookup_ops.counter.launches
    vals, found, route = g.get_online_features("fs", 1, ids, consumer_region="near")
    assert route["region"] == "near" and lookup_ops.counter.launches == before + 1
    hv, hf, _ = g.get_online_features("fs", 1, ids, consumer_region="home", use_kernel=False)
    np.testing.assert_array_equal(found, hf)
    np.testing.assert_array_equal(vals, hv)
