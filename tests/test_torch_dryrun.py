"""The port's dry-run (``repro_torch/launch/dryrun.py``, ``specs.py``,
``roofline.py``, ``trace_tools.py``, ``configs/shapes.py``) against the JAX
package's: the shape cells, the stand-in inputs of every arch x shape
(reduced; shapes and dtypes, the port's per-layer leaves against JAX's
stacked ones), the microbatch counts and the roofline arithmetic, equal.
A reduced train cell run on a 1x1 ``fake`` mesh counts exactly the FLOPs
``FlopCounterMode`` counts for a real step on the CPU; on a fake 2x2 mesh
the collective bytes of a row-parallel matmul are the analytic count; a
cell that fails is recorded against its name and the sweep goes on.
Decode cells run on a fake 2x2 mesh, their argument bytes the spec tables'
count; the flash path runs on meta tensors (shapes, SDPA's FLOP formulas)
and a ``pallas_flash`` cell counts a real flash step's FLOPs.  Each
dry-run cell runs in a child interpreter (the ``fake`` backend is a
process-wide world)."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JaxMesh  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import shapes as jshapes  # noqa: E402
from repro.launch import roofline as jrf  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs import shapes  # noqa: E402
from repro_torch.launch import dryrun, roofline, specs, steps  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh  # noqa: E402
from repro_torch.models import api  # noqa: E402

ARCHS = list_archs()
STACKED = {"tail": 1, "enc": 1, "dec": 1, "groups": 2}
ENV = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}


def test_shapes_and_cells_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jshapes.SHAPES.items()}
    assert shapes.LONG_CTX_ARCHS == jshapes.LONG_CTX_ARCHS
    assert shapes.ALL_ARCHS == jshapes.ALL_ARCHS
    for arch in ARCHS:
        assert shapes.cells_for(arch) == jshapes.cells_for(arch)


def _keys(path) -> list:
    return [str(p.key) if hasattr(p, "key") else str(p.idx) for p in path]


def _jax_leaves(tree, prefix=()) -> dict:
    """JAX stand-ins by port name: (shape without the stack dims, dtype)."""
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [*prefix, *_keys(path)]
        head = keys[len(prefix)] if len(keys) > len(prefix) else ""
        k = STACKED.get(head, 0) if prefix != ("cache",) or head in ("tail", "groups") else 0
        for index in np.ndindex(*x.shape[:k]):
            name = ".".join([*keys[:len(prefix) + 1], *map(str, index), *keys[len(prefix) + 1:]]
                            if k else keys)
            out[name] = (tuple(x.shape[k:]), np.dtype(x.dtype).name)
    return out


def _np_dtype(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _port_leaves(kind, args) -> dict:
    out = {}

    def add(name, t):
        out[name] = (tuple(t.shape), _np_dtype(t))

    def tree(prefix, x):
        if isinstance(x, dict):
            for k, v in x.items():
                tree(f"{prefix}.{k}", v)
        elif isinstance(x, list):
            for i, v in enumerate(x):
                tree(f"{prefix}.{i}", v)
        elif isinstance(x, torch.Tensor):
            add(prefix, x)

    if kind == "train":
        state, batch = args
        for n, p in state.params.named_parameters():
            add(f"params.{n}", p)
        for part in ("m", "v"):
            for n, x in state.opt[part].items():
                tree(f"opt.{part}.{n}", x)
        add("opt.count", state.opt["count"])
        add("step", state.step)
        tree("batch", batch)
    elif kind == "prefill":
        params, batch = args
        for n, p in params.named_parameters():
            add(f"params.{n}", p)
        tree("batch", batch)
    else:
        params, cache, tok = args
        for n, p in params.named_parameters():
            add(f"params.{n}", p)
        tree("cache", {k: v for k, v in cache.items() if k != "t"})
        add("tokens_new", tok)
    return out


def _jax_all(kind, args) -> dict:
    if kind == "train":
        state, batch = args
        out = _jax_leaves(state.params, ("params",))
        for part in ("m", "v"):
            out.update(_jax_leaves(state.opt[part], ("opt", part)))
        out["opt.count"] = ((), "int32")
        out["step"] = ((), "int32")
        out.update(_jax_leaves(batch, ("batch",)))
        return out
    if kind == "prefill":
        params, batch = args
        return {**_jax_leaves(params, ("params",)), **_jax_leaves(batch, ("batch",))}
    params, cache, tok = args
    out = _jax_leaves(params, ("params",))
    out.update(_jax_leaves({k: v for k, v in cache.items() if k != "t"}, ("cache",)))
    out["tokens_new"] = (tuple(tok.shape), np.dtype(tok.dtype).name)
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """Every stand-in of every shape cell of ``arch`` (reduced): the same
    leaves, shapes and dtypes (int8 moments: ``q`` and ``scale``; JAX's
    stacked layers per layer; the decode cache in the port's layout)."""
    for _, shape in shapes.cells_for(arch):
        want = jspecs.input_specs(arch, shape, reduced=True)
        got = specs.input_specs(arch, shape, reduced=True)
        assert got["kind"] == want["kind"]
        g, w = _port_leaves(got["kind"], got["args"]), _jax_all(want["kind"], want["args"])
        assert set(g) == set(w), (shape, sorted(set(g) ^ set(w))[:6])
        for name in g:
            assert g[name] == w[name], (shape, name, g[name], w[name])
        assert all(t.device.type == "meta" for t in _meta(got["args"]))


def _meta(args) -> list:
    return [t for t in dryrun._tensors(args) if t.dim() > 0]


def test_microbatches_match_jax():
    for arch in ARCHS:
        for reduced in (True, False):
            jc, tc = jax_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
            for shape, axes in (((16, 16), ("data", "model")),
                                ((2, 16, 16), ("pod", "data", "model")), ((4, 1), ("data", "model"))):
                for kind in ("train", "prefill"):
                    for b, s in ((256, 4096), (4, 2048), (32, 32768)):
                        assert specs.microbatches_for(kind, tc, b, s, AbstractMesh(shape, axes)) \
                            == jspecs.microbatches_for(kind, jc, b, s, JaxMesh(shape, axes))
    assert specs.ACT_BUDGET_BYTES == jspecs.ACT_BUDGET_BYTES


def test_roofline_from_terms_matches_jax(monkeypatch):
    hw = {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}
    monkeypatch.setattr(jrf, "HW", dict(hw))
    monkeypatch.setattr(roofline, "HW", dict(hw))
    for flops, byts, colls in ((1e15, 2e12, {"all-gather": 10**9}), (3e9, 4e12, {}),
                               (5e12, 1e9, {"all-reduce": 7 * 10**11, "all-to-all": 3})):
        for kw in ({}, {"model_flops_global": 8e17, "num_devices": 256}):
            want = jrf.roofline_from_terms(flops, byts, colls, **kw).to_json()
            got = roofline.roofline_from_terms(flops, byts, colls, **kw).to_json()
            assert got == want


def test_the_h100_figures():
    assert roofline.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "link_bw": 450e9}


@pytest.mark.proc
@pytest.mark.parametrize("arch,mesh", [("qwen1.5-4b", "1x1"), ("deepseek-v2-lite-16b", "1x1"),
                                       ("mamba2-2.7b", "none"), ("mamba2-2.7b", "1x1")])
def test_fake_step_flops_are_a_real_steps(arch, mesh):
    """The reduced train cell (4 x 64, float32 moments) on a 1x1 fake mesh,
    or on one device without a mesh, counts the FLOPs of
    ``FlopCounterMode`` around a real step of the same config and batch on
    the CPU, exactly (the recorder's count; FlopCounterMode's own total in
    the dry-run also counts DTensor's shape propagation, so it is larger
    on a mesh)."""
    from torch.utils.flop_counter import FlopCounterMode

    cell = dryrun.run_cell_process(arch, "train_4k", mesh, reduced=True, optimizer="float32",
                                   timeout=300)
    assert "error" not in cell, cell
    cfg = get_config(arch, reduced=True)
    opt = specs.adamw(lr=3e-4, weight_decay=0.1, quantize_moments=False)
    state = steps.TrainState.create(api.init_params(0, cfg, device="cpu"), opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (cell["batch"], cell["seq"]),
                                     dtype=torch.int32)}
    with FlopCounterMode(display=False) as fc:
        steps.make_train_step(cfg, opt)(state, batch)
    assert cell["roofline"]["flops_per_dev"] == fc.get_total_flops() > 0
    assert cell["flop_counter_total"] >= fc.get_total_flops()
    assert cell["cost_method"] == "full" and cell["devices"] == 1
    mem = cell["memory"]
    assert mem["peak_bytes_per_dev"] >= mem["argument_bytes_per_dev"] > 0


@pytest.mark.proc
@pytest.mark.parametrize("arch", ["zamba2-7b", "whisper-tiny"])
def test_a_cell_runs_sharded_on_a_fake_2x2_mesh(arch):
    """A reduced train cell of the hybrid (attention, Mamba blocks) and the
    encoder/decoder on a fake 2x2 mesh: it runs, on four devices, with
    collectives."""
    cell = dryrun.run_cell_process(arch, "train_4k", "2x2", reduced=True, optimizer="float32",
                                   timeout=300)
    assert "error" not in cell, cell
    assert cell["devices"] == 4 and cell["roofline"]["flops_per_dev"] > 0
    assert cell["roofline"]["coll_bytes_per_dev"] > 0


_MATMUL = r"""
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
from torch.distributed.tensor import Replicate, Shard, distribute_tensor
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.roofline import collective_bytes
from repro_torch.launch.trace_tools import Recorder, collective_sites
mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
meta = torch.device("meta")
x = distribute_tensor(torch.empty(8, 64, device=meta), mesh, [Shard(0), Shard(1)], src_data_rank=None)
w = distribute_tensor(torch.empty(64, 32, device=meta), mesh, [Replicate(), Shard(0)], src_data_rank=None)
g = distribute_tensor(torch.empty(16, 32, device=meta), mesh, [Shard(0), Shard(0)], src_data_rank=None)
rec = Recorder()
with rec:
    y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])   # row-parallel: all-reduce
    z = g.redistribute(mesh, [Replicate(), Replicate()])      # all-gather over both dims
print("COLL " + json.dumps({"bytes": collective_bytes(rec), "flops": rec.flops,
                            "sites": collective_sites(rec)}))
"""


@pytest.mark.proc
def test_collective_bytes_of_a_sharded_matmul_are_analytic():
    """x (8, 64) over (data, model) times w (64, 32) rows over model: each
    rank's partial (4, 32) float32 product is all-reduced over model, 512
    bytes; its local matmul is 2·4·32·32 FLOPs.  Gathering g (16, 32)
    sharded over both axes: 4 x 32 float32 rows go into the first gather
    (512 bytes), 8 x 32 into the second (1,024)."""
    proc = subprocess.run([sys.executable, "-c", _MATMUL], capture_output=True, text=True,
                          timeout=120, env=ENV)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads([x for x in proc.stdout.splitlines() if x.startswith("COLL ")][0][5:])
    assert res["bytes"] == {"all-reduce": 4 * 32 * 4, "all-gather": 4 * 32 * 4 + 8 * 32 * 4}
    assert res["flops"] == 2 * 4 * 32 * 32
    assert sorted((s["kind"], s["shape"], s["count"]) for s in res["sites"]) == [
        ("all-gather", "f32[4,32]", 1), ("all-gather", "f32[8,32]", 1),
        ("all-reduce", "f32[4,32]", 1)]


@pytest.mark.proc
def test_a_failing_cell_is_recorded_by_name_and_the_sweep_goes_on(tmp_path):
    """mamba2's chunked SSD refuses a sequence that is not a multiple of its
    chunk (63 of 8): that cell's error names it, the next cell runs."""
    out = tmp_path / "dryrun.json"
    for seq in ("63", "64"):
        dryrun.main(["--arch", "mamba2-2.7b", "--shape", "train_4k", "--mesh-shape", "1x1",
                     "--reduced", "--seq", seq, "--out", str(out)])
        res = json.loads(out.read_text())
        cell = res["mamba2-2.7b|train_4k|1x1"]
        if seq == "63":
            assert cell["error"].startswith("mamba2-2.7b|train_4k|1x1: exit 1")
            out.unlink()
        else:
            assert "error" not in cell and cell["seq"] == 64


def test_flash_meta_path_gives_shapes_and_sdpa_flops():
    """On meta tensors (the dry-run's) the flash forward and backward take
    their fake implementations: the output in q's shape and dtype, the
    float32 (B, H, S) log-sum-exp when a gradient is wanted, dq, dk and dv
    in their inputs' shapes; ``FlopCounterMode`` counts them at torch's
    own SDPA forward and backward formulas (GQA: k and v at q's heads)."""
    from torch.utils.flop_counter import (
        FlopCounterMode,
        sdpa_backward_flop_count,
        sdpa_flop_count,
    )

    from repro_torch.kernels.flash_attn.ops import flash_attention

    b, s, h, kv, d = 2, 24, 4, 2, 16
    q = torch.empty((b, s, h, d), device="meta", dtype=torch.bfloat16, requires_grad=True)
    k = torch.empty((b, s, kv, d), device="meta", dtype=torch.bfloat16, requires_grad=True)
    v = torch.empty((b, s, kv, d), device="meta", dtype=torch.bfloat16, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        out = flash_attention(q, k, v)
    assert out.shape == q.shape and out.dtype == q.dtype and out.device.type == "meta"
    lse = out.grad_fn.saved_tensors[3]
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    with FlopCounterMode(display=False) as bwd:
        dq, dk, dv = torch.autograd.grad(out.sum(), (q, k, v))
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    qs, ks = (b, h, s, d), (b, h, s, d)
    assert fwd.get_total_flops() == sdpa_flop_count(qs, ks, ks) == 4 * b * h * s * s * d
    assert bwd.get_total_flops() == sdpa_backward_flop_count(qs, qs, ks, ks) \
        == 10 * b * h * s * s * d
    with torch.no_grad():  # no gradient wanted: no log-sum-exp kept
        assert flash_attention(q, k, v).grad_fn is None


@pytest.mark.proc
def test_flash_cell_flops_are_a_real_steps():
    """The reduced zamba2 train cell at ``pallas_flash`` (its shared block
    on flash) on a 1x1 fake mesh counts the FLOPs ``FlopCounterMode``
    counts around a real flash step on the CPU, exactly: the flash forward
    and backward are counted on meta tensors and on the CPU alike."""
    from torch.utils.flop_counter import FlopCounterMode

    cell = dryrun.run_cell_process("zamba2-7b", "train_4k", "1x1", reduced=True,
                                   optimizer="float32", attn_impl="pallas_flash", timeout=300)
    assert "error" not in cell, cell
    assert cell["attn_impl"] == "pallas_flash"
    cfg = dataclasses.replace(get_config("zamba2-7b", reduced=True), attn_impl="pallas_flash")
    opt = specs.adamw(lr=3e-4, weight_decay=0.1, quantize_moments=False)
    state = steps.TrainState.create(api.init_params(0, cfg, device="cpu"), opt)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (cell["batch"], cell["seq"]),
                                     dtype=torch.int32)}
    with FlopCounterMode(display=False) as fc:
        steps.make_train_step(cfg, opt)(state, batch)
    assert cell["roofline"]["flops_per_dev"] == fc.get_total_flops() > 0


@pytest.mark.proc
def test_a_flash_train_cell_runs_on_a_fake_2x2_mesh():
    """A reduced ``pallas_flash`` train cell (qwen: flash in every layer, on
    each rank's heads through ``pspec.local_call``) on a fake 2x2 mesh."""
    cell = dryrun.run_cell_process("qwen1.5-4b", "train_4k", "2x2", reduced=True,
                                   optimizer="float32", attn_impl="pallas_flash", timeout=300)
    assert "error" not in cell, cell
    assert cell["attn_impl"] == "pallas_flash" and cell["devices"] == 4
    assert cell["roofline"]["flops_per_dev"] > 0 and cell["roofline"]["coll_bytes_per_dev"] > 0


def _local_bytes(shapes: dict, specs_: dict, sizes: dict) -> int:
    """Bytes of each (shape, dtype) of ``shapes`` on one device: each dim
    divided by the mesh axes its spec names."""
    total = 0
    for name, (shape, dtype) in shapes.items():
        n = 1
        for i, dim in enumerate(shape):
            entry = specs_[name][i] if i < len(specs_[name]) else None
            axes = () if entry is None else (entry,) if isinstance(entry, str) else entry
            div = int(np.prod([sizes[a] for a in axes])) if axes else 1
            assert dim % div == 0, (name, shape, specs_[name])
            n *= dim // div
        total += n * torch.empty((), dtype=dtype).element_size()
    return total


def _flat_cache(cache: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in (cache.items() if isinstance(cache, dict) else enumerate(cache)):
        if isinstance(v, (dict, list)):
            out.update(_flat_cache(v, f"{prefix}{k}."))
        elif isinstance(v, torch.Tensor):
            out[f"{prefix}{k}"] = v
    return out


@pytest.mark.proc
@pytest.mark.parametrize("arch,shape", [("gemma3-1b", "long_500k"),
                                        ("deepseek-v2-lite-16b", "decode_32k"),
                                        ("zamba2-7b", "decode_32k"),
                                        ("whisper-tiny", "decode_32k")])
def test_a_decode_cell_runs_on_a_fake_2x2_mesh(arch, shape):
    """A reduced decode cell on a fake 2x2 mesh: ``serve_step`` against a
    cache placed by ``cache_specs`` (gemma3's MQA sequence-parallel, MLA's
    latent on its sequence, zamba2's SSM state and conv ring, whisper's
    self and cross K/V) runs with no error.  Its arguments' bytes a device
    are the local bytes of the weights, the cache and the tokens, counted
    here from the spec tables; the cache, updated in place, is the
    output's alias."""
    from repro_torch.models import sharding

    cell = dryrun.run_cell_process(arch, shape, "2x2", reduced=True, timeout=300)
    assert "error" not in cell, cell
    assert cell["kind"] == "decode" and cell["devices"] == 4
    assert cell["roofline"]["flops_per_dev"] > 0
    params, cache, tokens = specs.input_specs(arch, shape, reduced=True)["args"]
    mesh, sizes = AbstractMesh((2, 2), ("data", "model")), {"data": 2, "model": 2}
    cfg = get_config(arch, reduced=True)
    pspecs = sharding.param_specs(params, cfg, mesh)
    flat = _flat_cache(cache)
    cspecs = _flat_cache_specs(sharding.cache_specs(cache, cfg, mesh))
    cache_bytes = _local_bytes({n: (tuple(t.shape), t.dtype) for n, t in flat.items()},
                               cspecs, sizes)
    tok_spec = sharding.batch_specs({"t": tokens}, mesh)["t"]
    want = (_local_bytes({n: (tuple(p.shape), p.dtype) for n, p in params.named_parameters()},
                         pspecs, sizes)
            + cache_bytes + _local_bytes({"t": (tuple(tokens.shape), tokens.dtype)},
                                         {"t": tok_spec}, sizes))
    mem = cell["memory"]
    assert mem["argument_bytes_per_dev"] == want
    assert mem["alias_bytes_per_dev"] == cache_bytes > 0
    assert mem["peak_bytes_per_dev"] >= mem["argument_bytes_per_dev"]


def _flat_cache_specs(specs_: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in (specs_.items() if isinstance(specs_, dict) else enumerate(specs_)):
        if isinstance(v, (dict, list)):
            out.update(_flat_cache_specs(v, f"{prefix}{k}."))
        elif k != "t":
            out[f"{prefix}{k}"] = v
    return out
