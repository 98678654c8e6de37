"""The port's sharding tables (``repro_torch/models/sharding.py``,
``models/pspec.py``, ``launch/mesh.py``) against the JAX package's, on
abstract meshes (no devices, no process group): JAX's
``jax.sharding.AbstractMesh`` and the port's ``AbstractMesh`` of the same
shape, (16,16), (2,16,16), (4,2), (2,4) and (1,1).

  * ``param_specs`` of every parameter of all 10 archs, reduced and at full
    size (the port's model on the meta device, JAX's tree from
    ``jax.eval_shape``): the port's spec of a layer's leaf is JAX's spec of
    the stacked leaf without its stack dims, exactly.  The stack entries
    JAX drops are None except where JAX's table puts ``model`` on the layer
    dim of a dense ``tail`` MLP (its ``ffn`` leaves take the MoE rule).
  * ``batch_specs`` and ``cache_specs`` (the port's per-layer caches against
    JAX's stacked ones, stack dims dropped), exactly.
  * ``opt_state_specs`` with float32 and int8 moments: JAX's lives in
    ``repro/launch/dryrun.py``, which sets ``XLA_FLAGS`` to 512 host devices
    at import, so it runs in a child interpreter.
  * ``constrain``'s resolved spec equals the one JAX's ``constrain`` hands
    ``with_sharding_constraint``; ``placements`` and the mesh helpers."""

import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh as JaxMesh  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import pspec as jpspec  # noqa: E402
from repro.models import sharding as jshd  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import encdec, lm, pspec, sharding  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

MESHES = [((16, 16), ("data", "model")), ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")), ((2, 4), ("data", "model")), ((1, 1), ("data", "model"))]
ARCHS = list_archs()
STACKED = {"tail": 1, "enc": 1, "dec": 1, "groups": 2}


def _one(entry):
    """A spec entry with a one-axis tuple as its name: JAX 0.9's
    ``PartitionSpec`` stores ('data',) as 'data', 0.4's keeps the tuple."""
    if isinstance(entry, (tuple, list)):
        return entry[0] if len(entry) == 1 else tuple(entry)
    return entry


def _norm(tree):
    """Specs (tuples of entries) in a nested dict/list, entries by ``_one``."""
    if isinstance(tree, dict):
        return {k: _norm(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_norm(v) for v in tree]
    return tuple(_one(e) for e in tree)


def _keys(path) -> list:
    return [str(p.key) if hasattr(p, "key") else str(p.idx) for p in path]


def _jax_params(arch, reduced):
    jc = jax_config(arch, reduced=reduced)
    kw = {"max_decode_len": 448} if jc.encoder_decoder else {}
    shapes = jax.eval_shape(lambda: japi.init_params(jax.random.PRNGKey(0), jc, **kw))
    return jc, shapes


def _port_model(arch, reduced, shapes):
    cfg = get_config(arch, reduced=reduced)
    meta = torch.device("meta")
    if cfg.encoder_decoder:
        return cfg, encdec.EncDec(cfg, None, max_pos=shapes["pos_dec"].shape[0], device=meta)
    return cfg, lm.LM(cfg, None, device=meta)


def _per_layer(spec_tree, shape_tree) -> dict:
    """JAX's specs by port name: (spec without the stack dims, the stack
    entries dropped)."""
    shapes = {tuple(_keys(p)): x for p, x in jax.tree_util.tree_flatten_with_path(shape_tree)[0]}
    out = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            spec_tree, is_leaf=lambda x: isinstance(x, P))[0]:
        keys, spec = _keys(path), tuple(spec)
        k = STACKED.get(keys[0], 0)
        lead = shapes[tuple(keys)].shape[:k]
        for index in np.ndindex(*lead):
            name = ".".join([keys[0], *map(str, index), *keys[1:]] if k else keys)
            out[name] = (spec[k:], spec[:k])
    return out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_jax(arch, reduced):
    jc, shapes = _jax_params(arch, reduced)
    cfg, model = _port_model(arch, reduced, shapes)
    for shape, axes in MESHES:
        want = _per_layer(jshd.param_specs(shapes, jc, JaxMesh(shape, axes)), shapes)
        got = sharding.param_specs(model, cfg, tmesh.AbstractMesh(shape, axes))
        assert set(got) == set(want)
        for name, spec in got.items():
            per_layer, stack = want[name]
            assert spec == per_layer, (name, shape, spec, per_layer)
            dense_tail_ffn = (name.startswith("tail.") and ".ffn." in name and not cfg.moe
                              and name.split(".")[-1] in ("w_gate", "w_up", "w_down"))
            assert all(s is None or (dense_tail_ffn and s == "model") for s in stack), \
                (name, stack)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_batch_specs_match_jax(shape, axes):
    jm, tm = JaxMesh(shape, axes), tmesh.AbstractMesh(shape, axes)
    for b in (1, 2, 4, 16, 32, 256, 512):
        batch = {"tokens": (b, 128), "frames": (b, 64, 32), "patch_embeds": (b, 16, 24)}
        want = jshd.batch_specs({k: jax.ShapeDtypeStruct(s, np.float32) for k, s in batch.items()},
                                jm)
        assert _norm(sharding.batch_specs(batch, tm)) == _norm({k: tuple(v) for k, v in want.items()})


def _jax_cache_specs(spec_tree, shape_tree) -> dict:
    """JAX's cache specs in the port cache's layout."""
    per = _per_layer(spec_tree, shape_tree)
    out: dict = {"t": ()}
    for name, (spec, _) in per.items():
        keys = name.split(".")
        if keys[0] in ("prefix", "shared"):
            out.setdefault(keys[0], {}).setdefault(int(keys[1]), {})[keys[2]] = spec
        elif keys[0] == "tail":
            out.setdefault("tail", {}).setdefault(int(keys[1]), {})[keys[2]] = spec
        elif keys[0] == "groups":
            g = out.setdefault("groups", {}).setdefault(int(keys[1]), {})
            g.setdefault(int(keys[2]), {})[keys[3]] = spec
        elif keys[0] != "t":
            out[keys[0]] = spec
    for head in ("prefix", "shared", "tail"):
        if head in out:
            out[head] = [out[head][i] for i in sorted(out[head])]
    if "groups" in out:
        out["groups"] = [[g[i] for i in sorted(g)] for _, g in sorted(out["groups"].items())]
    return out


@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_jax(arch, reduced):
    from repro.models import encdec as jencdec
    from repro.models import lm as jlm

    jc, cfg = jax_config(arch, reduced=reduced), get_config(arch, reduced=reduced)
    batch, max_len = (4, 64) if reduced else (128, 4096)
    jinit = jencdec.init_cache if jc.encoder_decoder else jlm.init_cache
    shapes = jax.eval_shape(lambda: jinit(jc, batch, max_len))
    tinit = encdec.init_cache if cfg.encoder_decoder else lm.init_cache
    cache = tinit(cfg, batch, max_len, device=torch.device("meta"))
    for shape, axes in MESHES:
        want = _jax_cache_specs(jshd.cache_specs(shapes, jc, JaxMesh(shape, axes)), shapes)
        got = sharding.cache_specs(cache, cfg, tmesh.AbstractMesh(shape, axes))
        assert _norm(got) == _norm(want), (arch, shape)


_OPT_SCRIPT = r"""
import json, sys
import jax
from jax.sharding import AbstractMesh, PartitionSpec as P
from repro.launch.dryrun import opt_state_specs
from repro.configs import get_config
from repro.models import api, sharding
from repro.optim.adamw import adamw

def canon(s):
    return [(list(e) if len(e) > 1 else e[0]) if isinstance(e, tuple) else e for e in s]

out = {}
for arch in json.loads(sys.argv[1]):
    cfg = get_config(arch, reduced=True)
    kw = {"max_decode_len": 448} if cfg.encoder_decoder else {}
    params = jax.eval_shape(lambda: api.init_params(jax.random.PRNGKey(0), cfg, **kw))
    for shape, axes in json.loads(sys.argv[2]):
        mesh = AbstractMesh(tuple(shape), tuple(axes))
        pspec = sharding.param_specs(params, cfg, mesh)
        for q in (False, True):
            opt = jax.eval_shape(lambda: adamw(1e-3, quantize_moments=q).init(params))
            specs = opt_state_specs(opt, pspec, mesh)
            flat = jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, P))[0]
            out[f"{arch}|{shape}|{q}"] = [
                ([str(k.key) if hasattr(k, "key") else str(k.idx) for k in path], canon(spec))
                for path, spec in flat]
print("OPT_SPECS " + json.dumps(out))
"""


def test_opt_state_specs_match_jax():
    """Float32 and int8 moments, every arch (reduced), every mesh: the
    moments mirror the parameter specs, ZeRO over ``pod`` on the first free
    dim the pod count divides (on JAX's stacked leaf: its layer dim, where
    it divides, which a port moment of one layer does not have), and an int8
    moment's ``scale`` drops the last-dim shard."""
    env = {**os.environ, "PYTHONPATH": "src", "JAX_PLATFORMS": "cpu"}
    proc = subprocess.run(
        [sys.executable, "-c", _OPT_SCRIPT, json.dumps(ARCHS),
         json.dumps([[list(s), list(a)] for s, a in MESHES])],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    line = [x for x in proc.stdout.splitlines() if x.startswith("OPT_SPECS ")]
    jax_specs = json.loads(line[0].split(" ", 1)[1])
    for arch in ARCHS:
        jc, shapes = _jax_params(arch, True)
        cfg, model = _port_model(arch, True, shapes)
        model = model.to_empty(device="cpu")
        named = dict(model.named_parameters())
        for shape, axes in MESHES:
            mesh = tmesh.AbstractMesh(shape, axes)
            specs = sharding.param_specs(model, cfg, mesh)
            for q in (False, True):
                opt = adamw.adamw(1e-3, quantize_moments=q).init(named)
                got = sharding.opt_state_specs(opt, specs, mesh)
                want = _opt_port_layout(jax_specs[f"{arch}|{list(shape)}|{q}"], shapes)
                assert _canon(got) == want, (arch, shape, q)


def _canon(tree):
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items()}
    return [list(e) if isinstance(e, tuple) else e for e in _norm(tree)]


def _opt_port_layout(flat: list, shapes) -> dict:
    """JAX's flattened opt specs -> the port's {count, m: {name: spec}, v}:
    stacked moments per layer, their stack entries dropped."""
    out = {"count": [], "m": {}, "v": {}}
    pshapes = {tuple(_keys(p)): x for p, x in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    for keys, spec in flat:
        if keys == ["count"]:
            out["count"] = spec
            continue
        part, keys = keys[0], keys[1:]
        sub = None
        if keys[-1] in ("q", "scale"):
            sub, keys = keys[-1], keys[:-1]
        k = STACKED.get(keys[0], 0)
        lead = pshapes[tuple(keys)].shape[:k]
        for index in np.ndindex(*lead):
            name = ".".join([keys[0], *map(str, index), *keys[1:]] if k else keys)
            if sub:
                out[part].setdefault(name, {})[sub] = spec[k:]
            else:
                out[part][name] = spec[k:]
    return out


def test_constrain_resolves_as_jax(monkeypatch):
    """The spec ``constrain`` redistributes to is the one JAX's ``constrain``
    passes ``with_sharding_constraint``: names resolved, the batch
    expanded, missing axes and non-dividing dims None, padded to rank."""
    seen = []
    monkeypatch.setattr(jpspec, "NamedSharding", lambda mesh, spec: spec)
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: seen.append(tuple(spec)) or x)
    cases = [((8, 16, 32), (jpspec.BATCH, None, None)), ((8, 16, 32), (jpspec.BATCH, None, "model")),
             ((3, 16, 30), (jpspec.BATCH, None, "model")), ((64, 32), (("data", "model"), None)),
             ((64, 32), (("pod", "data", "model"), None)), ((8, 16), ("pod", "model", None)),
             ((8, 16, 32, 4), (jpspec.BATCH,)), ((2, 2), (jpspec.BATCH, None, None, "model"))]
    for shape, axes in MESHES:
        for xshape, spec in cases:
            with jpspec.activation_mesh(JaxMesh(shape, axes)):
                jpspec.constrain(jax.ShapeDtypeStruct(xshape, np.float32), *spec)
            got = pspec.resolve_spec(xshape, spec, tmesh.AbstractMesh(shape, axes))
            assert _norm(got) == _norm(seen.pop()), (shape, xshape, spec)


def test_constrain_and_placed_are_identities_without_a_mesh():
    x = torch.ones(2, 3)
    assert pspec.current_mesh() is None
    assert pspec.constrain(x, pspec.BATCH, "model") is x and pspec.placed(x) is x


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m = tmesh.AbstractMesh((2, 4, 4), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), m) == [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, None), m) == [Replicate()] * 3
    assert sharding.placements(("data",), m) == [Replicate(), Shard(0), Replicate()]
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"),), m)


def test_mesh_helpers_match_jax():
    for shape, axes in MESHES:
        jm, tm = JaxMesh(shape, axes), tmesh.AbstractMesh(shape, axes)
        assert tmesh.batch_axes(tm) == jmesh.batch_axes(jm)
        for names in (("data",), ("model",), ("pod", "data"), ("pod", "data", "model"), ()):
            assert tmesh.axis_size(tm, *names) == jmesh.axis_size(jm, *names)
        assert tm.size() == int(np.prod(shape)) and tm.ndim == len(shape)
