"""What each cell reads, pinned: the port's ``ModelConfig`` of each
configuration file, field by field; its weight leaves at full width; a
digest of every group's draw at the ``tiny.py`` cut on the CPU; and the
FLOP counts at each cell's batch and sequence.  A change to how a file is
mapped, drawn or counted that moves any of these moves what the benchmark
reads; the pins (``pins/identity.json``) were taken before the mapping,
the draw and the count learned to read a file's own keys."""

import dataclasses
import hashlib
import json

import pytest
import torch

from fsbench import flops, spec, weights
from fsbench.tiny import tiny_cell

BENCH = spec.load()
CELLS = {w["name"]: w for w in BENCH["workloads"]}
CONFIGS = [c["name"] for c in BENCH["configs"]]
SEED = 2**31 + 101
with open(spec.HERE / "pins" / "identity.json") as _f:
    PINS = json.load(_f)


def _config(name: str) -> dict:
    return spec.cell(BENCH, next(w for w, e in CELLS.items() if e["config"] == name)).config


def _shape(cell: spec.Cell) -> tuple[int, int]:
    """(batch, sequence) of one forward or step of the cell."""
    t = cell.traffic
    if t["kind"] == "pit_train":
        return t["steps"]["batch"], t["steps"]["seq"]
    r = t["requests"]
    return r["batch"], t["plane"]["chunk_tokens"] + r["request_tokens"]


def _digest(obj) -> str:
    return hashlib.sha256(json.dumps(obj, sort_keys=True).encode()).hexdigest()


def observed_config(name: str) -> dict:
    c = _config(name)
    groups = [[[n, list(shape), fan, kind] for n, shape, fan, kind in g]
              for g in weights.groups(c)]
    tiny = tiny_cell(next(w for w, e in CELLS.items() if e["config"] == name)).config
    draws = []
    for g in range(weights.num_groups(tiny)):
        h = hashlib.sha256()
        for leaf, t in sorted(weights.draw(tiny, SEED, g, "cpu").items()):
            h.update(f"{leaf} {t.dtype} {tuple(t.shape)}".encode())
            h.update(t.contiguous().view(-1).view(torch.uint8).numpy().tobytes())
        draws.append(h.hexdigest())
    return {"model_config": dataclasses.asdict(spec.model_config(c)),
            "leaves": sum(len(g) for g in groups), "groups": _digest(groups),
            "tiny_draws": draws}


def observed_cell(name: str) -> dict:
    cell = spec.cell(BENCH, name)
    b, s = _shape(cell)
    c = cell.config
    return {"batch": b, "seq": s, "matmul_params": flops.matmul_params(c),
            "forward_flops": flops.forward_flops(c, b, s),
            "train_flops": flops.train_flops(c, b, s),
            "flash_fwd_bound_s": repr(flops.flash_fwd_bound_s(c, b, s))}


@pytest.mark.parametrize("name", CONFIGS)
def test_model_config_is_pinned(name):
    assert dataclasses.asdict(spec.model_config(_config(name))) == \
        PINS["configs"][name]["model_config"]


@pytest.mark.parametrize("name", CONFIGS)
def test_weight_leaves_are_pinned(name):
    got = observed_config(name)
    want = PINS["configs"][name]
    assert (got["leaves"], got["groups"]) == (want["leaves"], want["groups"])


@pytest.mark.parametrize("name", CONFIGS)
def test_tiny_draws_are_pinned(name):
    assert observed_config(name)["tiny_draws"] == PINS["configs"][name]["tiny_draws"]


@pytest.mark.parametrize("name", list(CELLS))
def test_flop_counts_are_pinned(name):
    assert observed_cell(name) == PINS["cells"][name]
