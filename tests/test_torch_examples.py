"""The port's examples (``examples/*_torch.py``) against the JAX package's
(``examples/*.py``) on the same seeds, on the CPU (the port at
``--device cpu``, Pallas in interpret mode).

The three store walkthroughs run at ``--fast`` and must print the same
lines, after masking only what is measured on the host's clock or given by
the operating system; every count, id, feature value, ratio, ledger tally
and ``True`` stays in the comparison.  The masks, each named:

  * quickstart: ``latency p50/p99 = <us>/<us> µs`` (the GET's wall time);
  * serving_front: the per-stage latency table's p50 and p99 (wall times;
    the stage names and each histogram's ``n`` stay);
  * geo_failover: the daemon child's ``pid=`` and its ephemeral
    ``127.0.0.1:<port>``.

One line of geo_failover is held apart, by name: the two-plane drill's
``wire transport`` line.  Its wire bytes are zlib's size of frames that
carry the DSL's rolling sums, which the two packages add in different
orders (a float64 prefix rounded once in the port, a float32 block prefix
in JAX: ``tests/test_torch_replication.py``'s ``ROLL_RTOL`` case), so the
compressed size may move by a few bytes.  Batches, frames, raw bytes and
the printed ratio must still be equal, and the port's wire bytes lie within
``WIRE_RTOL`` of JAX's and below the raw bytes.  This is arithmetic order,
not a fault of either package: no line differs by a reference fault at
these sizes (the full-key hash collision of ``repro/core/keys.py`` would
show in the offline row counts, which are equal).

The LM veneers: ``online_serving`` at its default argv yields JAX's
sessions, token count and generated tokens, and ``train_lm`` at a tiny argv
JAX's losses, both on float32 configs with JAX's weights carried over
(``convert.lm_params_from_numpy``).  With no card every example refuses to
run unless it is given ``--device cpu``."""

import dataclasses
import re
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import api as tapi  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
F32 = dict(param_dtype="float32", compute_dtype="float32")
# train_lm's losses: tests/test_torch_train.py's TRAJ_TOL (relative)
TRAJ_TOL = 1e-4
# the wire bytes of DSL values: zlib's size of last-bit-different float32 sums
WIRE_RTOL = 0.01

MASKS = {
    "quickstart": [(r"latency p50/p99 = \d+/\d+ µs", "latency p50/p99 = <us>/<us> µs")],
    "serving_front": [(r"p50 +[\d.]+ +p99 +[\d.]+", "p50 <us> p99 <us>")],
    "geo_failover": [(r"pid=\d+", "pid=<pid>"), (r"127\.0\.0\.1:\d+", "127.0.0.1:<port>")],
}
WIRE_LINE = re.compile(r"wire transport: (\d+) batches coalesced into (\d+) frames, "
                       r"(\d+) raw B -> (\d+) wire B \(([\d.]+)x compression\)")


def _module(name: str) -> dict:
    """An example's globals, loaded from its file without running ``main``."""
    return runpy.run_path(str(EXAMPLES / name), run_name=name.removesuffix(".py"))


def _printed(capsys, fn, **kw) -> list[str]:
    capsys.readouterr()
    fn(**kw)
    return capsys.readouterr().out.splitlines()


def _masked(lines: list[str], masks) -> list[str]:
    out = []
    for line in lines:
        for pattern, repl in masks:
            line = re.sub(pattern, repl, line)
        out.append(line)
    return out


@pytest.mark.parametrize("name", ["quickstart", "serving_front", "geo_failover"])
def test_store_example_prints_the_jax_lines(name, capsys):
    want = _printed(capsys, _module(f"{name}.py")["main"], fast=True)
    got = _printed(capsys, _module(f"{name}_torch.py")["main"], fast=True, device="cpu")
    assert len(got) == len(want) and len(want) > 10
    want, got = _masked(want, MASKS[name]), _masked(got, MASKS[name])
    compared = 0
    for w, g in zip(want, got, strict=True):
        wire_w, wire_g = WIRE_LINE.fullmatch(w), WIRE_LINE.fullmatch(g)
        if name == "geo_failover" and wire_w:
            assert wire_g, g
            jw, tw = (tuple(int(x) for x in m.groups()[:4]) for m in (wire_w, wire_g))
            assert tw[:3] == jw[:3], (g, w)  # batches, frames, raw bytes
            assert wire_g.group(5) == wire_w.group(5), (g, w)  # the printed ratio
            assert tw[3] < tw[2] and abs(tw[3] - jw[3]) <= WIRE_RTOL * jw[3], (g, w)
            continue
        assert g == w
        compared += 1
    assert compared == len(want) - (name == "geo_failover")


def _jax_weights(cfg_j, cfg_t, **kw):
    """JAX's seed-0 weights of ``cfg_j`` as a port model of ``cfg_t``."""
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(0), cfg_j, **kw))
    return lm_params_from_numpy(cfg_t, tree, device="cpu")


def _recorded(monkeypatch, module, name="main") -> list:
    """Wrap ``module.name`` so each call's result is kept."""
    results, real = [], getattr(module, name)

    def call(*args, **kw):
        results.append(real(*args, **kw))
        return results[-1]

    monkeypatch.setattr(module, name, call)
    return results


def test_online_serving_generates_the_jax_tokens(monkeypatch, capsys):
    """The default argv (8 requests, 16 new tokens, reduced gemma3-1b) on
    float32 configs: the same warm sessions, token count and tokens."""
    arch = "gemma3-1b"
    cfg_j = dataclasses.replace(jax_config(arch, reduced=True), **F32)
    cfg_t = dataclasses.replace(get_config(arch, reduced=True), **F32)
    model = _jax_weights(cfg_j, cfg_t, max_decode_len=32 + 16)
    monkeypatch.setattr(jserve, "get_config", lambda a, reduced: cfg_j)
    monkeypatch.setattr(tserve, "get_config", lambda a, reduced: cfg_t)
    monkeypatch.setattr(tapi, "init_params", lambda seed, cfg, **kw: model)
    want, got = _recorded(monkeypatch, jserve), _recorded(monkeypatch, tserve)
    monkeypatch.setattr(sys, "argv", ["online_serving.py"])
    _module("online_serving.py")["main"]()
    monkeypatch.setattr(sys, "argv", ["online_serving_torch.py", "--device", "cpu"])
    _module("online_serving_torch.py")["main"]()
    (want,), (got,) = want, got
    assert got["requests"] == want["requests"] == 8
    assert got["context_hits"] == want["context_hits"] > 0
    assert got["tokens_generated"] == want["tokens_generated"] == 128
    np.testing.assert_array_equal(got["generated"], np.asarray(want["generated"]))
    lines = capsys.readouterr().out.splitlines()
    assert lines.count("example complete: 8/8 sessions served from the online store; "
                       "generated shape (8, 16)") == 2


def test_train_lm_losses_match_jax(monkeypatch):
    """``--arch gemma-2b --steps 4 --batch 2 --seq 32`` on float32 configs
    from JAX's weights: each step's loss within TRAJ_TOL, and the example's
    own assertion (the loss falls) holds in both."""
    arch = "gemma-2b"
    cfg_j = dataclasses.replace(jax_config(arch, reduced=True), **F32)
    cfg_t = dataclasses.replace(get_config(arch, reduced=True), **F32)
    monkeypatch.setattr(jtrain, "get_config", lambda a, reduced: cfg_j)
    monkeypatch.setattr(ttrain, "get_config", lambda a, reduced: cfg_t)
    monkeypatch.setattr(tapi, "init_params",
                        lambda seed, cfg, **kw: _jax_weights(cfg_j, cfg_t))
    want, got = _recorded(monkeypatch, jtrain), _recorded(monkeypatch, ttrain)
    argv = ["--arch", arch, "--steps", "4", "--batch", "2", "--seq", "32"]
    monkeypatch.setattr(sys, "argv", ["train_lm.py", *argv])
    _module("train_lm.py")["main"]()
    monkeypatch.setattr(sys, "argv", ["train_lm_torch.py", "--device", "cpu", *argv])
    _module("train_lm_torch.py")["main"]()
    (want,), (got,) = want, got
    assert got["steps_run"] == want["steps_run"] == 4
    for g, w in zip(got["losses"], want["losses"], strict=True):
        assert abs(g - w) <= TRAJ_TOL * w, (got["losses"], want["losses"])


@pytest.mark.parametrize("name", ["quickstart", "serving_front", "geo_failover",
                                  "online_serving", "train_lm"])
def test_example_refuses_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    main = _module(f"{name}_torch.py")["main"]
    monkeypatch.setattr(sys, "argv", [f"{name}_torch.py"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(fast=True) if name in MASKS else main()
