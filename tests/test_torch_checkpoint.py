"""Port's checkpoint manager: the JAX package's on-disk layout and
guarantees (atomic, ``keep_last``, bfloat16 as a ``uint16`` view, the same
leaf paths), and checkpoints that cross between the packages: one the JAX
driver wrote resumes in the port's driver, and the reverse; and a reduced
deepseek-v3 train state (the nested ``mtp`` subtree, the float32 routers in
a bfloat16 model, each leaf's m and v) and reduced mamba2 and zamba2 train
states (the (L, ...) stacked tail, zamba2's (G, L, ...) stacked ``groups``
and its ``shared_attn`` block, weights and float32 moments alike) and
reduced whisper and pixtral train states (``enc``/``dec`` stacked like the
tail, ``pos_dec``, ``vision_proj``) crossing both ways bit for bit.

Tolerance of the cross-package runs: the reduced gemma-2b the drivers train
is bfloat16, and the two frameworks round bfloat16 intermediates at
different places (PyTorch after each op, XLA once per fused chain), so from
one restored state their losses agree to LOSS_TOL (measured about 2e-3 at
losses near 6).  The restored state itself must be the written one, bit for
bit."""

import json
import shutil

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import manager as jmanager  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import train_state_to_numpy  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

LOSS_TOL = 2e-2
# the JAX driver test's model and data, cut to 8 steps with a checkpoint at 4
ARGS = ["--arch", "gemma-2b", "--steps", "8", "--batch", "2", "--seq", "32",
        "--ckpt-every", "4", "--log-every", "100"]


def _state(quantize=False, seed=0, steps_run=1):
    """A reduced gemma-2b (bfloat16) TrainState after ``steps_run`` steps."""
    cfg = get_config("gemma-2b", reduced=True)
    opt = adamw.adamw(1e-3, quantize_moments=quantize)
    state = steps.TrainState.create(api.init_params(seed, cfg, device="cpu"), opt)
    step = steps.make_train_step(cfg, opt)
    rng = np.random.default_rng(seed)
    for _ in range(steps_run):
        state, _ = step(state, {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))})
    return state


def _same(a: dict, b: dict) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    else:
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("quantize", [False, True])
def test_round_trip_is_bit_identical_in_the_jax_layout(tmp_path, quantize):
    state = _state(quantize)
    path = manager.save_checkpoint(tmp_path, 7, state, extra={"loader": {"clock": 5}})
    assert path.name == "step_00000007"
    mf = json.loads((path / "manifest.json").read_text())
    leaves = mf["leaves"]
    assert leaves["params/embed"]["dtype"] == "bfloat16"
    assert leaves["params/tail/mixer/wq"]["shape"] == [2, 64, 64]  # stacked layer-leading
    assert leaves["opt/count"] == {"shape": [], "dtype": "int32"}
    assert leaves["step"] == {"shape": [], "dtype": "int32"}
    if quantize:
        assert leaves["opt/m/tail/ffn/w_up/q"]["dtype"] == "int8"
        assert leaves["opt/v/embed/scale"]["shape"] == [512, 1]
    else:
        assert leaves["opt/m/tail/ffn/w_up"] == {"shape": [2, 64, 128], "dtype": "float32"}
    with np.load(path / "arrays.npz") as npz:
        assert npz["params/embed"].dtype == np.uint16
    template = _state(quantize, seed=1, steps_run=0)
    got, extra = manager.restore_checkpoint(tmp_path, 7, template)
    assert extra == {"loader": {"clock": 5}}
    assert got.params.embed.dtype == torch.bfloat16 and got.params.embed.requires_grad
    for t_got, t_want in zip(got.params.parameters(), state.params.parameters()):
        assert torch.equal(t_got.view(torch.int16), t_want.view(torch.int16))
    _same(train_state_to_numpy(got), train_state_to_numpy(state))
    # and the JAX manager reads the same file into the JAX TrainState
    jstate, _ = jmanager.restore_checkpoint(tmp_path, 7, _jax_template(quantize))
    assert str(jstate.params["embed"].dtype) == "bfloat16"
    np.testing.assert_array_equal(np.asarray(jstate.params["embed"]).astype(np.float32),
                                  train_state_to_numpy(state)["params"]["embed"])


def _jax_template(quantize, arch="gemma-2b", seed=0):
    from repro.configs import get_config as jax_config
    from repro.launch.steps import TrainState
    from repro.models import api as japi
    from repro.optim.adamw import adamw as jadamw

    jc = jax_config(arch, reduced=True)
    return TrainState.create(japi.init_params(jax.random.PRNGKey(seed), jc),
                             jadamw(1e-3, quantize_moments=quantize))


V3 = "deepseek-v3-671b"


def _as_numpy(tree):
    """A JAX train state's tree as numpy, bfloat16 as float32 (exact), in
    ``train_state_to_numpy``'s form."""
    import jax.numpy as jnp

    def leaf(a):
        return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)

    return {"params": jax.tree.map(leaf, tree.params),
            "opt": jax.tree.map(leaf, dict(tree.opt)), "step": leaf(tree.step)}


def _port_v3_template():
    cfg = get_config(V3, reduced=True)
    return steps.TrainState.create(api.init_params(1, cfg, device="cpu"), adamw.adamw(1e-3))


def test_jax_deepseek_v3_state_restores_in_the_port(tmp_path):
    """A JAX ``TrainState`` of reduced deepseek-v3, its moments seeded
    nonzero, saved by the JAX manager: the port restores every leaf bit for
    bit, the ``mtp`` subtree and the float32 routers included."""
    import jax.numpy as jnp
    from repro.launch.steps import TrainState

    tmpl = _jax_template(False, V3, seed=2)
    rng = np.random.default_rng(2)
    draw = lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32) * 1e-3)  # noqa: E731
    opt = dict(tmpl.opt, count=jnp.int32(5), m=jax.tree.map(draw, tmpl.opt["m"]),
               v=jax.tree.map(lambda a: jnp.abs(draw(a)), tmpl.opt["v"]))
    jstate = TrainState(tmpl.params, opt, jnp.int32(5))
    jmanager.save_checkpoint(tmp_path, 5, jstate, extra={"loader": {"clock": 3}})
    leaves = json.loads((tmp_path / "step_00000005" / "manifest.json").read_text())["leaves"]
    assert leaves["params/tail/ffn/router"]["dtype"] == "float32"
    assert leaves["params/mtp/block/ffn/router"]["dtype"] == "float32"
    assert leaves["params/mtp/block/mixer/wq_a"]["dtype"] == "bfloat16"
    got, extra = manager.restore_checkpoint(tmp_path, 5, _port_v3_template())
    assert extra == {"loader": {"clock": 3}} and int(got.step) == 5
    assert got.params.mtp.block.ffn.router.dtype == torch.float32
    assert got.params.tail[0].ffn.w_up.dtype == torch.bfloat16
    _same(train_state_to_numpy(got), _as_numpy(jstate))


def test_port_deepseek_v3_state_restores_in_jax(tmp_path):
    """The reverse: a port state of reduced deepseek-v3 after two train
    steps, saved by the port's manager, restores in the JAX manager bit for
    bit."""
    cfg = get_config(V3, reduced=True)
    opt = adamw.adamw(1e-3)
    state = steps.TrainState.create(api.init_params(3, cfg, device="cpu"), opt)
    step = steps.make_train_step(cfg, opt)
    rng = np.random.default_rng(3)
    for _ in range(2):
        state, _ = step(state, {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))})
    manager.save_checkpoint(tmp_path, 2, state)
    jstate, _ = jmanager.restore_checkpoint(tmp_path, 2, _jax_template(False, V3))
    assert str(jstate.params["mtp"]["block"]["ffn"]["router"].dtype) == "float32"
    assert str(jstate.params["tail"]["ffn"]["w_gate"].dtype) == "bfloat16"
    want = train_state_to_numpy(state)
    assert float(np.abs(want["opt"]["m"]["mtp"]["block"]["ffn"]["router"]).max()) > 0
    _same(_as_numpy(jstate), want)


SSM_ARCHS = ["mamba2-2.7b", "zamba2-7b"]


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_jax_ssm_state_restores_in_the_port(tmp_path, arch):
    """A JAX ``TrainState`` of the reduced SSM or hybrid config, its moments
    seeded nonzero, saved by the JAX manager: the port restores every leaf
    bit for bit, zamba2's (G, L) ``groups`` moments and ``shared_attn``
    moments included."""
    import jax.numpy as jnp
    from repro.launch.steps import TrainState

    tmpl = _jax_template(False, arch, seed=4)
    rng = np.random.default_rng(4)
    draw = lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32) * 1e-3)  # noqa: E731
    opt = dict(tmpl.opt, count=jnp.int32(3), m=jax.tree.map(draw, tmpl.opt["m"]),
               v=jax.tree.map(lambda a: jnp.abs(draw(a)), tmpl.opt["v"]))
    jstate = TrainState(tmpl.params, opt, jnp.int32(3))
    jmanager.save_checkpoint(tmp_path, 3, jstate, extra={"loader": {"clock": 2}})
    leaves = json.loads((tmp_path / "step_00000003" / "manifest.json").read_text())["leaves"]
    cfg = get_config(arch, reduced=True)
    if cfg.hybrid_attn_period:
        g, per = cfg.num_layers // cfg.hybrid_attn_period, cfg.hybrid_attn_period
        assert leaves["opt/m/groups/mixer/w_in"]["shape"][:2] == [g, per]
        assert leaves["opt/v/shared_attn/attn/wq"]["dtype"] == "float32"
        assert leaves["params/shared_attn/mlp/w_up"]["dtype"] == "bfloat16"
    tmpl_port = steps.TrainState.create(api.init_params(1, cfg, device="cpu"),
                                        adamw.adamw(1e-3))
    got, extra = manager.restore_checkpoint(tmp_path, 3, tmpl_port)
    assert extra == {"loader": {"clock": 2}} and int(got.step) == 3
    _same(train_state_to_numpy(got), _as_numpy(jstate))


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_port_ssm_state_restores_in_jax(tmp_path, arch):
    """The reverse: a port state of the reduced SSM or hybrid config after
    two train steps, saved by the port's manager, restores in the JAX
    manager bit for bit."""
    cfg = get_config(arch, reduced=True)
    opt = adamw.adamw(1e-3)
    state = steps.TrainState.create(api.init_params(3, cfg, device="cpu"), opt)
    step = steps.make_train_step(cfg, opt)
    rng = np.random.default_rng(3)
    for _ in range(2):
        state, _ = step(state, {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))})
    manager.save_checkpoint(tmp_path, 2, state)
    jstate, _ = jmanager.restore_checkpoint(tmp_path, 2, _jax_template(False, arch))
    want = train_state_to_numpy(state)
    if cfg.hybrid_attn_period:
        assert np.shape(jstate.opt["m"]["groups"]["mixer"]["w_in"])[:2] == (
            cfg.num_layers // cfg.hybrid_attn_period, cfg.hybrid_attn_period)
        assert float(np.abs(want["opt"]["m"]["shared_attn"]["attn"]["wq"]).max()) > 0
        assert float(np.abs(want["opt"]["v"]["groups"]["mixer"]["a_log"]).max()) > 0
    _same(_as_numpy(jstate), want)


LAST_FAMILIES = ["whisper-tiny", "pixtral-12b"]


def _family_batch(cfg, rng) -> dict:
    """Tokens, and the ``frames`` or ``patch_embeds`` the family takes."""
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32))}
    if cfg.encoder_decoder:
        batch["frames"] = torch.from_numpy(
            rng.standard_normal((2, cfg.encoder_seq, cfg.d_model)).astype(np.float32))
    if cfg.vision_prefix:
        batch["patch_embeds"] = torch.from_numpy(
            rng.standard_normal((2, cfg.num_patches, cfg.vision_dim)).astype(np.float32))
    return batch


@pytest.mark.parametrize("arch", LAST_FAMILIES)
def test_jax_last_family_state_restores_in_the_port(tmp_path, arch):
    """A JAX ``TrainState`` of reduced whisper (``enc`` and ``dec`` stacked
    layer-leading, ``pos_dec``, the LayerNorms' ``g`` and ``b``) or pixtral
    (``vision_proj``), its moments seeded nonzero, saved by the JAX manager:
    the port restores every leaf bit for bit."""
    import jax.numpy as jnp
    from repro.launch.steps import TrainState

    tmpl = _jax_template(False, arch, seed=6)
    rng = np.random.default_rng(6)
    draw = lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32) * 1e-3)  # noqa: E731
    opt = dict(tmpl.opt, count=jnp.int32(2), m=jax.tree.map(draw, tmpl.opt["m"]),
               v=jax.tree.map(lambda a: jnp.abs(draw(a)), tmpl.opt["v"]))
    jstate = TrainState(tmpl.params, opt, jnp.int32(2))
    jmanager.save_checkpoint(tmp_path, 2, jstate, extra={"loader": {"clock": 1}})
    leaves = json.loads((tmp_path / "step_00000002" / "manifest.json").read_text())["leaves"]
    cfg = get_config(arch, reduced=True)
    if cfg.encoder_decoder:
        assert leaves["params/dec/cross_attn/wk"]["shape"][0] == cfg.num_layers
        assert leaves["opt/m/enc/ln1/g"]["shape"] == [cfg.encoder_layers, cfg.d_model]
    else:
        assert leaves["opt/v/vision_proj"]["shape"] == [cfg.vision_dim, cfg.d_model]
    tmpl_port = steps.TrainState.create(api.init_params(1, cfg, device="cpu"),
                                        adamw.adamw(1e-3))
    got, extra = manager.restore_checkpoint(tmp_path, 2, tmpl_port)
    assert extra == {"loader": {"clock": 1}} and int(got.step) == 2
    _same(train_state_to_numpy(got), _as_numpy(jstate))


@pytest.mark.parametrize("arch", LAST_FAMILIES)
def test_port_last_family_state_restores_in_jax(tmp_path, arch):
    """The reverse: a port state of reduced whisper or pixtral after two
    train steps, saved by the port's manager, restores in the JAX manager
    bit for bit."""
    cfg = get_config(arch, reduced=True)
    opt = adamw.adamw(1e-3)
    state = steps.TrainState.create(api.init_params(3, cfg, device="cpu"), opt)
    step = steps.make_train_step(cfg, opt)
    rng = np.random.default_rng(3)
    for _ in range(2):
        state, _ = step(state, _family_batch(cfg, rng))
    manager.save_checkpoint(tmp_path, 2, state)
    jstate, _ = jmanager.restore_checkpoint(tmp_path, 2, _jax_template(False, arch))
    want = train_state_to_numpy(state)
    key = ("dec", "cross_attn", "wq") if cfg.encoder_decoder else ("vision_proj",)
    m = want["opt"]["m"]
    for k in key:
        m = m[k]
    assert float(np.abs(m).max()) > 0
    _same(_as_numpy(jstate), want)


def test_a_torn_write_never_becomes_latest(tmp_path, monkeypatch):
    state = _state()
    manager.save_checkpoint(tmp_path, 4, state)

    def torn(*args, **kwargs):  # the archive's writer, leaf by leaf
        (tmp_path / "partial").write_text("x")
        raise OSError("disk full")

    monkeypatch.setattr(manager.np.lib.format, "write_array", torn)
    with pytest.raises(OSError, match="disk full"):
        manager.save_checkpoint(tmp_path, 8, state)
    monkeypatch.undo()
    assert manager.latest_step(tmp_path) == 4
    assert not list(tmp_path.glob(".tmp_ckpt_*")) and not (tmp_path / "step_00000008").exists()
    # a step directory with no manifest (a copy cut short) is not a checkpoint
    (tmp_path / "step_00000012").mkdir()
    assert manager.latest_step(tmp_path) == 4
    assert manager.latest_step(tmp_path / "absent") is None


def test_keep_last_and_the_manager_cadence(tmp_path):
    state = _state()
    mgr = manager.CheckpointManager(tmp_path, every=2, keep_last=2)
    saved = [s for s in range(9) if mgr.maybe_save(s, state) is not None]
    assert saved == [2, 4, 6, 8]
    assert sorted(p.name for p in tmp_path.glob("step_*")) == ["step_00000006", "step_00000008"]
    step, got, extra = mgr.restore_latest(state)
    assert step == 8 and extra == {}
    assert manager.CheckpointManager(tmp_path / "none").restore_latest(state) == (None, None, None)


def test_restore_refuses_a_template_that_does_not_match(tmp_path):
    manager.save_checkpoint(tmp_path, 1, _state(quantize=False))
    with pytest.raises(KeyError, match="opt/m/embed/q"):
        manager.restore_checkpoint(tmp_path, 1, _state(quantize=True, steps_run=0))
    cfg = get_config("gemma-2b", reduced=True)
    import dataclasses

    wider = dataclasses.replace(cfg, d_ff=256)
    opt = adamw.adamw(1e-3)
    tmpl = steps.TrainState.create(api.init_params(0, wider, device="cpu"), opt)
    with pytest.raises(ValueError, match="shape"):
        manager.restore_checkpoint(tmp_path, 1, tmpl)


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX driver runs 8 steps with a checkpoint at step 4; the port's
    driver restores it (train state, loader clock, scheduler) and runs steps
    5-7 to JAX's losses."""
    d = tmp_path / "jax"
    ref = jtrain.main(ARGS + ["--ckpt-dir", str(d)])
    assert manager.latest_step(d) == 4
    resumed = train.main(ARGS + ["--ckpt-dir", str(d)], device="cpu")
    assert resumed["start_step"] == 5 and resumed["steps_run"] == 3
    np.testing.assert_allclose(resumed["losses"], ref["losses"][5:], rtol=0, atol=LOSS_TOL)


def test_jax_deepseek_v3_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX driver trains reduced deepseek-v3 (MLA, MoE, MTP) 8 steps with
    a checkpoint at step 4; the port's driver resumes it to JAX's losses."""
    args = ["--arch", V3, *ARGS[2:]]
    d = tmp_path / "jax"
    ref = jtrain.main(args + ["--ckpt-dir", str(d)])
    resumed = train.main(args + ["--ckpt-dir", str(d)], device="cpu")
    assert resumed["start_step"] == 5 and resumed["steps_run"] == 3
    np.testing.assert_allclose(resumed["losses"], ref["losses"][5:], rtol=0, atol=LOSS_TOL)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    """The reverse: the port's driver writes step 4, the JAX driver resumes."""
    d = tmp_path / "port"
    ref = train.main(ARGS + ["--ckpt-dir", str(d)], device="cpu")
    copy = tmp_path / "copy"
    shutil.copytree(d, copy)
    resumed = jtrain.main(ARGS + ["--ckpt-dir", str(copy)])
    assert resumed["start_step"] == 5
    np.testing.assert_allclose(resumed["losses"], ref["losses"][5:], rtol=0, atol=LOSS_TOL)
    # resuming in the port itself is bit-identical
    again = train.main(ARGS + ["--ckpt-dir", str(d)], device="cpu")
    np.testing.assert_allclose(again["losses"], ref["losses"][5:], rtol=0, atol=0)
