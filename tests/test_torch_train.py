"""Port's training path against the JAX package: ``train_loss`` and every
gradient leaf on the reduced dense configs (JAX weights carried over with
``convert``), the train step over 4 steps with one and two microbatches, and
the driver (``launch/train.py``): kill-and-resume bit-identical, a loss that
falls, one device only.

Tolerances: in float32 both packages do the same arithmetic and differ in
summation order only, so the loss agrees to 1e-5 relative and each gradient
leaf to GRAD_TOL of that leaf's largest entry.  The port's ``pallas_flash``
gradient is held against JAX's ``xla`` one: the JAX package cannot
differentiate its Pallas call (ROADMAP, reference faults), and the port's
flash backward is the einsum path's gradient by construction.  The 4-step
trajectory agrees to TRAJ_TOL in the loss; after AdamW's normalised steps
each parameter leaf agrees to PARAM_REL_RMS relative RMS, since an entry
whose gradient is within rounding of zero may take a step of another sign
(lr 3e-3)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _port_named,
    lm_params_from_numpy,
    train_state_to_numpy,
)
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.models import api, losses  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

GRAD_TOL = 1e-4
TRAJ_TOL = 1e-4
PARAM_REL_RMS = 1e-3
ARCHS = ["phi3-medium-14b", "qwen1.5-4b", "gemma-2b", "gemma3-1b"]
# the JAX driver test's arguments (tests/integration/test_train_driver.py)
ARGS = ["--arch", "gemma-2b", "--steps", "12", "--batch", "2", "--seq", "32",
        "--ckpt-every", "4", "--log-every", "100"]


def _configs(arch, impl="xla"):
    kw = dict(param_dtype="float32", compute_dtype="float32")
    return (dataclasses.replace(jax_config(arch, reduced=True), attn_impl="xla", **kw),
            dataclasses.replace(get_config(arch, reduced=True), attn_impl=impl, **kw))


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _leaf_close(got: np.ndarray, want: np.ndarray, tol: float, what: str) -> None:
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x scale {scale}"


def test_token_nll_matches_the_one_hot_sum():
    """logsumexp minus a gather is the JAX one-hot sum, and its backward is
    autograd's through the plain expression, in bfloat16 logits too."""
    from repro.models.losses import softmax_cross_entropy as jce

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 7))
    mask = rng.random((2, 7)) < 0.6
    for m in (None, mask):
        want = float(jce(jnp.asarray(logits), jnp.asarray(labels),
                         None if m is None else jnp.asarray(m)))
        got = losses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                           None if m is None else torch.from_numpy(m))
        assert got.dtype == torch.float32 and abs(float(got) - want) <= 1e-6 * abs(want)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(logits).to(dtype).requires_grad_(True)
        y = x.detach().float().requires_grad_(True)
        lab = torch.from_numpy(labels)
        g_out = torch.from_numpy(rng.standard_normal((2, 7)).astype(np.float32))
        (gx,) = torch.autograd.grad(losses.token_nll(x, lab), x, g_out)
        plain = torch.logsumexp(y, -1) - y.gather(-1, lab[..., None]).squeeze(-1)
        (gy,) = torch.autograd.grad(plain, y, g_out)
        assert gx.dtype == dtype
        torch.testing.assert_close(gx.float(), gy.to(dtype).float(), rtol=1e-5, atol=1e-6)


_JAX_GRADS: dict = {}


def _jax_loss_and_grads(arch):
    """(jax params as numpy, tokens, loss, grads as numpy) on the xla path."""
    if arch not in _JAX_GRADS:
        jc, _ = _configs(arch)
        jp = japi.init_params(jax.random.PRNGKey(11), jc)
        toks = _tokens(jc, 2, 24, seed=5)
        (loss, _), g = jax.jit(jax.value_and_grad(
            lambda p: japi.train_loss(p, {"tokens": jnp.asarray(toks)}, jc), has_aux=True))(jp)
        _JAX_GRADS[arch] = (jax.tree.map(np.asarray, jp), toks, float(loss),
                            jax.tree.map(np.asarray, g))
    return _JAX_GRADS[arch]


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_jax(arch, impl, monkeypatch):
    tree, toks, want_loss, want_grads = _jax_loss_and_grads(arch)
    _, tc = _configs(arch, impl)
    calls = []
    real = flash_ops.attention_bwd_ref
    monkeypatch.setattr(flash_ops, "attention_bwd_ref",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = lm_params_from_numpy(tc, tree, device="cpu").requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = api.train_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    assert set(metrics) == {"lm_loss", "aux_loss", "total_loss"}
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    want = _port_named(want_grads)
    assert set(want) == set(grads)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        _leaf_close(g.numpy(), want[name], GRAD_TOL, f"{arch} {impl} grad {name}")
    # the flash Function's backward ran once a flash layer (gemma3's
    # windowed layers take the einsum path, as in JAX)
    flash_layers = 0 if (impl == "xla" or tc.sliding_window) else tc.num_layers
    assert len(calls) == flash_layers


def test_tail_blocks_are_recomputed_in_the_backward(monkeypatch):
    """With trainable weights each tail block runs under
    ``torch.utils.checkpoint`` (forward once, again in the backward), as
    ``jax.checkpoint`` wraps the JAX tail scan; frozen (serving) weights run
    each block once."""
    from repro_torch.models import lm

    _, tc = _configs("gemma-2b", "pallas_flash")
    tree, toks, _, _ = _jax_loss_and_grads("gemma-2b")
    model = lm_params_from_numpy(tc, tree, device="cpu")
    calls = []
    real = flash_ops._forward
    monkeypatch.setattr(flash_ops, "_forward", lambda *a: calls.append(1) or real(*a))
    api.forward_logits(model, {"tokens": toks}, tc)
    assert len(calls) == tc.num_layers
    calls.clear()
    model.requires_grad_(True)
    loss, _ = lm.train_loss(model, {"tokens": toks}, tc)
    assert len(calls) == tc.num_layers
    loss.backward()
    assert len(calls) == 2 * tc.num_layers


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax_over_4_steps(micro):
    jc, tc = _configs("gemma-2b")
    kw = dict(weight_decay=0.01, grad_clip=1.0)
    jopt = jadamw.adamw(jsched.warmup_cosine(3e-3, 2, 4), **kw)
    topt = adamw.adamw(schedules.warmup_cosine(3e-3, 2, 4), **kw)
    jp = japi.init_params(jax.random.PRNGKey(3), jc)
    jstate = jsteps.TrainState.create(jp, jopt)
    tstate = steps.TrainState.create(
        lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu"), topt)
    jstep = jax.jit(jsteps.make_train_step(jc, jopt, num_microbatches=micro))
    tstep = steps.make_train_step(tc, topt, num_microbatches=micro)
    for i in range(4):
        toks = _tokens(jc, 4, 16, seed=100 + i)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        assert abs(float(tm["lm_loss"]) - float(jm["lm_loss"])) <= TRAJ_TOL * float(jm["lm_loss"])
    assert int(tstate.step) == int(jstate.step) == 4
    got = train_state_to_numpy(tstate)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["opt"]["count"]) == int(want.opt["count"]) == 4
    for part, g_tree, w_tree in (("params", got["params"], want.params),
                                 ("m", got["opt"]["m"], want.opt["m"]),
                                 ("v", got["opt"]["v"], want.opt["v"])):
        g, w = _port_named(g_tree), _port_named(w_tree)
        assert set(g) == set(w)
        for name in g:
            rel = np.linalg.norm(g[name] - w[name]) / max(np.linalg.norm(w[name]), 1e-30)
            assert rel <= PARAM_REL_RMS, f"µ={micro} {part} {name}: rel RMS {rel}"


def test_driver_kill_and_resume_bit_identical(tmp_path):
    """The JAX driver test, on the port's driver on the CPU."""
    ref = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "uninterrupted")], device="cpu")
    assert ref["steps_run"] == 12
    killed = str(tmp_path / "killed")
    with pytest.raises(SystemExit) as e:
        train.main(ARGS + ["--ckpt-dir", killed, "--kill-at", "9"], device="cpu")
    assert e.value.code == 17
    resumed = train.main(ARGS + ["--ckpt-dir", killed], device="cpu")
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


def test_driver_loss_decreases_over_training():
    res = train.main(ARGS, device="cpu")
    assert res["last_loss"] < res["first_loss"]


def test_driver_refuses_a_mesh_and_unported_families():
    for mesh in ("2x1", "1x2", "4x2"):
        with pytest.raises(ValueError, match="one device"):
            train.main(ARGS + ["--mesh", mesh], device="cpu")
    for arch in ("whisper-tiny", "pixtral-12b", "deepseek-v3-671b"):
        with pytest.raises(NotImplementedError, match="not ported yet"):
            train.main(["--arch", arch, "--steps", "1", "--batch", "2", "--seq", "16"],
                       device="cpu")


def test_train_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _configs("gemma-2b")
    for make in (lambda: train.main(ARGS), lambda: train.main(ARGS + ["--mesh", "1x1"]),
                 lambda: train.build_data_plane(tc, seq_len=32, batch=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_driver_kill_and_resume_on_card(cuda_device, tmp_path):
    """The driver's resume guarantee on the card: the embedding's backward
    and every other op of the step are deterministic there too."""
    ref = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "a")], device=cuda_device)
    with pytest.raises(SystemExit):
        train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b"), "--kill-at", "9"],
                   device=cuda_device)
    resumed = train.main(ARGS + ["--ckpt-dir", str(tmp_path / "b")], device=cuda_device)
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


@pytest.mark.gpu
def test_flash_train_step_on_card(cuda_device):
    """The reduced gemma-2b in bfloat16 with ``pallas_flash`` on the card:
    each layer's flash forward launches twice a step (forward and recompute),
    and the loss and gradients agree with the ``xla`` step's from the same
    weights and batch within ``chip_smoke.py``'s ``lm_train`` bounds (1e-3
    relative, 0.05 relative RMS a leaf).  At head_dim 16 the kernel is the
    CUDA-core route, which keeps P in float32: the two paths differ in
    summation order and bfloat16 roundings only."""
    cfg = dataclasses.replace(get_config("gemma-2b", reduced=True), attn_impl="pallas_flash")
    params = api.init_params(0, cfg, device=cuda_device).requires_grad_(True)
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 64)).to(cuda_device)}
    before = flash_ops.counter.launches
    fm, fg = steps.loss_and_grads(params, batch, cfg)
    assert flash_ops.counter.launches == before + 2 * cfg.num_layers
    xm, xg = steps.loss_and_grads(params, batch, dataclasses.replace(cfg, attn_impl="xla"))
    assert abs(float(fm["lm_loss"]) - float(xm["lm_loss"])) <= 1e-3 * float(xm["lm_loss"])
    for name in xg:
        rel = float((fg[name].float() - xg[name].float()).norm() / xg[name].float().norm())
        assert rel <= 0.05, f"{name}: rel RMS {rel}"
