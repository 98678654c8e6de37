"""Port's training path against the JAX package: ``train_loss`` and every
gradient leaf on the reduced dense configs, the reduced MLA + MoE configs
(deepseek-v2-lite; deepseek-v3 with its MTP branch) and the reduced SSM
(mamba2) and hybrid (zamba2) configs, JAX weights carried over with
``convert``; the train step over 4 steps with one and two microbatches; and
the driver (``launch/train.py``): kill-and-resume bit-identical, a loss that
falls, a mesh that does not fit the world refused.  The MoE cases first
assert that both packages routed alike: each dispatch's ``idx_k`` and
``keep``, in call order, equal.

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
from repro.models import moe as jmoe  # noqa: E402
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
from repro_torch.models import api, losses, moe  # noqa: E402
from repro_torch.models import lm as lm_mod  # noqa: E402
from repro_torch.models import ssm as ssm_mod  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

GRAD_TOL = 1e-4
TRAJ_TOL = 1e-4
PARAM_REL_RMS = 1e-3
ARCHS = ["phi3-medium-14b", "qwen1.5-4b", "gemma-2b", "gemma3-1b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
SSM_ARCHS = ["mamba2-2.7b", "zamba2-7b"]
LAST_FAMILIES = ["whisper-tiny", "pixtral-12b"]
# (arch, the port's attn_impl) of the gradient test: mamba2 has no attention
GRAD_CASES = ([(a, impl) for a in ARCHS for impl in ("xla", "pallas_flash")]
              + [("mamba2-2.7b", "xla"), ("zamba2-7b", "xla"), ("zamba2-7b", "pallas_flash")])
# the JAX driver test's arguments (tests/integration/test_train_driver.py)
ARGS = ["--arch", "gemma-2b", "--steps", "12", "--batch", "2", "--seq", "32",
        "--ckpt-every", "4", "--log-every", "100"]
MOE_ARGS = ["--arch", "deepseek-v3-671b", *ARGS[2:]]


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
_JAX_METRICS: dict = {}


def _jax_loss_and_grads(arch):
    """(jax params as numpy, tokens, loss, grads as numpy) on the xla path."""
    if arch not in _JAX_GRADS:
        jc, _ = _configs(arch)
        jp = japi.init_params(jax.random.PRNGKey(11), jc)
        toks = _tokens(jc, 2, 24, seed=5)
        (loss, metrics), g = jax.jit(jax.value_and_grad(
            lambda p: japi.train_loss(p, {"tokens": jnp.asarray(toks)}, jc), has_aux=True))(jp)
        _JAX_GRADS[arch] = (jax.tree.map(np.asarray, jp), toks, float(loss),
                            jax.tree.map(np.asarray, g))
        _JAX_METRICS[arch] = {k: float(v) for k, v in metrics.items()}
    return _JAX_GRADS[arch]


def _attention_calls(cfg) -> int:
    """Full-sequence attention calls of a forward: one a layer, one a group
    (the shared block) for a hybrid config, none for pure SSM."""
    return lm_mod._layer_plan(cfg)["groups"] if cfg.ssm else cfg.num_layers


@pytest.mark.parametrize("arch,impl", GRAD_CASES)
def test_train_loss_and_grads_match_jax(arch, impl, monkeypatch):
    tree, toks, want_loss, want_grads = _jax_loss_and_grads(arch)
    _, tc = _configs(arch, impl)
    calls = []
    real = flash_ops.attention_bwd_lse_ref
    monkeypatch.setattr(flash_ops, "attention_bwd_lse_ref",
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
    # the flash Function's backward ran once a flash call: a layer, or the
    # shared block once a group (gemma3's windowed layers take the einsum
    # path, as in JAX)
    flash_calls = 0 if (impl == "xla" or tc.sliding_window) else _attention_calls(tc)
    assert len(calls) == flash_calls
    assert (flash_calls > 0) == (arch != "mamba2-2.7b" and impl == "pallas_flash"
                                 and not tc.sliding_window)


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
def test_vision_prefix_loss_and_grads_match_jax(impl):
    """Reduced pixtral with ``patch_embeds``: the loss over the tokens alone
    (the prefix's logits dropped, n_prefix > 0) and every gradient leaf,
    ``vision_proj``'s included, against ``jax.grad`` on JAX's ``xla`` path."""
    jc, tc = _configs("pixtral-12b", impl)
    jp = japi.init_params(jax.random.PRNGKey(12), jc)
    rng = np.random.default_rng(12)
    toks = _tokens(jc, 2, 24, seed=12)
    patches = rng.standard_normal((2, jc.num_patches, jc.vision_dim)).astype(np.float32)
    jbatch = {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, jbatch, jc), has_aux=True))(jp)
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    metrics, grads = steps.loss_and_grads(
        model.requires_grad_(True), {"tokens": toks, "patch_embeds": patches}, tc)
    assert abs(float(metrics["total_loss"]) - float(loss)) <= 1e-5 * abs(float(loss))
    with torch.no_grad():
        text_only, _ = api.train_loss(model, {"tokens": toks}, tc)
    assert abs(float(text_only) - float(loss)) > 1e-3  # the prefix is in the loss
    want = _port_named(jax.tree.map(np.asarray, g))
    assert set(want) == set(grads) and "vision_proj" in grads
    for name, gt in grads.items():
        _leaf_close(gt.numpy(), want[name], GRAD_TOL, f"pixtral {impl} grad {name}")


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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_blocks_are_recomputed_and_the_shared_block_is_not(arch, monkeypatch):
    """Under a gradient each group and tail Mamba block's ``mamba_forward``
    runs once in the forward and once more in the backward (``jax.checkpoint``
    of JAX's layer and tail scan bodies); zamba2's shared block is not
    checkpointed, as in JAX: its flash forward runs once a group in the
    forward and not again, and its flash backward once a group."""
    _, tc = _configs(arch, "pallas_flash")
    tree, toks, _, _ = _jax_loss_and_grads(arch)
    model = lm_params_from_numpy(tc, tree, device="cpu").requires_grad_(True)
    calls = {"mamba": 0, "flash": 0, "flash_bwd": 0}

    def counted(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ssm_mod, "mamba_forward", counted("mamba", ssm_mod.mamba_forward))
    monkeypatch.setattr(flash_ops, "_forward", counted("flash", flash_ops._forward))
    monkeypatch.setattr(flash_ops, "attention_bwd_lse_ref",
                        counted("flash_bwd", flash_ops.attention_bwd_lse_ref))
    groups = lm_mod._layer_plan(tc)["groups"]
    loss, _ = lm_mod.train_loss(model, {"tokens": toks}, tc)
    assert calls == {"mamba": tc.num_layers, "flash": groups, "flash_bwd": 0}
    loss.backward()
    assert calls == {"mamba": 2 * tc.num_layers, "flash": groups, "flash_bwd": groups}
    assert (groups, lm_mod._layer_plan(tc)["tail"]) == ((2, 1) if tc.hybrid_attn_period
                                                        else (0, tc.num_layers))


def _trajectory_matches_jax(arch, micro):
    """4 train steps of the reduced ``arch`` in float32 with ``micro``
    microbatches against JAX's jitted step from the same weights: each
    step's loss within TRAJ_TOL, every parameter and moment leaf within
    PARAM_REL_RMS relative RMS after the last."""
    jc, tc = _configs(arch)
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
            assert rel <= PARAM_REL_RMS, f"{arch} µ={micro} {part} {name}: rel RMS {rel}"


@pytest.mark.parametrize("micro", [1, 2])
def test_train_step_matches_jax_over_4_steps(micro):
    _trajectory_matches_jax("gemma-2b", micro)


@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_step_matches_jax_over_4_steps(arch, micro):
    """Reduced mamba2 (chunk 8: 2 chunks of the 16-token rows) and zamba2
    (2 groups of 3 Mamba blocks, the shared block after each, a tail of
    1)."""
    _trajectory_matches_jax(arch, micro)


def _jax_routes(fn, *args):
    """``fn(*args)`` under ``jax.jit`` with each of JAX's dispatches logged:
    (idx_k, keep) as numpy, in call order.  Traced anew on every call: a
    cached trace would log into an earlier call's list."""
    log, real = [], jmoe._dispatch_indices

    def observed(idx_k, e, cap):
        dst, keep = real(idx_k, e, cap)
        jax.debug.callback(lambda i, k: log.append((np.asarray(i), np.asarray(k))),
                           idx_k, keep, ordered=True)
        return dst, keep

    jmoe._dispatch_indices = observed
    try:
        jax.block_until_ready(jax.jit(lambda *a: fn(*a))(*args))
        jax.effects_barrier()
    finally:
        jmoe._dispatch_indices = real
    return log


class _PortRoutes:
    """Logs each of the port's dispatches, (idx_k, keep) on the CPU, in call
    order, while the context is open."""

    def __enter__(self):
        self.log, self._real = [], moe._dispatch_indices

        def observed(idx_k, e, cap):
            dst, keep = self._real(idx_k, e, cap)
            self.log.append((idx_k.detach().cpu().numpy(), keep.cpu().numpy()))
            return dst, keep

        moe._dispatch_indices = observed
        return self

    def __exit__(self, *exc):
        moe._dispatch_indices = self._real


def _same_routes(got: list, want: list) -> None:
    assert len(got) == len(want) > 0
    for (gi, gk), (wi, wk) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gk, wk)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_loss_and_grads_match_jax(arch):
    """The MLA + MoE family's ``train_loss`` (aux loss through the stack; for
    deepseek-v3 the MTP branch, ``mtp_loss`` and the ``mtp.*`` leaves) and
    every gradient leaf against JAX's, after asserting that every dispatch
    (each MoE layer's, and the MTP block's) routed alike."""
    tree, toks, want_loss, want_grads = _jax_loss_and_grads(arch)
    jc, tc = _configs(arch)
    want_routes = _jax_routes(lambda p: japi.train_loss(p, {"tokens": jnp.asarray(toks)}, jc),
                              jax.tree.map(jnp.asarray, tree))
    model = lm_params_from_numpy(tc, tree, device="cpu")
    with torch.no_grad(), _PortRoutes() as routes:
        api.train_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
    n_moe = tc.num_layers - tc.first_dense_layers + tc.mtp_depth
    assert len(want_routes) == n_moe
    _same_routes(routes.log, want_routes)
    assert any(not k.all() for _, k in routes.log), "some assignment drops"

    model.requires_grad_(True)
    named = dict(model.named_parameters())
    loss, metrics = api.train_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
    grads = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    want_metrics = _JAX_METRICS[arch]
    assert set(metrics) == set(want_metrics) == (
        {"lm_loss", "aux_loss", "total_loss"} | ({"mtp_loss"} if tc.mtp_depth else set()))
    for k, v in metrics.items():
        assert abs(float(v.detach()) - want_metrics[k]) <= 1e-5 * abs(want_metrics[k]), k
    assert abs(float(loss.detach()) - want_loss) <= 1e-5 * abs(want_loss)
    want = _port_named(want_grads)
    assert set(want) == set(grads)
    assert any(n.startswith("mtp.block.ffn.") for n in grads) == bool(tc.mtp_depth)
    for name, g in grads.items():
        assert g.dtype == torch.float32
        _leaf_close(g.numpy(), want[name], GRAD_TOL, f"{arch} grad {name}")


def test_moe_recompute_routes_as_the_forward():
    """Each checkpointed MoE tail block is recomputed in the backward and
    routes there exactly as in the forward; the MTP block is not
    checkpointed (JAX runs it outside the tail scan)."""
    tree, toks, _, _ = _jax_loss_and_grads("deepseek-v3-671b")
    _, tc = _configs("deepseek-v3-671b")
    model = lm_params_from_numpy(tc, tree, device="cpu").requires_grad_(True)
    tail = tc.num_layers - tc.first_dense_layers
    with _PortRoutes() as routes:
        loss, _ = api.train_loss(model, {"tokens": torch.from_numpy(toks)}, tc)
        assert len(routes.log) == tail + 1
        loss.backward()
    assert len(routes.log) == 2 * tail + 1
    _same_routes(routes.log[tail + 1:], routes.log[:tail][::-1])


@pytest.mark.parametrize("micro", [1, 2])
def test_moe_train_step_matches_jax_over_4_steps(micro):
    """Reduced deepseek-v3 (MLA with query LoRA, MoE, MTP): 4 train steps
    against JAX's, the float32 router included, with every step's routing
    asserted alike first."""
    jc, tc = _configs("deepseek-v3-671b")
    kw = dict(weight_decay=0.01, grad_clip=1.0)
    jopt = jadamw.adamw(jsched.warmup_cosine(3e-3, 2, 4), **kw)
    topt = adamw.adamw(schedules.warmup_cosine(3e-3, 2, 4), **kw)
    jp = japi.init_params(jax.random.PRNGKey(3), jc)
    jstate = jsteps.TrainState.create(jp, jopt)
    tstate = steps.TrainState.create(
        lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu"), topt)
    jstep = jax.jit(jsteps.make_train_step(jc, jopt, num_microbatches=micro))
    tstep = steps.make_train_step(tc, topt, num_microbatches=micro)
    loss_fn = lambda p, t: japi.train_loss(p, {"tokens": t}, jc)  # noqa: E731
    for i in range(4):
        toks = _tokens(jc, 4, 16, seed=100 + i)
        mb = toks.reshape(micro, -1, toks.shape[1])
        want_routes = [r for j in range(micro)
                       for r in _jax_routes(loss_fn, jstate.params, jnp.asarray(mb[j]))]
        with torch.no_grad(), _PortRoutes() as routes:
            for j in range(micro):
                api.train_loss(tstate.params, {"tokens": torch.from_numpy(mb[j])}, tc)
        _same_routes(routes.log, want_routes)
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(toks)})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(toks)})
        for k in ("lm_loss", "mtp_loss", "total_loss"):
            assert abs(float(tm[k]) - float(jm[k])) <= TRAJ_TOL * float(jm[k]), (i, k)
    got = train_state_to_numpy(tstate)
    want = jax.tree.map(np.asarray, jstate)
    assert int(got["opt"]["count"]) == int(want.opt["count"]) == 4
    assert tstate.params.tail[0].ffn.router.dtype == torch.float32
    for part, g_tree, w_tree in (("params", got["params"], want.params),
                                 ("m", got["opt"]["m"], want.opt["m"]),
                                 ("v", got["opt"]["v"], want.opt["v"])):
        g, w = _port_named(g_tree), _port_named(w_tree)
        assert set(g) == set(w)
        for name in g:
            rel = np.linalg.norm(g[name] - w[name]) / max(np.linalg.norm(w[name]), 1e-30)
            assert rel <= PARAM_REL_RMS, f"µ={micro} {part} {name}: rel RMS {rel}"


def test_bf16_moe_step_keeps_the_float32_router():
    """In a bfloat16 model (reduced deepseek-v2-lite's own dtypes) the
    router, its gradient, its accumulated microbatch gradient and its AdamW
    moments stay float32; every other weight stays bfloat16."""
    cfg = get_config("deepseek-v2-lite-16b", reduced=True)
    opt = adamw.adamw(3e-3)
    state = steps.TrainState.create(api.init_params(0, cfg, device="cpu"), opt)
    toks = torch.from_numpy(_tokens(cfg, 4, 16, seed=9))
    metrics, grads = steps.loss_and_grads(state.params, {"tokens": toks}, cfg)
    for micro in (1, 2):
        state, metrics = steps.make_train_step(cfg, opt, num_microbatches=micro)(
            state, {"tokens": toks})
        assert all(np.isfinite(float(v)) for v in metrics.values())
    for name, p in state.params.named_parameters():
        want = torch.float32 if name.endswith("ffn.router") else torch.bfloat16
        assert p.dtype == grads[name].dtype == want, name
        assert state.opt["m"][name].dtype == state.opt["v"][name].dtype == torch.float32
    assert int(state.step) == 2


def test_moe_driver_kill_and_resume_bit_identical(tmp_path):
    """The driver's kill at step 9 and resume, bit-identical, on reduced
    deepseek-v3 (MLA, MoE with drops, MTP)."""
    ref = train.main(MOE_ARGS + ["--ckpt-dir", str(tmp_path / "uninterrupted")], device="cpu")
    assert ref["steps_run"] == 12 and ref["last_loss"] < ref["first_loss"]
    killed = str(tmp_path / "killed")
    with pytest.raises(SystemExit) as e:
        train.main(MOE_ARGS + ["--ckpt-dir", killed, "--kill-at", "9"], device="cpu")
    assert e.value.code == 17
    resumed = train.main(MOE_ARGS + ["--ckpt-dir", killed], device="cpu")
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


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


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_driver_kill_and_resume_bit_identical(arch, tmp_path):
    """The driver on reduced mamba2 and zamba2 (the JAX driver test's
    arguments): a loss that falls, and the kill at step 9 and resume
    bit-identical."""
    args = ["--arch", arch, *ARGS[2:]]
    ref = train.main(args + ["--ckpt-dir", str(tmp_path / "uninterrupted")], device="cpu")
    assert ref["steps_run"] == 12 and ref["last_loss"] < ref["first_loss"]
    killed = str(tmp_path / "killed")
    with pytest.raises(SystemExit) as e:
        train.main(args + ["--ckpt-dir", killed, "--kill-at", "9"], device="cpu")
    assert e.value.code == 17
    resumed = train.main(args + ["--ckpt-dir", killed], device="cpu")
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


def test_driver_loss_decreases_over_training():
    res = train.main(ARGS, device="cpu")
    assert res["last_loss"] < res["first_loss"]


def test_driver_refuses_a_mesh_and_unported_families():
    """The driver refuses a mesh that is not the world's size (here a
    world of one: the mesh path's multi-rank runs are
    ``test_torch_sharded_train.py``'s); the two families it refused while
    they were unported (whisper, pixtral) take a step, with ``--mesh 1x1``
    (the mesh path on one rank)."""
    for mesh in ("2x1", "1x2", "4x2"):
        with pytest.raises(ValueError, match="the world has 1"):
            train.main(ARGS + ["--mesh", mesh], device="cpu")
    for arch in LAST_FAMILIES:
        res = train.main(["--arch", arch, "--steps", "1", "--batch", "2", "--seq", "16",
                          "--mesh", "1x1"], device="cpu")
        assert res["steps_run"] == 1 and np.isfinite(res["first_loss"])


@pytest.mark.parametrize("arch", LAST_FAMILIES)
def test_last_families_driver_kill_and_resume_bit_identical(arch, tmp_path):
    """The driver on reduced whisper and pixtral (the JAX driver test's
    arguments), each step's ``frames`` or ``patch_embeds`` drawn by
    ``make_dummy_batch(seed=step)``: a loss that falls, and the kill at
    step 9 and resume bit-identical."""
    args = ["--arch", arch, *ARGS[2:]]
    ref = train.main(args + ["--ckpt-dir", str(tmp_path / "uninterrupted")], device="cpu")
    assert ref["steps_run"] == 12 and ref["last_loss"] < ref["first_loss"]
    killed = str(tmp_path / "killed")
    with pytest.raises(SystemExit) as e:
        train.main(args + ["--ckpt-dir", killed, "--kill-at", "9"], device="cpu")
    assert e.value.code == 17
    resumed = train.main(args + ["--ckpt-dir", killed], device="cpu")
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


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
def test_moe_driver_kill_and_resume_on_card(cuda_device, tmp_path):
    """``chip_smoke.py``'s ``lm_moe_train.kill_resume``: the driver's resume
    on the card for reduced deepseek-v3, where the gathers' backward
    (``scatter_add`` with atomics on the sentinel row) could break it."""
    ref = train.main(MOE_ARGS + ["--ckpt-dir", str(tmp_path / "a")], device=cuda_device)
    with pytest.raises(SystemExit):
        train.main(MOE_ARGS + ["--ckpt-dir", str(tmp_path / "b"), "--kill-at", "9"],
                   device=cuda_device)
    resumed = train.main(MOE_ARGS + ["--ckpt-dir", str(tmp_path / "b")], device=cuda_device)
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_driver_kill_and_resume_on_card(cuda_device, arch, tmp_path):
    """``chip_smoke.py``'s ``lm_ssm_train``/``lm_hybrid_train`` resume on the
    card: the SSD's ``repeat_interleave`` (its backward a sum over the
    expanded dimension), the conv and the shared block's gradient summed
    over groups keep a step bit-reproducible."""
    args = ["--arch", arch, *ARGS[2:]]
    ref = train.main(args + ["--ckpt-dir", str(tmp_path / "a")], device=cuda_device)
    with pytest.raises(SystemExit):
        train.main(args + ["--ckpt-dir", str(tmp_path / "b"), "--kill-at", "9"],
                   device=cuda_device)
    resumed = train.main(args + ["--ckpt-dir", str(tmp_path / "b")], device=cuda_device)
    assert resumed["start_step"] == 9
    np.testing.assert_allclose(resumed["losses"], ref["losses"][9:], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_train_step_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """``chip_smoke.py``'s ``ssm_train_parity``: 4 float32 train steps of
    reduced mamba2 and zamba2 on the card (TF32 off) against the same steps
    on the CPU from the same weights and batches."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    jc, tc = _configs(arch)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(3), jc))
    opt = adamw.adamw(schedules.warmup_cosine(3e-3, 2, 4), weight_decay=0.01)
    runs = []
    for dev in ("cpu", cuda_device):
        state = steps.TrainState.create(lm_params_from_numpy(tc, tree, device=dev), opt)
        step, losses = steps.make_train_step(tc, opt), []
        for i in range(4):
            toks = torch.from_numpy(_tokens(tc, 4, 16, seed=100 + i)).to(dev)
            state, m = step(state, {"tokens": toks})
            losses.append(float(m["total_loss"]))
        runs.append((losses, train_state_to_numpy(state)))
    (cl, cs), (gl, gs) = runs
    np.testing.assert_allclose(gl, cl, rtol=TRAJ_TOL, atol=0)
    for part in ("params", "m", "v"):
        g = _port_named(gs[part] if part == "params" else gs["opt"][part])
        c = _port_named(cs[part] if part == "params" else cs["opt"][part])
        for name in c:
            rel = np.linalg.norm(g[name] - c[name]) / max(np.linalg.norm(c[name]), 1e-30)
            assert rel <= PARAM_REL_RMS, f"{part} {name}: rel RMS {rel}"


@pytest.mark.gpu
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_train_step_on_card_matches_cpu(cuda_device, arch, monkeypatch):
    """``chip_smoke.py``'s ``moe_train_parity``: 4 float32 train steps on the
    card (TF32 off) against the same steps on the CPU from the same weights,
    routing identical at every step."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    jc, tc = _configs(arch)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(3), jc))
    opt = adamw.adamw(schedules.warmup_cosine(3e-3, 2, 4), weight_decay=0.01)
    runs = []
    for dev in ("cpu", cuda_device):
        state = steps.TrainState.create(lm_params_from_numpy(tc, tree, device=dev), opt)
        step, losses, routes = steps.make_train_step(tc, opt), [], []
        for i in range(4):
            toks = torch.from_numpy(_tokens(tc, 4, 16, seed=100 + i)).to(dev)
            with _PortRoutes() as r:
                state, m = step(state, {"tokens": toks})
            losses.append(float(m["total_loss"]))
            routes += r.log
        runs.append((losses, routes, train_state_to_numpy(state)))
    (cl, cr, cs), (gl, gr, gs) = runs
    _same_routes(gr, cr)
    np.testing.assert_allclose(gl, cl, rtol=TRAJ_TOL, atol=0)
    for part in ("params", "m", "v"):
        g = _port_named(gs[part] if part == "params" else gs["opt"][part])
        c = _port_named(cs[part] if part == "params" else cs["opt"][part])
        for name in c:
            rel = np.linalg.norm(g[name] - c[name]) / max(np.linalg.norm(c[name]), 1e-30)
            assert rel <= PARAM_REL_RMS, f"{part} {name}: rel RMS {rel}"


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
