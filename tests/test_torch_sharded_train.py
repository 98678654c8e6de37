"""Training on a mesh: the port's sharded train step on 2x2 gloo meshes of
four CPU ranks against the port's unsharded step and the JAX package's
unsharded step, from the same JAX weights (float32); elastic resume across
meshes; the driver's ``--mesh``.

  * qwen1.5-4b (reduced, dense; TP over ``model``, FSDP over ``data``, the
    vocab-sharded cross-entropy) and again with ``pallas_flash`` (the flash
    forward on each rank's shards through ``pspec.local_call``), 3 steps: each
    step's losses within rtol 1e-5 of the unsharded port's, within
    ``test_torch_train``'s TRAJ_TOL of JAX's, and every parameter and
    moment after the last within PARAM_REL_RMS of JAX's (of the unsharded
    port's with flash: JAX's flash has no gradient, and the einsum path's
    bias steps part from flash's by more, sharded or not).
  * reduced deepseek-v2-lite (MLA + MoE), 2 steps through the
    expert-parallel block (64 tokens a rank), no drops (capacity factor
    E/k: with drops the sharded groups, 64 tokens, drop other assignments
    than the unsharded ones, 256), and the aux coefficient 0: the EP aux
    is the mean of the ranks' aux losses (JAX's ``pmean``), not the global
    aux; ``test_torch_ep.py`` holds it to that mean.
  * elastic resume, the JAX test's contract
    (``tests/integration/test_geo_and_elastic.py``): 2 steps of qwen on
    (2,2), a checkpoint, restored on (4,1), on (1,4) (each rank's shards
    in buffers of their own size), on one device and by the JAX package
    (every leaf bit for bit as the port's one-device restore); the next
    step's loss on each within rtol 1e-5 of the run continued on (2,2).
  * ``train.main(["--mesh", "2x2"])`` on four ranks trains (bfloat16,
    so within 1e-3 of the one-device driver's losses); ``--mesh 2x1`` on
    four ranks raises."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_mesh_workers as workers  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.checkpoint import manager  # noqa: E402
from repro_torch.convert import _port_named, lm_params_from_numpy, train_state_to_numpy  # noqa: E402
from repro_torch.launch import steps, train  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

pytestmark = pytest.mark.proc

RTOL = 1e-5            # sharded against unsharded, the port's own step
TRAJ_TOL = 1e-4        # test_torch_train's, against JAX
PARAM_REL_RMS = 1e-3   # test_torch_train's
STEPS = 3
MOE = "deepseek-v2-lite-16b"


def _cfgs(arch, **kw):
    kw = dict(param_dtype="float32", compute_dtype="float32", **kw)
    return (dataclasses.replace(jax_config(arch, reduced=True), **{**kw, "attn_impl": "xla"}),
            dataclasses.replace(workers.dense_config(arch), **kw))


def _case(arch, seq, seed, steps, **kw):
    """(JAX config, port config, JAX weight tree, batches)."""
    jc, tc = _cfgs(arch, **kw)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(seed), jc))
    rng = np.random.default_rng(seed)
    batches = [{"tokens": rng.integers(0, jc.vocab_size, (4, seq)).astype(np.int32)}
               for _ in range(steps)]
    return jc, tc, tree, batches


def _no_drop(arch):
    c = jax_config(arch, reduced=True)
    return c.num_experts / c.top_k


# name: (arch, seq, seed, steps, config changes)
CASES = {
    "dense": ("qwen1.5-4b", 16, 3, STEPS, {}),
    "flash": ("qwen1.5-4b", 16, 3, 1, {"attn_impl": "pallas_flash"}),
    "moe": (MOE, 64, 4, 2, {"capacity_factor": _no_drop(MOE), "router_aux_coef": 0.0}),
}


def _opts(steps):
    kw = dict(weight_decay=0.01, grad_clip=1.0)
    return (jadamw.adamw(jsched.warmup_cosine(3e-3, 2, steps), **kw),
            adamw.adamw(schedules.warmup_cosine(3e-3, 2, steps), **kw))


@pytest.fixture(scope="module")
def cases():
    return {name: _case(arch, seq, seed, steps, **kw)
            for name, (arch, seq, seed, steps, kw) in CASES.items()}


@pytest.fixture(scope="module")
def sharded(cases, tmp_path_factory):
    d = str(tmp_path_factory.mktemp("elastic"))
    args = [(name, tc, tree, batches, (2, 2)) for name, (_, tc, tree, batches) in cases.items()]
    out = run_ranks(workers.sharded_train, 4, args=(args, d), timeout=400)
    return out, d


def _unsharded(case):
    """(port losses and final state, JAX losses and final state) unsharded."""
    jc, tc, tree, batches = case
    jopt, topt = _opts(len(batches))
    jstate = jsteps.TrainState.create(jax.tree.map(jnp.asarray, tree), jopt)
    tstate = steps.TrainState.create(lm_params_from_numpy(tc, tree, device="cpu"), topt)
    jstep, tstep = jax.jit(jsteps.make_train_step(jc, jopt)), steps.make_train_step(tc, topt)
    jl, tl = [], []
    for b in batches:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])})
        tstate, tm = tstep(tstate, {"tokens": torch.from_numpy(b["tokens"])})
        jl.append({k: float(v) for k, v in jm.items()})
        tl.append({k: float(v) for k, v in tm.items()})
    return tl, train_state_to_numpy(tstate), jl, jax.tree.map(np.asarray, jstate)


def _close(got: dict, want) -> None:
    """Every parameter and moment within PARAM_REL_RMS of ``want``'s (a JAX
    state, or the port's own as ``train_state_to_numpy`` gives it)."""
    if isinstance(want, dict):
        want = jsteps.TrainState(want["params"], want["opt"], want["step"])
    for part, g_tree, w_tree in (("params", got["params"], want.params),
                                 ("m", got["opt"]["m"], want.opt["m"]),
                                 ("v", got["opt"]["v"], want.opt["v"])):
        g, w = _port_named(g_tree), _port_named(w_tree)
        assert set(g) == set(w)
        for name in g:
            if name.endswith("mixer.bk") and part == "params":
                # softmax ignores a per-query shift: bk's gradient is zero
                # but for rounding, and its AdamW steps (lr at most 3e-3 a
                # step) take that noise's sign
                assert np.abs(g[name]).max() <= 3e-3 * STEPS and \
                    np.abs(w[name]).max() <= 3e-3 * STEPS
                continue
            rel = np.linalg.norm(g[name] - w[name]) / max(np.linalg.norm(w[name]), 1e-30)
            assert rel <= PARAM_REL_RMS, f"{part} {name}: rel RMS {rel}"


@pytest.mark.parametrize("name", ["dense", "flash", "moe"])
def test_sharded_steps_match_the_unsharded_port_and_jax(name, cases, sharded):
    ranks, _ = sharded
    tl, tstate, jl, jstate = _unsharded(cases[name])
    for r, out in enumerate(ranks):
        got = out[name]
        for i, (g, t, j) in enumerate(zip(got["losses"], tl, jl)):
            for key in ("lm_loss", "total_loss"):
                assert abs(g[key] - t[key]) <= RTOL * abs(t[key]), (r, i, key, g[key], t[key])
                assert abs(g[key] - j[key]) <= TRAJ_TOL * abs(j[key]), (r, i, key)
        _close(got["state"], tstate if name == "flash" else jstate)
    if name == "flash":  # a forward and a recompute a layer a step, on each rank's shards
        assert ranks[0][name]["flash_calls"] == 2 * len(tl) * cases[name][1].num_layers


def test_elastic_resume_across_meshes_one_device_and_jax(cases, sharded):
    from repro.checkpoint import manager as jmanager

    ranks, d = sharded
    jc, tc, tree, batches = cases["dense"]
    elastic = ranks[0]["elastic"]
    want = elastic["2x2"][0]["total_loss"]
    for mesh in ("4x1", "1x4"):
        assert abs(elastic[mesh][0]["total_loss"] - want) <= RTOL * want, mesh
    opt = adamw.adamw(1e-3)
    template = steps.TrainState.create(lm_params_from_numpy(tc, tree, device="cpu"), opt)
    one, _ = manager.restore_checkpoint(d, 2, template)
    assert int(one.step) == 2
    _, m = steps.make_train_step(tc, opt)(one, {"tokens": torch.from_numpy(batches[2]["tokens"])})
    assert abs(float(m["total_loss"]) - want) <= RTOL * want
    # the JAX package restores the same files: the same leaves, bit for bit
    jopt = jadamw.adamw(1e-3)
    jtmpl = jsteps.TrainState.create(japi.init_params(jax.random.PRNGKey(0), jc), jopt)
    jstate, _ = jmanager.restore_checkpoint(d, 2, jtmpl)
    again, _ = manager.restore_checkpoint(d, 2, template)
    mine = train_state_to_numpy(again)
    for part, g_tree, w_tree in (("params", mine["params"], jstate.params),
                                 ("m", mine["opt"]["m"], jstate.opt["m"]),
                                 ("v", mine["opt"]["v"], jstate.opt["v"])):
        g, w = _port_named(g_tree), _port_named(jax.tree.map(np.asarray, w_tree))
        for name in g:
            assert g[name].tobytes() == w[name].tobytes(), (part, name)
    _, jm = jax.jit(jsteps.make_train_step(jc, jopt))(jstate, {"tokens": jnp.asarray(batches[2]["tokens"])})
    assert abs(float(jm["total_loss"]) - want) <= TRAJ_TOL * want


ARGS = ["--arch", "qwen1.5-4b", "--steps", "3", "--batch", "4", "--seq", "32",
        "--log-every", "100"]


def test_driver_trains_on_a_mesh_and_refuses_one_that_does_not_fit():
    one = train.main(ARGS, device="cpu")["losses"]
    ranks = run_ranks(workers.train_driver, 4, args=(ARGS + ["--mesh", "2x2"],), timeout=200)
    for out in ranks:
        got = out["result"]["losses"]
        assert len(got) == 3 and np.allclose(got, one, rtol=1e-3, atol=0), (got, one)
    ranks = run_ranks(workers.train_driver, 4, args=(ARGS + ["--mesh", "2x1"],), timeout=200)
    assert all("needs 2 ranks, the world has 4" in out["error"] for out in ranks)
