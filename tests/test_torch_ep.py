"""The port's expert-parallel MoE (``repro_torch/models/moe.py::_moe_ep``)
on a 2x2 gloo mesh against the JAX package's einsum oracle
(``moe_apply_einsum``) at the JAX EP test's config
(``tests/models/test_moe_dispatch.py``: 8 experts, top-2, group 64, cf 8,
one shared expert, float32) and bounds: outputs and aux within 1e-4,
gradients within 5e-3.  Each rank's routing and dispatch indices equal, to
the bit, JAX's ``_route``/``_dispatch_indices`` on that rank's groups (the
rank's 128 tokens of the token-sharded batch, in groups of 64).  The aux
loss is the mean over ranks of each rank's aux (JAX's ``pmean``), not the
global one, hence the oracle's bound and not equality.

On a mesh without a ``model`` axis wider than 1 (here (4,1)) ``moe_apply``
takes ``_moe_local``, whose aux is the global one.  On a 1x1 mesh (one
rank, as ``chip_smoke.py`` runs it) ``_moe_ep`` is ``moe_apply`` bit for
bit, forward and gradient."""

import dataclasses
import tempfile

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_mesh_workers as workers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.launch.mesh import make_mesh, process_group, run_ranks  # noqa: E402
from repro_torch.models import moe, sharding  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.pspec import activation_mesh  # noqa: E402

pytestmark = pytest.mark.proc

# the JAX EP test's config, group size, capacity factor and bounds
CFG = dict(name="t", family="moe", num_layers=2, d_model=32, vocab_size=64, num_heads=2,
           num_kv_heads=2, head_dim=16, moe=True, num_experts=8, top_k=2, moe_d_ff=16,
           num_shared_experts=1, d_ff=16, param_dtype="float32", compute_dtype="float32")
GROUP, CF = 64, 8.0
Y_TOL, AUX_TOL, GRAD_TOL = 1e-4, 1e-4, 5e-3


@pytest.fixture(scope="module")
def case():
    jc = JaxModelConfig(**CFG)
    p = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.PRNGKey(0), jc, dtype=jnp.float32))
    x = np.random.default_rng(1).standard_normal((4, 128, 32)).astype(np.float32)

    def oracle(p):
        return jmoe.moe_apply_einsum(p, jnp.asarray(x), jc, group_size=GROUP,
                                     capacity_factor=CF)

    y, aux = jax.jit(oracle)(p)
    g = jax.jit(jax.grad(lambda p: oracle(p)[0].sum()))(p)
    return jc, p, x, np.asarray(y), float(aux), jax.tree.map(np.asarray, g)


@pytest.fixture(scope="module")
def ranks(case):
    _, p, x, *_ = case
    cfg = ModelConfig(**CFG)
    return {shape: run_ranks(workers.ep, 4, args=(cfg, p, x, GROUP, CF, shape), timeout=150)
            for shape in ((2, 2), (4, 1))}


def test_ep_matches_the_einsum_oracle_on_a_2x2_mesh(case, ranks):
    _, _, _, y, aux, g = case
    for r, out in enumerate(ranks[(2, 2)]):
        assert out["paths"] == ["ep"], f"rank {r} took {out['paths']}"
        assert np.abs(out["y"] - y).max() <= Y_TOL
        assert abs(out["aux"] - aux) <= AUX_TOL
        for name, want in workers._flat(g).items():
            got = out["grads"][name]
            assert np.abs(got - want).max() <= GRAD_TOL, name


def test_ep_routes_each_ranks_groups_as_jax(case, ranks):
    """Rank (d, m) holds tokens [(2d+m)·128, +128) of the flattened batch
    and routes them in two groups of 64, as JAX's shard_map body does; the
    aux loss is the mean over the ranks of each one's aux."""
    jc, p, x, *_ = case
    e, cap = jc.num_experts, jmoe._capacity(jc, GROUP, CF)
    toks = x.reshape(-1, x.shape[-1])
    auxes = []
    for r, out in enumerate(ranks[(2, 2)]):
        xg = jnp.asarray(toks[r * 128:(r + 1) * 128].reshape(-1, GROUP, x.shape[-1]))
        _, idx_k, aux = jmoe._route({"router": jnp.asarray(p["router"])}, xg, jc)
        auxes.append(float(aux))
        dst, keep = jmoe._dispatch_indices(idx_k, e, cap)
        (got_idx, got_dst, got_keep), = out["routes"]
        np.testing.assert_array_equal(got_idx, np.asarray(idx_k).astype(np.int64))
        np.testing.assert_array_equal(got_dst, np.asarray(dst))
        np.testing.assert_array_equal(got_keep, np.asarray(keep))
    # the aux: each rank's aux over its own groups, averaged (JAX's pmean)
    for out in ranks[(2, 2)]:
        assert abs(out["aux"] - np.mean(auxes)) <= 1e-6 * abs(np.mean(auxes))


def test_moe_without_a_model_axis_takes_the_local_path(case, ranks):
    """(4,1): no expert parallelism; groups over the data axis, the global
    aux loss, the oracle's outputs and gradients."""
    _, _, _, y, aux, g = case
    for out in ranks[(4, 1)]:
        assert out["paths"] == ["local"]
        assert np.abs(out["y"] - y).max() <= Y_TOL
        assert abs(out["aux"] - aux) <= 1e-6 * abs(aux) + 1e-9
        for name, want in workers._flat(g).items():
            assert np.abs(out["grads"][name] - want).max() <= GRAD_TOL, name


def test_ep_on_a_1x1_mesh_is_moe_apply_bit_for_bit(case):
    """One rank, ep = 1: the all-to-alls move nothing and the block runs the
    one-device path's ops on the same groups (the routed experts only)."""
    _, p, x, *_ = case
    cfg = ModelConfig(**CFG)
    routed = {k: torch.from_numpy(np.array(p[k])) for k in ("router", "w_gate", "w_up", "w_down")}
    plain = {k: v.clone().requires_grad_(True) for k, v in routed.items()}
    xt = torch.from_numpy(x)
    y0, a0 = moe.moe_apply(plain, xt, cfg, group_size=GROUP, capacity_factor=CF)
    g0 = torch.autograd.grad(y0.sum() + a0, list(plain.values()))
    with tempfile.TemporaryDirectory() as d, process_group("gloo", 0, 1, d):
        mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
        specs = sharding.param_specs({f"ffn.{k}": v for k, v in routed.items()}, cfg, mesh)
        dp = {k: sharding.distribute_tensor(v, specs[f"ffn.{k}"], mesh).requires_grad_(True)
              for k, v in routed.items()}
        xd = sharding.distribute_tensor(xt, ("data", None, None), mesh)
        with activation_mesh(mesh):
            y1, a1 = moe._moe_ep(dp, xd, cfg, mesh, GROUP, CF)
            g1 = torch.autograd.grad(y1.sum() + a1, list(dp.values()))
        y1, a1 = y1.full_tensor(), a1.full_tensor()
        g1 = [g.full_tensor() for g in g1]
    assert torch.equal(y1, y0) and torch.equal(a1, a0)
    for name, a, b in zip(routed, g0, g1):
        assert torch.equal(a, b), name


def test_moe_gate_matches_jax(case):
    """The five conditions of JAX's gate: a model axis wider than 1 that
    divides E, tokens divisible by the mesh, >= 64 tokens a rank."""
    from repro_torch.launch.mesh import AbstractMesh

    cfg = ModelConfig(**CFG)
    picked = []
    ep_fn, local_fn = moe._moe_ep, moe._moe_local
    moe._moe_ep = lambda *a: picked.append("ep") or (a[1], 0.0)
    moe._moe_local = lambda *a: picked.append("local") or (a[1], 0.0)
    try:
        for shape, tokens in [((2, 2), 512), ((4, 1), 512), ((1, 3), 384), ((2, 2), 128),
                              ((2, 2), 256), ((1, 8), 512)]:
            mesh = AbstractMesh(shape, ("data", "model"))
            x = torch.zeros((1, tokens, 32))
            with activation_mesh(mesh):
                moe.moe_apply({}, x, dataclasses.replace(cfg, num_shared_experts=0))
            want = (shape[1] > 1 and cfg.num_experts % shape[1] == 0
                    and tokens % np.prod(shape) == 0 and tokens // np.prod(shape) >= 64)
            assert picked.pop() == ("ep" if want else "local"), (shape, tokens)
    finally:
        moe._moe_ep, moe._moe_local = ep_fn, local_fn
