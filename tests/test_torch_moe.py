"""Port's MoE FFN (``repro_torch/models/moe.py``) against the JAX package's
``models/moe.py`` on the same numpy-seeded tokens and weights (in the tree
of the JAX package's ``moe_init``): routing, the sort-based dispatch with
and without drops, the combine, the shared experts and the aux loss; the
port's dispatch against its own GShard einsum oracle; the decode call's
no-drop shape.  The gradient of ``moe_apply`` (through the k scatters into
the expert buffer, the sentinel row, the k gathers and the renormalized
gates) against ``jax.grad`` of JAX's, without and with drops, and against
the port's einsum oracle's; the aux loss's gradient, which reaches the
router through the mean router probability alone.  Each gradient test first
asserts that the two calls it compares routed alike (``idx_k`` and ``keep``).

Tolerances: integer results are exact (``idx_k``, ``dst``, ``keep``, byte
for byte in their dtypes).  In float32 outputs and aux losses agree to 1e-4
(the two packages differ in summation order only), and so does each
gradient leaf, relative to that leaf's largest entry (``GRAD_TOL``).  In
bfloat16 the two frameworks round intermediates at different places, so
outputs agree to ``BF16_TOL`` (absolute, on outputs of magnitude about 1)."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 0.05

# jitted: JAX's op-by-op dispatch compiles every op of every call
_moe_apply = jax.jit(jmoe.moe_apply, static_argnames=("cfg", "group_size", "capacity_factor"))
_route = jax.jit(jmoe._route, static_argnames=("cfg",))
_dispatch_indices = jax.jit(jmoe._dispatch_indices, static_argnames=("e", "cap"))


def _cfgs(e=8, k=2, shared=1, dtype="float32"):
    kw = dict(name="t", family="moe", num_layers=2, d_model=32, vocab_size=64,
              num_heads=2, num_kv_heads=2, head_dim=16, moe=True, num_experts=e, top_k=k,
              moe_d_ff=16, num_shared_experts=shared, d_ff=16, param_dtype=dtype,
              compute_dtype=dtype)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _tensor(a):
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _params(jc, seed=0):
    """(JAX params, the same weights as a dict of tensors): numpy-seeded
    normals scaled by 1/sqrt(fan in), in the tree, shapes and dtypes of the
    JAX package's ``moe_init`` (traced, not run: its random draws compile
    op by op)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmoe.moe_init(jax.random.PRNGKey(0), jc,
                                                  dtype=jnp.dtype(jc.param_dtype)))
    jp = jax.tree.map(lambda a: jnp.asarray(
        rng.standard_normal(a.shape, np.float32) / np.sqrt(a.shape[-2]), a.dtype), shapes)
    return jp, jax.tree.map(_tensor, jp)


def _x(shape, seed, offset=0.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape, np.float32)
    # a mean direction shared by every token, as hidden states have: it skews
    # the router's load, so the capacity binds
    return x + offset * rng.standard_normal(shape[-1], np.float32)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32)) if not isinstance(
        a, torch.Tensor) else a.float().numpy()


def _assert_close(got, want, tol=TOL):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=tol, atol=tol)


def _dispatch_both(jp, tp, x, jc, tc, group_size, cf):
    """(port's and JAX's idx_k, dst, keep) of one call's routing."""
    xg_j = jmoe._group(jnp.asarray(x), group_size)
    xg_t = moe._group(torch.from_numpy(x), group_size)
    cap = moe._capacity(tc, xg_t.shape[1], cf)
    assert cap == jmoe._capacity(jc, xg_j.shape[1], cf)
    _, jidx, _ = _route(jp, xg_j, cfg=jc)
    _, tidx, _ = moe._route(tp, xg_t, tc)
    jdst, jkeep = _dispatch_indices(jidx, e=jc.num_experts, cap=cap)
    tdst, tkeep = moe._dispatch_indices(tidx, tc.num_experts, cap)
    return (tidx, tdst, tkeep), tuple(np.asarray(a) for a in (jidx, jdst, jkeep))


@pytest.mark.parametrize("e,k", [(4, 1), (8, 2), (16, 4)])
def test_moe_apply_matches_jax_no_drop(e, k):
    jc, tc = _cfgs(e, k)
    jp, tp = _params(jc)
    x = _x((2, 32, 32), seed=1)
    want_y, want_aux = _moe_apply(jp, jnp.asarray(x), cfg=jc, group_size=32,
                                  capacity_factor=float(e))
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), tc, group_size=32,
                                   capacity_factor=float(e))
    assert got_y.shape == (2, 32, 32) and got_aux.dtype == torch.float32
    _assert_close(got_y, want_y)
    _assert_close(got_aux, want_aux)
    (_, _, keep), _ = _dispatch_both(jp, tp, x, jc, tc, 32, float(e))
    assert bool(keep.all())


@pytest.mark.parametrize("cf", [1.0, 1.25])
@pytest.mark.parametrize("seed", [0, 1])
def test_drop_policy_matches_jax(cf, seed):
    """When the capacity binds, the port drops the same assignments as the
    JAX package: ``idx_k``, ``dst`` and ``keep`` byte-identical, then the
    same outputs."""
    jc, tc = _cfgs(8, 2)
    jp, tp = _params(jc, seed)
    x = _x((2, 64, 32), seed=10 + seed, offset=1.0)
    (tidx, tdst, tkeep), (jidx, jdst, jkeep) = _dispatch_both(jp, tp, x, jc, tc, 64, cf)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    assert tdst.dtype == torch.int32 and jdst.dtype == np.int32
    assert tkeep.dtype == torch.bool and jkeep.dtype == np.bool_
    assert tdst.numpy().tobytes() == jdst.tobytes()
    assert tkeep.numpy().tobytes() == jkeep.tobytes()
    assert not bool(tkeep.all()), "the capacity binds"
    cap = moe._capacity(tc, 64, cf)
    np.testing.assert_array_equal(tdst.numpy()[~tkeep.numpy()], 8 * cap)  # the sentinel
    want_y, want_aux = _moe_apply(jp, jnp.asarray(x), cfg=jc, group_size=64, capacity_factor=cf)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), tc, group_size=64,
                                   capacity_factor=cf)
    _assert_close(got_y, want_y)
    _assert_close(got_aux, want_aux)


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_sort_dispatch_matches_own_einsum_oracle(cf):
    """The port's sort-based path against its GShard einsum oracle, with and
    without drops (the JAX package's own equivalence test)."""
    jc, tc = _cfgs(8, 2)
    _, tp = _params(jc, 3)
    x = torch.from_numpy(_x((2, 64, 32), seed=4, offset=1.0))
    y1, a1 = moe.moe_apply(tp, x, tc, group_size=64, capacity_factor=cf)
    y2, a2 = moe.moe_apply_einsum(tp, x, tc, group_size=64, capacity_factor=cf)
    _assert_close(y1, y2)
    _assert_close(a1, a2)


def test_odd_token_count_snaps_group():
    """21 tokens in groups of 8 snap to groups of 7, in both packages."""
    jc, tc = _cfgs(8, 2)
    jp, tp = _params(jc, 5)
    x = _x((3, 7, 32), seed=6)
    assert moe._group(torch.from_numpy(x), 8).shape == (3, 7, 32)
    assert jmoe._group(jnp.asarray(x), 8).shape == (3, 7, 32)
    want_y, want_aux = _moe_apply(jp, jnp.asarray(x), cfg=jc, group_size=8, capacity_factor=1.25)
    got_y, got_aux = moe.moe_apply(tp, torch.from_numpy(x), tc, group_size=8,
                                   capacity_factor=1.25)
    _assert_close(got_y, want_y)
    _assert_close(got_aux, want_aux)


def test_decode_call_is_no_drop():
    """The decode step's call: one group of the batch at cf = E/k keeps
    every assignment, and equals JAX's."""
    jc, tc = _cfgs(16, 4)
    jp, tp = _params(jc, 7)
    x = _x((5, 1, 32), seed=8, offset=3.0)  # a heavy skew: one expert for all
    cf = jc.num_experts / jc.top_k
    (_, _, keep), (_, _, jkeep) = _dispatch_both(jp, tp, x, jc, tc, 5, cf)
    assert bool(keep.all()) and jkeep.all()
    want_y, _ = _moe_apply(jp, jnp.asarray(x), cfg=jc, group_size=5, capacity_factor=cf)
    got_y, _ = moe.moe_apply(tp, torch.from_numpy(x), tc, group_size=5, capacity_factor=cf)
    _assert_close(got_y, want_y)


def test_aux_loss_balanced_vs_skewed():
    """The switch aux loss penalizes a skewed router more than the learned
    one, and equals JAX's in both cases."""
    jc, tc = _cfgs(8, 2, shared=0)
    jp, tp = _params(jc)
    x = _x((1, 128, 32), seed=3)
    _, aux = moe.moe_apply(tp, torch.from_numpy(x), tc, group_size=128)
    jp_skew = dict(jp, router=jp["router"].at[:, 0].add(100.0))
    tp_skew = dict(tp, router=tp["router"].clone())
    tp_skew["router"][:, 0] += 100.0
    _, aux_skew = moe.moe_apply(tp_skew, torch.from_numpy(x), tc, group_size=128)
    assert float(aux_skew) > float(aux)
    _assert_close(aux, _moe_apply(jp, jnp.asarray(x), cfg=jc, group_size=128)[1])
    _assert_close(aux_skew, _moe_apply(jp_skew, jnp.asarray(x), cfg=jc, group_size=128)[1])


def test_bf16_close_to_jax():
    jc, tc = _cfgs(8, 2, dtype="bfloat16")
    jp, tp = _params(jc, 2)
    assert tp["router"].dtype == torch.float32 and tp["w_gate"].dtype == torch.bfloat16
    x = _x((2, 32, 32), seed=9).astype(jnp.bfloat16)
    want_y, want_aux = _moe_apply(jp, jnp.asarray(x), cfg=jc, group_size=32, capacity_factor=8.0)
    got_y, got_aux = moe.moe_apply(tp, _tensor(x), tc, group_size=32, capacity_factor=8.0)
    assert got_y.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got_y), _f32(want_y), rtol=0, atol=BF16_TOL)
    _assert_close(got_aux, want_aux)


def test_module_names_match_jax():
    jc, tc = _cfgs(8, 2, shared=2, dtype="bfloat16")
    jp, _ = _params(jc)
    m = moe.MoE(None, tc, dtype=torch.bfloat16, device="cpu")
    names = {n: p for n, p in m.named_parameters()}
    want = {".".join(str(k.key) for k in path): leaf
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}
    assert sorted(names) == sorted(want)
    for n, p in names.items():
        assert tuple(p.shape) == want[n].shape
    assert names["router"].dtype == torch.float32 and names["shared.w_up"].shape == (32, 32)


def _grad_leaf_close(got: torch.Tensor, want, what: str) -> None:
    want = _f32(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(_f32(got) - want).max())
    assert err <= GRAD_TOL * scale, f"{what}: max err {err} > {GRAD_TOL} x scale {scale}"


def _flat(tree, prefix=""):
    """(dotted name, leaf) over a nested dict of leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _port_grads(apply, tp, x, ct, device="cpu"):
    """Gradients of sum(y * ct) + aux of ``apply(params, x)`` on ``device``,
    by leaf name (``x`` included), on the CPU."""
    leaves = {n: t.to(device, copy=True).requires_grad_(True) for n, t in _flat(tp)}
    xt = torch.from_numpy(x).to(device).requires_grad_(True)
    params = {n: t for n, t in leaves.items() if "." not in n}
    shared = {n.split(".", 1)[1]: t for n, t in leaves.items() if n.startswith("shared.")}
    if shared:
        params["shared"] = shared
    y, aux = apply(params, xt)
    loss = (y * torch.from_numpy(ct).to(device)).sum() + aux
    grads = torch.autograd.grad(loss, [xt, *leaves.values()])
    return {n: g.cpu() for n, g in zip(["x", *leaves], grads)}


def _jax_grads(jp, x, ct, jc, group_size, cf):
    def loss(p, xx):
        y, aux = jmoe.moe_apply(p, xx, jc, group_size=group_size, capacity_factor=cf)
        return (y * ct).sum() + aux

    gp, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(jp, jnp.asarray(x))
    return {"x": gx, **dict(_flat(gp))}


@pytest.mark.parametrize("cf,offset,drops", [(8.0, 0.0, False), (1.0, 1.0, True),
                                             (1.25, 1.0, True)])
def test_moe_grad_matches_jax(cf, offset, drops):
    """jax.grad of JAX's ``moe_apply`` (plus its aux loss) on the same
    weights and tokens: the gradients of x, ``router``, the expert stacks and
    the shared experts, with no drop (cf 8) and where the capacity binds
    (cf 1.0 and 1.25, tokens sharing an offset that skews the router)."""
    jc, tc = _cfgs(8, 2)
    jp, tp = _params(jc, 4)
    x = _x((2, 64, 32), seed=20, offset=offset)
    ct = np.random.default_rng(21).standard_normal(x.shape, np.float32)
    (tidx, _, tkeep), (jidx, _, jkeep) = _dispatch_both(jp, tp, x, jc, tc, 64, cf)
    np.testing.assert_array_equal(tidx.numpy(), jidx)
    np.testing.assert_array_equal(tkeep.numpy(), jkeep)
    assert bool(tkeep.all()) != drops
    got = _port_grads(lambda p, xx: moe.moe_apply(p, xx, tc, group_size=64,
                                                  capacity_factor=cf), tp, x, ct)
    want = _jax_grads(jp, x, ct, jc, 64, cf)
    assert set(got) == set(want) == {"x", "router", "w_gate", "w_up", "w_down",
                                     "shared.w_gate", "shared.w_up", "shared.w_down"}
    for name, g in got.items():
        _grad_leaf_close(g, want[name], f"cf {cf} grad {name}")


@pytest.mark.parametrize("cf", [1.0, 1.25, 8.0])
def test_sort_dispatch_grad_matches_own_einsum_oracle(cf):
    """JAX's ``test_gradients_match_oracle`` on the port, with drops too:
    the sort path's gradient (scatters, sentinel, gathers) equals the GShard
    einsum oracle's within 1e-4."""
    jc, tc = _cfgs(8, 2)
    jp, tp = _params(jc, 3)
    x = _x((2, 64, 32), seed=4, offset=1.0)
    ct = np.random.default_rng(5).standard_normal(x.shape, np.float32)
    (_, _, keep), _ = _dispatch_both(jp, tp, x, jc, tc, 64, cf)
    assert bool(keep.all()) == (cf == 8.0)
    sort = _port_grads(lambda p, xx: moe.moe_apply(p, xx, tc, group_size=64,
                                                   capacity_factor=cf), tp, x, ct)
    oracle = _port_grads(lambda p, xx: moe.moe_apply_einsum(p, xx, tc, group_size=64,
                                                            capacity_factor=cf), tp, x, ct)
    for name, g in sort.items():
        assert float((g - oracle[name]).abs().max()) < 1e-4, name


def test_aux_loss_grad_matches_jax_through_the_mean_probability_only():
    """The aux loss's gradient equals JAX's, where ``stop_gradient`` holds
    the top-1 fractions constant; in the port the fractions are counted by
    ``scatter_add_`` and carry no gradient, so the aux gradient is that of
    coef · E · Σ me · ce with ce a constant: it reaches the router (and x)
    through ``me`` alone."""
    jc, tc = _cfgs(8, 2, shared=0)
    jp, tp = _params(jc, 6)
    x = _x((2, 64, 32), seed=7, offset=1.0)
    xg_t = moe._group(torch.from_numpy(x), 64)
    router = tp["router"].clone().requires_grad_(True)
    xt = xg_t.clone().requires_grad_(True)
    _, idx_k, aux = moe._route({"router": router}, xt, tc)
    _, jidx, _ = _route(jp, jmoe._group(jnp.asarray(x), 64), cfg=jc)
    np.testing.assert_array_equal(idx_k.numpy(), np.asarray(jidx))
    g_router, g_x = torch.autograd.grad(aux, [router, xt])
    jg_router, jg_x = jax.jit(jax.grad(
        lambda r, xx: jmoe._route({"router": r}, xx, jc)[2], argnums=(0, 1)))(
        jp["router"], jmoe._group(jnp.asarray(x), 64))
    _grad_leaf_close(g_router, jg_router, "aux grad router")
    _grad_leaf_close(g_x, jg_x, "aux grad x")
    # the same gradient with the top-1 fractions as a constant
    r2 = tp["router"].clone().requires_grad_(True)
    x2 = xg_t.clone().requires_grad_(True)
    me = torch.softmax(x2 @ r2, dim=-1).mean(dim=(0, 1))
    ce = torch.bincount(idx_k[..., 0].reshape(-1), minlength=8).float() / idx_k[..., 0].numel()
    want = torch.autograd.grad(tc.router_aux_coef * 8 * (me * ce).sum(), [r2, x2])
    assert float(g_router.abs().max()) > 0
    torch.testing.assert_close(g_router, want[0], rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(g_x, want[1], rtol=1e-5, atol=1e-7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the dispatch runs on the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_moe_on_card(cuda_device):
    """``chip_smoke.py``'s ``moe_dispatch`` check at a small shape: the
    card's ``moe_apply`` against its einsum oracle with the capacity
    binding, and ``_dispatch_indices`` of the card's ``idx_k`` byte-identical
    to the same call on the CPU."""
    jc, tc = _cfgs(16, 4, shared=1)
    _, tp = _params(jc, 11)
    dev = {k: (v.to(cuda_device) if isinstance(v, torch.Tensor)
               else {n: w.to(cuda_device) for n, w in v.items()}) for k, v in tp.items()}
    x = torch.from_numpy(_x((4, 256, 32), seed=12, offset=1.0)).to(cuda_device)
    y, aux = moe.moe_apply(dev, x, tc, group_size=256, capacity_factor=1.25)
    y_ref, aux_ref = moe.moe_apply_einsum(dev, x, tc, group_size=256, capacity_factor=1.25)
    _assert_close(y.cpu(), y_ref.cpu())
    _assert_close(aux.cpu(), aux_ref.cpu())
    xg = moe._group(x, 256)
    _, idx_k, _ = moe._route(dev, xg, tc)
    cap = moe._capacity(tc, 256, 1.25)
    dst, keep = moe._dispatch_indices(idx_k, tc.num_experts, cap)
    cdst, ckeep = moe._dispatch_indices(idx_k.cpu(), tc.num_experts, cap)
    assert dst.cpu().numpy().tobytes() == cdst.numpy().tobytes()
    assert keep.cpu().numpy().tobytes() == ckeep.numpy().tobytes()
    assert not bool(ckeep.all()), "the capacity binds"


@pytest.mark.gpu
def test_moe_backward_on_card(cuda_device):
    """``chip_smoke.py``'s ``moe_backward`` check at a small shape in
    float32: the card's sort-path gradient against the einsum oracle's with
    the capacity binding (1e-4), and against the CPU's."""
    jc, tc = _cfgs(16, 4, shared=1)
    _, tp = _params(jc, 11)
    x = _x((4, 256, 32), seed=12, offset=1.0)
    ct = np.random.default_rng(13).standard_normal(x.shape, np.float32)
    sort = lambda p, xx: moe.moe_apply(p, xx, tc, group_size=256,  # noqa: E731
                                       capacity_factor=1.25)
    oracle = lambda p, xx: moe.moe_apply_einsum(p, xx, tc, group_size=256,  # noqa: E731
                                                capacity_factor=1.25)
    card = _port_grads(sort, tp, x, ct, cuda_device)
    card_oracle = _port_grads(oracle, tp, x, ct, cuda_device)
    cpu = _port_grads(sort, tp, x, ct)
    for name, g in card.items():
        _grad_leaf_close(g, card_oracle[name].numpy(), f"card sort vs oracle {name}")
        _grad_leaf_close(g, cpu[name].numpy(), f"card vs CPU {name}")
