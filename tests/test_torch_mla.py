"""Port's Multi-head Latent Attention (``repro_torch/models/mla.py``) against
the JAX package's ``models/mla.py`` on the same numpy-seeded inputs and
weights (in the tree of the JAX package's ``mla_init``): the full-sequence
attention with and without the query LoRA, at shared and per-row
positions; the absorbed decode step by step with its compressed caches; and
the absorbed decode against the expanded attention at the same positions.
The gradient of the expanded attention (the form training runs) against
``jax.grad`` of JAX's, for every weight and the input.

Tolerances: in float32 the two packages (and the absorbed and expanded
forms) differ in summation order only, so outputs and caches agree to 1e-4,
and each gradient leaf to 1e-4 of that leaf's largest entry; the cache's
``pos`` is exact."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import mla as jmla  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = 1e-4
_attention = jax.jit(jmla.mla_attention, static_argnames=("cfg",))
_decode = jax.jit(jmla.mla_decode, static_argnames=("cfg",))


def _cfgs(q_lora):
    kw = dict(name="t", family="moe", num_layers=1, d_model=32, vocab_size=64, num_heads=4,
              num_kv_heads=4, head_dim=16, use_mla=True, q_lora_rank=q_lora, kv_lora_rank=16,
              qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8, param_dtype="float32",
              compute_dtype="float32")
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _params(jc, seed=0):
    """(JAX params, the same weights as a dict of tensors): numpy-seeded,
    norms included, in the tree and shapes of ``mla_init``."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: jmla.mla_init(jax.random.PRNGKey(0), jc, dtype=jnp.float32))
    jp = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape, np.float32) * (
        1 / np.sqrt(a.shape[-2]) if len(a.shape) == 2 else 0.1)), shapes)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape, np.float32)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("q_lora", [0, 16])
def test_mla_attention_matches_jax(q_lora, per_row):
    jc, tc = _cfgs(q_lora)
    jp, tp = _params(jc, 1)
    x = _x((2, 12, 32), 2)
    pos = np.arange(12, dtype=np.int32)
    if per_row:  # per-row positions: the second row starts at 5
        pos = np.stack([pos, pos + 5])
    want = _attention(jp, jnp.asarray(x), jnp.asarray(pos), cfg=jc)
    got = mla.mla_attention(tp, torch.from_numpy(x), torch.from_numpy(pos), tc)
    assert got.shape == (2, 12, 32)
    _close(got, want)


@pytest.mark.parametrize("q_lora", [0, 16])
def test_mla_attention_grad_matches_jax(q_lora):
    """jax.grad of JAX's ``mla_attention`` against the port's autograd, for
    ``wq`` (or ``wq_a``, ``q_norm``, ``wq_b`` with the query LoRA),
    ``wkv_a``, ``kv_norm``, ``wkv_b``, ``wo`` and x, under a random
    cotangent."""
    jc, tc = _cfgs(q_lora)
    jp, tp = _params(jc, 7)
    x = _x((2, 12, 32), 8)
    ct = _x((2, 12, 32), 9)
    pos = np.arange(12, dtype=np.int32)
    jgp, jgx = jax.jit(jax.grad(
        lambda p, xx: (jmla.mla_attention(p, xx, jnp.asarray(pos), jc) * ct).sum(),
        argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y = mla.mla_attention(leaves, xt, torch.from_numpy(pos), tc)
    grads = torch.autograd.grad((y * torch.from_numpy(ct)).sum(), [xt, *leaves.values()])
    want = {"x": jgx, **jgp}
    assert set(want) == {"x", *leaves}
    assert ("q_norm" in leaves) == bool(q_lora)
    for name, g in zip(["x", *leaves], grads):
        w = np.asarray(want[name])
        scale = float(np.abs(w).max())
        assert scale > 0, name
        err = float(np.abs(g.numpy() - w).max())
        assert err <= TOL * scale, f"grad {name}: max err {err} > {TOL} x scale {scale}"


@pytest.mark.parametrize("q_lora", [0, 16])
def test_mla_decode_matches_jax(q_lora):
    """Six absorbed decode steps, each output and the final compressed
    caches (``c_kv``, ``k_pe``, ``pos``) as JAX's."""
    jc, tc = _cfgs(q_lora)
    jp, tp = _params(jc, 3)
    x = _x((2, 6, 32), 4)
    jcache = jmla.init_mla_cache(jc, 2, 9, dtype=jnp.float32)
    tcache = mla.init_mla_cache(tc, 2, 9, dtype=torch.float32)
    for t in range(6):
        want, jcache = _decode(jp, jnp.asarray(x[:, t:t + 1]), jcache, jnp.int32(t), cfg=jc)
        got, tcache = mla.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), tcache, t, tc)
        _close(got, want)
    assert tcache["pos"].dtype == torch.int32
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    np.testing.assert_array_equal(tcache["pos"][0].numpy(), [0, 1, 2, 3, 4, 5, -1, -1, -1])
    for key in ("c_kv", "k_pe"):
        assert tcache[key].shape == jcache[key].shape
        _close(tcache[key], jcache[key])


@pytest.mark.parametrize("q_lora", [0, 16])
def test_absorbed_decode_matches_expanded(q_lora):
    """Decoding token by token through the compressed cache gives what the
    expanded full-sequence attention gives at the same positions."""
    jc, tc = _cfgs(q_lora)
    _, tp = _params(jc, 5)
    x = torch.from_numpy(_x((3, 7, 32), 6))
    full = mla.mla_attention(tp, x, torch.arange(7, dtype=torch.int32), tc)
    cache = mla.init_mla_cache(tc, 3, 7, dtype=torch.float32)
    steps = [mla.mla_decode(tp, x[:, t:t + 1], cache, t, tc)[0] for t in range(7)]
    np.testing.assert_allclose(torch.cat(steps, dim=1).numpy(), full.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("q_lora", [0, 16])
def test_module_names_match_jax(q_lora):
    jc, tc = _cfgs(q_lora)
    jp, _ = _params(jc)
    m = mla.MLA(None, tc, dtype=torch.bfloat16, device="cpu")
    got = {n: tuple(p.shape) for n, p in m.named_parameters()}
    assert got == {k: v.shape for k, v in jp.items()}
    assert ("wq_a" in got) == bool(q_lora) and got["wkv_b"] == (16, 4 * (8 + 8))
