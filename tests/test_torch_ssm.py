"""Port's Mamba2 block against the JAX package: the chunked SSD scan against
JAX's and against the O(L) recurrence, at the JAX SSM tests' shapes (L and
chunk (32, 8), (64, 16), (128, 128), (48, 16); B/C groups 1, 2, 4), and the
whole block's forward and decode on the JAX weights, carried over as numpy,
on numpy-seeded inputs.

Tolerances: in float32 both packages do the same arithmetic; the chunked
scan and the recurrence sum in other orders (and the two frameworks'
``cumsum`` and einsums in their own), so they agree to 1e-4, as in the JAX
tests.  Stepping decode over a sequence against the full-sequence forward
sums the state another way again, with the conv taken in float32: 2e-3, the
JAX test's bound.

The overflow case (dt = 0.5, A = -30 at chunk 8, so Σ dt·|A| over a chunk
reaches 105 > 88.7): JAX's ``where(tri, exp(diff), 0)`` has a NaN gradient
there (a reference fault); the port masks diff before ``exp``, and its
gradient is held to the recurrence's within GRAD_TOL of each leaf's largest
entry, the bound of the train tests' gradient leaves: in float32 for x, dt,
B and C, and in float64 for every input.  A's float32 gradient is only
checked finite: its true value carries exp(-15) factors (about 1e-5), while
the chunked form reaches it as a sum of O(1) terms that cancel (each
diagonal decay's +cum_i and -cum_i), so float32 leaves rounding noise of a
few 1e-6 there, in JAX's formulation as in the port's."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.models import ssm as jssm  # noqa: E402
from repro.models.config import ModelConfig as JaxConfig  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

TOL = 1e-4
STEP_TOL = 2e-3
GRAD_TOL = 1e-4


def _cfgs(chunk=16, groups=1):
    kw = dict(name="m", family="ssm", num_layers=1, d_model=32, vocab_size=64, ssm=True,
              ssm_state=8, ssm_expand=2, ssm_head_dim=8, ssm_groups=groups, ssm_conv_width=4,
              ssm_chunk=chunk, param_dtype="float32", compute_dtype="float32")
    return JaxConfig(**kw), ModelConfig(**kw)


def _ssd_inputs(b, l, h, p, g, n, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    xs = f(b, l, h, p)
    dt = np.logaddexp(f(b, l, h) - 1.0, 0.0).astype(np.float32)  # softplus
    a = -np.exp(f(h) * 0.3).astype(np.float32)
    return xs, dt, a, f(b, l, g, n), f(b, l, g, n)


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("l,chunk", [(32, 8), (64, 16), (128, 128), (48, 16)])
def test_ssd_chunked_matches_jax_and_recurrence(l, chunk, groups):
    jc, tc = _cfgs(chunk, groups)
    arrays = _ssd_inputs(2, l, 4, 8, groups, 8, seed=l + chunk + groups)
    y_c, s_c = ssm._ssd_chunked(*_t(arrays), tc)
    y_r, s_r = ssm.ssd_reference(*_t(arrays))
    jy_c, js_c = jssm._ssd_chunked(*(jnp.asarray(a) for a in arrays), jc)
    jy_r, js_r = jssm.ssd_reference(*(jnp.asarray(a) for a in arrays))
    assert y_c.shape == (2, l, 4, 8) and s_c.shape == (2, 4, 8, 8)
    for got, want in ((y_c, jy_c), (s_c, js_c), (y_c, y_r), (s_c, s_r), (y_r, jy_r),
                      (s_r, js_r)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL)


def test_ssd_chunk_must_divide_length():
    _, tc = _cfgs(16)
    with pytest.raises(AssertionError, match="chunk"):
        ssm._ssd_chunked(*_t(_ssd_inputs(1, 40, 4, 8, 1, 8)), tc)


def _jax_decay(cum: torch.Tensor) -> torch.Tensor:
    """The JAX package's intra-chunk decay, ``where(tri, exp(diff), 0)``."""
    q = cum.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool))
    return torch.where(tri[None, None, :, :, None], torch.exp(diff), 0.0)


def test_ssd_gradient_is_finite_where_jax_overflows(monkeypatch):
    """dt = 0.5, A = -30 at chunk 8: JAX's gradient has NaN leaves (the
    reference's fault); the port's is finite and matches the gradient
    through the recurrence; the port's forward equals, bit for bit, the one
    with JAX's decay expression, whose gradient is NaN in the port too."""
    jc, tc = _cfgs(8, 2)
    xs, _, _, bs, cs = _ssd_inputs(2, 32, 4, 8, 2, 8, seed=21)
    dt = np.full((2, 32, 4), 0.5, np.float32)
    a = np.full((4,), -30.0, np.float32)
    arrays = (xs, dt, a, bs, cs)
    rng = np.random.default_rng(22)
    gy = rng.standard_normal((2, 32, 4, 8)).astype(np.float32)
    gs = rng.standard_normal((2, 4, 8, 8)).astype(np.float32)

    def jloss(*args):
        y, s = jssm._ssd_chunked(*args, jc)
        return jnp.sum(y * gy) + jnp.sum(s * gs)

    jgrads = jax.grad(jloss, argnums=tuple(range(5)))(*(jnp.asarray(x) for x in arrays))
    assert any(np.isnan(np.asarray(g)).any() for g in jgrads), "JAX's gradient overflows"

    def port(fn, dtype=torch.float32):
        leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True) for x in arrays]
        y, s = fn(*leaves)
        loss = (y * torch.from_numpy(gy)).sum() + (s * torch.from_numpy(gs)).sum()
        return y.detach(), torch.autograd.grad(loss, leaves)

    chunked = lambda *t: ssm._ssd_chunked(*t, tc)  # noqa: E731
    y, grads = port(chunked)
    y_ref, ref = port(ssm.ssd_reference)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=TOL, atol=TOL)
    assert all(torch.isfinite(g).all() for g in grads)
    names = ("xs", "dt", "a", "bs", "cs")
    for dtype, checked in ((torch.float32, ("xs", "dt", "bs", "cs")), (torch.float64, names)):
        if dtype == torch.float64:
            (_, grads), (_, ref) = port(chunked, dtype), port(ssm.ssd_reference, dtype)
        for name, g, w in zip(names, grads, ref):
            if name in checked:
                err, scale = float((g - w).abs().max()), float(w.abs().max())
                assert err <= GRAD_TOL * scale, f"{dtype} d{name}: {err} > {GRAD_TOL} x {scale}"
    monkeypatch.setattr(ssm, "_intra_decay", _jax_decay)
    y_jax_expr, grads_jax_expr = port(lambda *t: ssm._ssd_chunked(*t, tc))
    assert torch.equal(y, y_jax_expr)
    assert any(torch.isnan(g).any() for g in grads_jax_expr)


def _block(groups=1, chunk=16, seed=0):
    """(jax cfg, port cfg, jax params, port Mamba) with the same weights."""
    jc, tc = _cfgs(chunk, groups)
    jp = jssm.mamba_init(jax.random.PRNGKey(seed), jc, dtype=jnp.float32)
    mixer = ssm.Mamba(None, tc, dtype=torch.float32, device="cpu")
    assert sorted(n for n, _ in mixer.named_parameters()) == sorted(jp)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for n, p in mixer.named_parameters():
            w = np.asarray(jp[n])
            if n in ("conv_b", "a_log", "dt_bias", "d_skip", "gate_norm"):
                # the init's constants would leave these paths untested
                w = w + 0.3 * rng.standard_normal(w.shape).astype(np.float32)
                jp[n] = jnp.asarray(w)
            p.copy_(torch.from_numpy(np.array(w)))
    return jc, tc, jp, mixer


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_forward_matches_jax(groups):
    jc, tc, jp, mixer = _block(groups)
    x = (np.random.default_rng(3).standard_normal((2, 32, 32)) * 0.3).astype(np.float32)
    want = np.asarray(jssm.mamba_forward(jp, jnp.asarray(x), jc))
    got = ssm.mamba_forward(mixer, torch.from_numpy(x), tc)
    assert got.shape == (2, 32, 32) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("groups", [1, 2])
def test_mamba_decode_matches_jax_and_forward(groups):
    """Each decode step's output and state against JAX's, on one state
    updated in place; stepping over the sequence equals the forward."""
    jc, tc, jp, mixer = _block(groups, seed=1)
    x = (np.random.default_rng(4).standard_normal((2, 32, 32)) * 0.3).astype(np.float32)
    jstate = jssm.init_mamba_state(jc, 2, dtype=jnp.float32)
    state = ssm.init_mamba_state(tc, 2, dtype=torch.float32, device="cpu")
    ring, ssm_state = state["conv"], state["ssm"]
    jstep = jax.jit(lambda p, xt, s: jssm.mamba_decode(p, xt, s, jc))
    outs = []
    for t in range(32):
        jy, jstate = jstep(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        y, state = ssm.mamba_decode(mixer, torch.from_numpy(x[:, t:t + 1]), state, tc)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=TOL, atol=TOL)
        outs.append(y)
    assert state["conv"] is ring and state["ssm"] is ssm_state  # updated in place
    for k in ("conv", "ssm"):
        assert state[k].shape == jstate[k].shape
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]), rtol=TOL, atol=TOL)
    full = ssm.mamba_forward(mixer, torch.from_numpy(x), tc)
    np.testing.assert_allclose(torch.cat(outs, dim=1).numpy(), full.numpy(), rtol=STEP_TOL,
                               atol=STEP_TOL)


def test_state_is_constant_memory():
    """The decode state's size is the JAX package's and does not grow with
    the sequence: the same state serves any length."""
    jc, tc = _cfgs()
    state = ssm.init_mamba_state(tc, 1, dtype=torch.float32, device="cpu")
    jstate = jssm.init_mamba_state(jc, 1, dtype=jnp.float32)
    n_bytes = sum(t.numel() * t.element_size() for t in state.values())
    assert n_bytes == sum(x.size * x.dtype.itemsize for x in jax.tree.leaves(jstate))
    assert n_bytes < 200_000
    assert state["ssm"].dtype == torch.float32 and state["conv"].shape == (1, 3, 64 + 16)
    big = ssm.init_mamba_state(tc, 1, dtype=torch.bfloat16, device="meta")
    assert big["ssm"].dtype == torch.float32 and big["conv"].dtype == torch.bfloat16
