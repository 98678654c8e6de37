"""The flash backward's contract, held against JAX.  ``attention_lse_ref``
(the forward's output and log-sum-exp) against ``jax.nn.logsumexp`` of the
scores as the JAX package's ``attention_ref`` builds them;
``attention_bwd_lse_ref`` (what the backward kernels compute: P rebuilt
from the log-sum-exp, delta = rowsum(P * dP)) against ``attention_bwd_ref`` (the
einsum path's gradient) and against ``jax.vjp`` of JAX's ``attention_ref``.
On the card (``gpu``-marked) the backward kernels of both routes against
that plain version: their gradients, their bits across five calls, their
launch counts and routes; shapes that stress the tensor-core route's
ordered dQ adds (gemma-2b's full shape, GQA 8 at D=256, a non-causal T != S
over more than one wave of work items).  On the CPU, the tensor-core
route's scratch sizes (``ops.bwd_workspace``) against their formula and
against the scratch the three-pass design took (stats and per-head
partials).

Tolerances: float32 differs from autograd's and JAX's gradients in
summation order only: F32_TOL of each gradient's largest entry, and LSE_TOL
on the log-sum-exp itself.  bfloat16 inputs: the gradients come back in
bfloat16 (one rounding each; on the tensor cores P and dS are also rounded
to bfloat16 as wgmma operands): BF16_TOL of each gradient's largest
entry."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attn.ref import attention_ref as jref  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    attention_bwd_lse_ref,
    attention_bwd_ref,
    attention_lse_ref,
    attention_ref,
)

F32_TOL, BF16_TOL, LSE_TOL = 1e-5, 2e-2, 1e-5

# (b, s, t, h, kv, d): GQA groups 1, 4 and 8, D 16/64/112/256, ragged S and T
SHAPES = [
    (2, 37, 37, 8, 2, 16),
    (1, 45, 45, 8, 1, 64),
    (1, 33, 40, 4, 4, 112),
    (1, 29, 29, 8, 2, 112),
    (2, 24, 30, 8, 1, 256),
    (1, 50, 50, 4, 1, 16),
]


def _rand(b, s, t, h, kv, d, seed):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, t, kv, d), (b, t, kv, d), (b, s, h, d)]
    return [rng.standard_normal(sh).astype(np.float32) for sh in shapes]


def _close(got, want, tol, what):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x scale {scale}"


def _jax_lse(q, k, causal):
    """The log-sum-exp of the scores JAX's ``attention_ref`` softmaxes,
    built as it builds them, as (B, H, S)."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, d).astype(jnp.float32)
    scores = jnp.einsum("bskgd,btkd->bkgst", qg, k.astype(jnp.float32))
    scores = scores / jnp.sqrt(jnp.float32(d))
    if causal:
        mask = jnp.arange(t)[None, :] <= jnp.arange(s)[:, None]
        scores = jnp.where(mask[None, None, None], scores, -1e30)
    return jax.nn.logsumexp(scores, axis=-1).reshape(b, h, s)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,kv,d", SHAPES)
def test_lse_ref_matches_jax_logsumexp(b, s, t, h, kv, d, causal):
    q, k, v, _ = _rand(b, s, t, h, kv, d, seed=s + d)
    out, lse = attention_lse_ref(*(torch.from_numpy(x) for x in (q, k, v)), causal=causal)
    want = np.asarray(jax.jit(_jax_lse, static_argnums=2)(q, k, causal))
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=LSE_TOL, atol=LSE_TOL)
    want_out = np.asarray(jax.jit(lambda *a: jref(*a, causal=causal))(q, k, v))
    np.testing.assert_allclose(out.numpy(), want_out, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,t,h,kv,d", SHAPES)
def test_bwd_lse_ref_matches_einsum_gradient_and_jax(b, s, t, h, kv, d, causal):
    arrays = _rand(b, s, t, h, kv, d, seed=b * s + d + t)
    q, k, v, do = (torch.from_numpy(x) for x in arrays)
    out, lse = attention_lse_ref(q, k, v, causal=causal)
    got = attention_bwd_lse_ref(q, k, v, lse, do, causal=causal)
    einsum = attention_bwd_ref(q, k, v, do, causal=causal)
    want_jax = jax.jit(lambda q, k, v, do: jax.vjp(
        lambda q, k, v: jref(q, k, v, causal=causal), q, k, v)[1](do))(*arrays)
    for name, g, w, wj in zip("qkv", got, einsum, want_jax):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, F32_TOL, f"d{name} vs attention_bwd_ref")
        _close(g, torch.from_numpy(np.asarray(wj)), F32_TOL, f"d{name} vs jax.vjp")
    # bf16 inputs: each gradient rounded once
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    _, lse_b = attention_lse_ref(qb, kb, vb, causal=causal)
    got_b = attention_bwd_lse_ref(qb, kb, vb, lse_b, dob, causal=causal)
    want_b = attention_bwd_ref(*(x.float() for x in (qb, kb, vb, dob)), causal=causal)
    for name, g, w in zip("qkv", got_b, want_b):
        assert g.dtype == torch.bfloat16
        _close(g, w, BF16_TOL, f"bf16 d{name}")


@pytest.mark.parametrize("b,s,t,h,kv,d", [(1, 5, 7, 4, 1, 3), (2, 6, 6, 4, 2, 4)])
def test_cpu_backward_is_the_lse_form_and_passes_gradcheck(b, s, t, h, kv, d, monkeypatch):
    """The CPU ``FlashAttention`` backward runs ``attention_bwd_lse_ref`` on
    the saved output and log-sum-exp, once a call, and passes a float64
    ``gradcheck`` with T != S and GQA."""
    calls = []
    real = ops.attention_bwd_lse_ref
    monkeypatch.setattr(ops, "attention_bwd_lse_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    q, k, v, _ = (torch.from_numpy(x).double().requires_grad_(True)
                  for x in _rand(b, s, t, h, kv, d, seed=7))
    assert torch.autograd.gradcheck(lambda q, k, v: ops.FlashAttention.apply(q, k, v, True),
                                    (q, k, v), eps=1e-6, atol=1e-8, rtol=1e-6)
    assert calls
    # no gradient wanted (no_grad, or inputs that need none): no log-sum-exp
    lse_calls = []
    real_lse = ops.attention_lse_ref
    monkeypatch.setattr(ops, "attention_lse_ref",
                        lambda *a, **kw: lse_calls.append(1) or real_lse(*a, **kw))
    x = [torch.from_numpy(a) for a in _rand(1, 9, 9, 4, 2, 16, seed=1)][:3]
    with torch.no_grad():
        ops.flash_attention(*(a.clone().requires_grad_(True) for a in x))
    ops.flash_attention(*x)
    assert lse_calls == []
    ops.flash_attention(*(a.clone().requires_grad_(True) for a in x))
    assert lse_calls == [1]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the backward kernels run only there")
    return torch.device("cuda")


CARD_SHAPES = [
    # the tensor-core route: D 64/112/128/256, ragged, GQA 1/4/8
    (2, 300, 300, 8, 2, 64, torch.bfloat16),
    (2, 1000, 1000, 32, 32, 112, torch.bfloat16),
    (1, 129, 129, 8, 2, 112, torch.bfloat16),
    (1, 257, 257, 8, 2, 128, torch.bfloat16),
    (1, 300, 300, 8, 1, 256, torch.bfloat16),
    (2, 100, 130, 8, 8, 128, torch.bfloat16),
    # the ordered dQ adds: gemma-2b's training shape (1,024 work items, a
    # query tile's dQ summed over up to 32 key tiles), GQA 8 at D=256, ragged
    (4, 2048, 2048, 8, 1, 256, torch.bfloat16),
    (2, 700, 700, 8, 1, 256, torch.bfloat16),
    # the CUDA-core route: float32, bf16 at D 16
    (2, 100, 100, 8, 2, 64, torch.float32),
    (1, 70, 70, 4, 2, 16, torch.float32),
    (2, 64, 64, 4, 1, 16, torch.bfloat16),
]


# non-causal, T != S: every query tile's dQ summed over all 8 key tiles, 256
# work items (two waves on 132 SMs), ragged S and T
NON_CAUSAL_CARD_SHAPES = [
    (2, 700, 1000, 16, 4, 128, torch.bfloat16),
]


# backward calls a card check makes, every one bit-equal to the first
CALLS = 5


def _check_on_card(device, b, s, t, h, kv, d, dtype, causal):
    """One forward and ``CALLS`` backward launches on the route
    ``ops.route`` names; the forward's log-sum-exp against the plain one;
    dq, dk, dv against the plain version of the contract on the kernel's own
    output and log-sum-exp, and against autograd through the plain forward;
    every backward call bit-equal to the first."""
    q, k, v, do = (torch.from_numpy(x).to(device, dtype)
                   for x in _rand(b, s, t, h, kv, d, seed=s + t))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    before = [c.launches for c in (ops.counter, ops.tc_counter, ops.bwd_counter,
                                   ops.bwd_tc_counter)]
    out, lse = ops._forward(q, k, v, causal, True)
    grads = ops._backward(q, k, v, lse, do, causal)
    again = [ops._backward(q, k, v, lse, do, causal) for _ in range(CALLS - 1)]
    torch.cuda.synchronize()
    on_tc = ops.route(dtype, d) == "wgmma"
    assert [c.launches for c in (ops.counter, ops.tc_counter, ops.bwd_counter,
                                 ops.bwd_tc_counter)] == [
        before[0] + 1, before[1] + on_tc, before[2] + CALLS, before[3] + CALLS * on_tc]
    _, want_lse = attention_lse_ref(q, k, v, causal=causal)
    torch.testing.assert_close(lse, want_lse, rtol=1e-4, atol=1e-4)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    plain = attention_bwd_lse_ref(q, k, v, lse, do, causal=causal)
    truth = torch.autograd.grad(attention_ref(*leaves, causal=causal), leaves, do.float())
    for i, (name, g, p, w) in enumerate(zip("qkv", grads, plain, truth)):
        assert g.dtype == dtype and g.shape == w.shape
        for call, g2 in enumerate(again, 2):
            assert torch.equal(g, g2[i]), f"d{name} of call {call} differs from call 1"
        _close(g, p, tol, f"d{name} vs the plain contract")
        _close(g, w, tol, f"d{name} vs autograd through the plain forward")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,kv,d,dtype", CARD_SHAPES)
def test_backward_kernel_matches_plain_on_card(cuda_device, b, s, t, h, kv, d, dtype):
    """Causal: ``_check_on_card``."""
    _check_on_card(cuda_device, b, s, t, h, kv, d, dtype, True)


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,t,h,kv,d,dtype", NON_CAUSAL_CARD_SHAPES)
def test_backward_kernel_matches_plain_on_card_non_causal(cuda_device, b, s, t, h, kv, d,
                                                          dtype):
    """Non-causal: ``_check_on_card``."""
    _check_on_card(cuda_device, b, s, t, h, kv, d, dtype, False)


@pytest.mark.gpu
def test_backward_never_runs_the_plain_version_on_card(cuda_device, monkeypatch):
    """On a CUDA tensor ``FlashAttention`` launches kernels only: neither
    plain version is called, forward or backward."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card")

    for name in ("attention_ref", "attention_lse_ref", "attention_bwd_lse_ref"):
        monkeypatch.setattr(ops, name, refuse)
    q, k, v, do = (torch.from_numpy(x).to(cuda_device, torch.bfloat16)
                   for x in _rand(1, 200, 200, 8, 1, 256, seed=3))
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(ops.flash_attention(*leaves), leaves, do)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g.float()).all()) for g in grads)


# (b, s, t, h, kv, d) of the four training shapes: three GQA, one MHA
WORKSPACE_SHAPES = {
    "gemma-2b": (4, 2048, 2048, 8, 1, 256),
    "phi3-medium-14b": (4, 2048, 2048, 40, 10, 128),
    "pixtral-12b": (4, 3072, 3072, 32, 8, 128),
    "zamba2-7b shared block": (4, 2048, 2048, 32, 32, 112),
}


@pytest.mark.parametrize("name", list(WORKSPACE_SHAPES))
def test_bwd_workspace_matches_its_formula_and_the_old_scratch(name):
    """``bwd_workspace`` at each training shape: its formula, and (GQA) no
    more bytes than the three-pass design's (B*H, S_pad, 2) stats and (2, B,
    T, H, D) per-head partials; at the MHA shape, which had no partials, the
    dQ sums are new memory."""
    b, s, t, h, kv, d = WORKSPACE_SHAPES[name]
    up = lambda x, m: -(-x // m) * m  # noqa: E731
    keys = 64 if d == 256 else 128  # a work item's keys
    m, n = up(s, 64) // 64, up(t, keys) // keys
    stats = b * h * up(s, 128) * 2 * 4
    partials = 2 * b * t * h * d * 4 if h != kv else 0
    ws = ops.bwd_workspace(b, s, t, h, kv, d)
    assert ws == {"stats": stats, "dq_acc": b * h * m * 64 * d * 4,
                  "dkv": 2 * b * kv * up(t, 64) * d * 4 if h != kv else 0,
                  "counters": 4 * (1 + 2 * b * h * m + 2 * b * kv * n)}
    # in the one buffer, each array starts 16-byte aligned
    assert all(x % 16 == 0 for x in list(ws.values())[:-1])
    if h != kv:
        assert sum(ws.values()) <= stats + partials, (ws, stats + partials)
    else:
        assert ws["dkv"] == 0 and ws["dq_acc"] == b * h * s * d * 4
