"""The flash attention's gradient (``ops.FlashAttention``): the einsum
path's gradient ``ref.attention_bwd_ref`` against autograd through the plain
forward and against JAX's ``vjp`` of its attention oracle (the gradient the
port's training holds its flash path to); the ``Function``'s backward (on
the CPU ``ref.attention_bwd_lse_ref`` from the saved output and
log-sum-exp) against a float64 ``gradcheck`` and against that gradient.  On
the card (``gpu``-marked) the forward and the backward are kernels.

Tolerances: float32 gradients differ from autograd's and JAX's in summation
order only: F32_TOL of each gradient's largest entry.  On the card with
bfloat16 inputs the gradients come back in bfloat16 (one rounding of each):
BF16_TOL of each gradient's largest entry."""

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

F32_TOL, BF16_TOL = 1e-5, 2e-2


def _rand(b, s, h, kv, d, seed, dtype=torch.float32, device="cpu"):
    rng = np.random.default_rng(seed)
    shapes = [(b, s, h, d), (b, s, kv, d), (b, s, kv, d), (b, s, h, d)]
    return [torch.from_numpy(rng.standard_normal(sh).astype(np.float32)).to(device, dtype)
            for sh in shapes]


def _close(got, want, tol, what):
    scale = float(want.abs().max())
    err = float((got.float() - want.float()).abs().max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x scale {scale}"


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,s,h,kv,d", [(1, 5, 4, 2, 3), (2, 4, 2, 1, 2), (1, 6, 3, 3, 4)])
def test_flash_function_gradcheck_float64(b, s, h, kv, d, causal):
    q, k, v, _ = (x.double().requires_grad_(True) for x in _rand(b, s, h, kv, d, seed=s * h))
    assert torch.autograd.gradcheck(lambda q, k, v: ops.FlashAttention.apply(q, k, v, causal),
                                    (q, k, v), eps=1e-6, atol=1e-8, rtol=1e-6)


@pytest.mark.parametrize("b,s,h,kv,d", [(2, 37, 8, 2, 16), (1, 64, 4, 1, 64), (1, 33, 2, 2, 32)])
def test_flash_backward_matches_autograd_and_jax(b, s, h, kv, d):
    q, k, v, do = _rand(b, s, h, kv, d, seed=b * s + d)
    got = attention_bwd_ref(q, k, v, do)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*leaves), leaves, do)
    want_jax = jax.jit(lambda q, k, v, do: jax.vjp(jref, q, k, v)[1](do))(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, do)))
    for name, g, w, wj in zip("qkv", got, want, want_jax):
        assert g.shape == w.shape and g.dtype == torch.float32
        _close(g, w, F32_TOL, f"d{name} vs autograd")
        _close(g, torch.from_numpy(np.array(wj)), F32_TOL, f"d{name} vs jax.vjp")
    # through the wrapper on the CPU: the plain forward with its log-sum-exp,
    # then the plain version of the backward kernels' contract on them
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = ops.flash_attention(*leaves)
    lse_form = attention_bwd_lse_ref(q, k, v, attention_lse_ref(q, k, v)[1], do)
    for g, w, e in zip(torch.autograd.grad(out, leaves, do), got, lse_form):
        assert torch.equal(g, e)
        _close(g, w, F32_TOL, "the Function's backward vs the einsum gradient")


def test_flash_grad_in_bf16_on_cpu():
    q, k, v, do = _rand(1, 40, 4, 1, 64, seed=3, dtype=torch.bfloat16)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    grads = torch.autograd.grad(ops.flash_attention(*leaves), leaves, do)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float())
    for g, w in zip(grads, want):
        assert g.dtype == torch.bfloat16
        _close(g, w, BF16_TOL, "bf16 grad")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the forward launches the flash kernel")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,dtype", [
    (1, 300, 8, 1, 256, torch.bfloat16),   # gemma-2b's heads (MQA, D=256), ragged S
    (2, 129, 8, 2, 128, torch.bfloat16),   # GQA across a tile edge
    (2, 100, 8, 2, 64, torch.float32),     # the CUDA-core route
])
def test_flash_function_on_card(cuda_device, b, s, h, kv, d, dtype):
    """The forward launches its kernel and the backward its backward kernel,
    each counted once, both on the route ``ops.route`` names; dq, dk, dv
    agree with autograd through the plain forward on the same card."""
    q, k, v, do = _rand(b, s, h, kv, d, seed=s, dtype=dtype, device=cuda_device)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    counters = (ops.counter, ops.tc_counter, ops.bwd_counter, ops.bwd_tc_counter)
    before = [c.launches for c in counters]
    out = ops.flash_attention(*leaves)
    on_tc = ops.route(dtype, d) == "wgmma"
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + on_tc, *before[2:]]
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [before[0] + 1, before[1] + on_tc,
                                              before[2] + 1, before[3] + on_tc]
    ref_leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    want = torch.autograd.grad(attention_ref(*ref_leaves), ref_leaves, do.float())
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    for name, g, w in zip("qkv", grads, want):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w, tol, f"d{name}")
