"""Port's flash_attention against the JAX package: the Pallas kernel (in
interpret mode) and its pure-jnp oracle, on the shapes of the JAX package's
own flash tests, from numpy-seeded inputs.  On the CPU the port's wrapper
runs its plain version; the kernel itself is held against that plain
version on the card (``gpu``-marked)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_attn import ops as jops  # noqa: E402
from repro.kernels.flash_attn.ref import attention_ref as jref  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.flash_attn import ops as tops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_ref  # noqa: E402

# float32: both compute float32 scores and sums and differ in summation order
# only; bfloat16: both round a float32 result once (the JAX tests' tolerances),
# and the tensor-core route also rounds P to bfloat16 before P.V, as the TPU
# kernel's DEFAULT-precision dot does on its chip
F32_TOL, BF16_TOL = 1e-5, 2e-2


def _rand(b, s, h, kv, d, seed=0, t=None):
    rng = np.random.default_rng(seed)
    t = s if t is None else t
    return (rng.standard_normal((b, s, h, d), np.float32),
            rng.standard_normal((b, t, kv, d), np.float32),
            rng.standard_normal((b, t, kv, d), np.float32))


def _jax(arrays, dtype=jnp.float32, **kw):
    q, k, v = (jnp.asarray(a).astype(dtype) for a in arrays)
    return (np.asarray(jops.flash_attention(q, k, v, block_q=64, block_k=64, **kw)
                       .astype(jnp.float32)),
            np.asarray(jref(q, k, v, **kw)))


def _port(arrays, dtype=torch.float32, **kw):
    return tops.flash_attention(*(torch.from_numpy(a).to(dtype) for a in arrays), **kw)


@pytest.mark.parametrize(
    "b,s,h,kv,d",
    [
        (2, 128, 4, 2, 64),    # GQA
        (1, 128, 4, 1, 64),    # MQA
        (2, 64, 8, 8, 128),    # MHA, lane-width head
        (1, 64, 2, 1, 256),    # gemma-style 256 head_dim
        (1, 100, 4, 2, 64),    # unaligned S: JAX pads, the port masks
        (1, 40, 4, 2, 16),     # the reduced configs' head_dim
        (1, 64, 4, 4, 112),    # zamba2's shared attention head_dim
        (1, 100, 4, 2, 112),   # the same, unaligned S, GQA
    ],
)
def test_flash_matches_jax_kernel_and_oracle(b, s, h, kv, d):
    arrays = _rand(b, s, h, kv, d, seed=b * s + d)
    got = _port(arrays)
    assert got.dtype == torch.float32 and got.shape == (b, s, h, d)
    want_kernel, want_ref = _jax(arrays)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=F32_TOL, atol=F32_TOL)
    mine = attention_ref(*(torch.from_numpy(a) for a in arrays))
    np.testing.assert_allclose(mine.numpy(), want_ref, rtol=F32_TOL, atol=F32_TOL)


def test_flash_bf16_inputs():
    arrays = _rand(1, 64, 4, 2, 64, seed=5)
    got = _port(arrays, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want_kernel, want_ref = _jax(arrays, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want_kernel, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), want_ref, rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_bf16_head_dim_112():
    """zamba2's head dim in bf16 (the CUDA-core route on the card, exact
    float32 inside) against the JAX kernel in interpret mode."""
    arrays = _rand(2, 96, 4, 4, 112, seed=15)
    got = _port(arrays, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 96, 4, 112)
    want_kernel, want_ref = _jax(arrays, jnp.bfloat16)
    np.testing.assert_allclose(got.float().numpy(), want_kernel, rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), want_ref, rtol=BF16_TOL, atol=BF16_TOL)


def test_flash_causality():
    """Changing a future key/value must not change past outputs."""
    q, k, v = _rand(1, 64, 2, 1, 32, seed=6)
    out1 = _port((q, k, v))
    k2, v2 = k.copy(), v.copy()
    k2[:, 40:] = 99.0
    v2[:, 40:] = -99.0
    out2 = _port((q, k2, v2))
    np.testing.assert_allclose(out1[:, :40].numpy(), out2[:, :40].numpy(), rtol=1e-6)
    assert not np.allclose(out1[:, 41:].numpy(), out2[:, 41:].numpy())


def test_flash_non_causal_where_jax_takes_it():
    arrays = _rand(1, 64, 4, 2, 32, seed=7)
    got = _port(arrays, causal=False)
    want_kernel, want_ref = _jax(arrays, causal=False)
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=F32_TOL, atol=F32_TOL)
    ragged = _rand(1, 60, 4, 2, 32, seed=8, t=60)
    with pytest.raises(NotImplementedError):
        jops.flash_attention(*(jnp.asarray(a) for a in ragged), causal=False)
    with pytest.raises(NotImplementedError):
        _port(ragged, causal=False)


@pytest.mark.parametrize("b,s,t,h,kv,d", [
    (1, 4096, 4096, 32, 8, 128), (1, 8192, 8192, 32, 8, 128), (4, 2048, 2048, 40, 10, 128),
    (2, 100, 300, 8, 1, 256), (1, 64, 64, 4, 4, 16),
])
def test_flash_bytes_equal(b, s, t, h, kv, d):
    for kw in ({}, {"dtype_bytes": 4}, {"block_k": 64}):
        assert tops.flash_bytes(b, s, t, h, kv, d, **kw) == jops.flash_bytes(b, s, t, h, kv, d, **kw)


def test_flash_rejects_what_the_kernel_does_not_take():
    q, k, v = (torch.from_numpy(a) for a in _rand(1, 16, 4, 2, 64))
    with pytest.raises(ValueError, match="head dim"):
        tops.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                             v[..., :48].contiguous())
    with pytest.raises(TypeError):
        tops.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):
        tops.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(ValueError, match="pair"):
        tops.flash_attention(q[:, :, :3].contiguous(), k, v)
    with pytest.raises(ValueError, match="contiguous"):
        tops.flash_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v)
    with pytest.raises(ValueError):
        tops.flash_attention(q, k, v[:, :8])


def test_flash_cpu_counts_no_launch():
    before = tops.counter.launches, tops.tc_counter.launches
    _port(_rand(1, 32, 4, 2, 64))
    _port(_rand(1, 32, 4, 2, 128), torch.bfloat16)
    assert (tops.counter.launches, tops.tc_counter.launches) == before


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 256, "wgmma"),
    (torch.bfloat16, 16, "cuda_cores"), (torch.bfloat16, 32, "cuda_cores"),
    (torch.bfloat16, 112, "wgmma"), (torch.float32, 112, "cuda_cores"),
    (torch.float32, 16, "cuda_cores"), (torch.float32, 32, "cuda_cores"),
    (torch.float32, 64, "cuda_cores"), (torch.float32, 128, "cuda_cores"),
    (torch.float32, 256, "cuda_cores"),
])
def test_flash_route_choice(dtype, d, want):
    """bf16 at D 64/112/128/256 takes the tensor cores; float32, and bf16 at
    D 16/32, the exact CUDA-core kernel, forward and backward alike.  Both
    routes' C entries take the same arguments, but for the backward's
    scratch: the tensor-core route takes float32 dQ sums, the GQA group
    sums, turn counters and wait cycles where the CUDA-core route takes
    per-head partials."""
    assert tops.route(dtype, d) == want
    assert tops.ENTRIES == {"wgmma": "flash_attn_fwd_tc", "cuda_cores": "flash_attn_fwd"}
    assert tops.BWD_ENTRIES == {"wgmma": "flash_attn_bwd_tc", "cuda_cores": "flash_attn_bwd"}
    assert (native._SIGNATURES["flash_attn_fwd_tc"] == native._SIGNATURES["flash_attn_fwd"])
    tc, cc = native._SIGNATURES["flash_attn_bwd_tc"], native._SIGNATURES["flash_attn_bwd"]
    # q, k, v, lse, dO, dq, dk, dv, stats; then B ... causal, strides, stream
    assert tc[:9] == cc[:9] and tc[-15:] == cc[-15:]


def _attention_bf16_p(q, k, v):
    """Plain causal GQA attention with the tensor-core route's one extra
    rounding: float32 scores and softmax, P rounded to bfloat16 before P.V,
    normalised by the sum of the unrounded P."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / d ** 0.5
    mask = torch.arange(t)[None, :] <= torch.arange(s)[:, None]
    scores = scores.masked_fill(~mask, -1e30)
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = torch.einsum("bkgst,btkd->bskgd", p.bfloat16().float(), v.float())
    out = out / p.sum(-1).permute(0, 3, 1, 2)[..., None]
    return out.reshape(b, s, h, d)


def test_flash_bf16_p_fits_the_tolerance():
    """The tensor-core route's arithmetic (P in bfloat16) on bf16 inputs is
    within BF16_TOL of the JAX package's Pallas kernel in interpret mode."""
    arrays = _rand(1, 257, 8, 2, 128, seed=14)
    q, k, v = (torch.from_numpy(a).bfloat16() for a in arrays)
    got = _attention_bf16_p(q, k, v).bfloat16().float().numpy()
    want_kernel, _ = _jax(arrays, jnp.bfloat16)
    np.testing.assert_allclose(got, want_kernel, rtol=BF16_TOL, atol=BF16_TOL)
    exact = attention_ref(q, k, v).bfloat16().float().numpy()
    assert 0 < np.abs(got - exact).max() < BF16_TOL  # the rounding shows, and stays inside


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,h,kv,d,dtype", [
    (2, 100, 8, 2, 64, torch.float32),
    (1, 300, 4, 1, 256, torch.bfloat16),
    (2, 257, 8, 8, 128, torch.bfloat16),
    (1, 70, 4, 2, 16, torch.float32),
    (1, 129, 4, 4, 32, torch.bfloat16),
    # the tensor-core route: GQA 4:1 at D=128 across tile edges, D=64, MQA D=256
    (1, 1, 8, 2, 128, torch.bfloat16),
    (1, 127, 8, 2, 128, torch.bfloat16),
    (1, 129, 8, 2, 128, torch.bfloat16),
    (1, 2048, 8, 2, 128, torch.bfloat16),
    (1, 300, 8, 2, 64, torch.bfloat16),
    (1, 1000, 4, 1, 256, torch.bfloat16),
    # zamba2's D=112: bf16 on the tensor cores (padded to 128 by TMA's zero
    # fill), ragged S; float32 on the CUDA cores (7 columns a thread), GQA
    (2, 1000, 4, 4, 112, torch.bfloat16),
    (1, 129, 8, 2, 112, torch.float32),
])
def test_flash_kernel_matches_plain_on_card(cuda_device, b, s, h, kv, d, dtype):
    arrays = [torch.from_numpy(a).to(cuda_device, dtype) for a in _rand(b, s, h, kv, d, seed=s)]
    before = tops.counter.launches, tops.tc_counter.launches
    got = tops.flash_attention(*arrays)
    torch.cuda.synchronize()
    on_tc = tops.route(dtype, d) == "wgmma"
    assert (tops.counter.launches, tops.tc_counter.launches) == (before[0] + 1, before[1] + on_tc)
    assert got.dtype == dtype
    want = attention_ref(*arrays).to(dtype)
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
