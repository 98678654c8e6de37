"""Port's optimizer against the JAX package: the block-128 int8 moment codec
byte for byte, AdamW updates on the same numpy-seeded params and grads
(float32 and quantized moments), and the LR schedules.

Tolerances: the codec and the schedules do the same float32 operations in
the same order (max, one division, round half to even), so they must agree
exactly (the schedules to two float32 ulps: XLA and PyTorch each take their
own ``cos`` and fold the constants in their own order).  The AdamW update is
float32 elementwise arithmetic that XLA may fuse (and contract into FMAs)
where PyTorch rounds after each op, and its global norm sums leaves in
another order: UPDATE_TOL, relative to each leaf's scale.  A quantized
moment may then land one step of its int8 grid apart."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

UPDATE_TOL = 1e-6

SHAPES = [(), (1,), (127,), (128,), (129,), (3, 300), (2, 3, 257), (4, 128)]


def _array(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    x = np.asarray(rng.standard_normal(shape) * scale, dtype=np.float32)
    if x.ndim >= 1 and x.shape[-1] > 128:
        x[..., :128] = 0.0  # an all-zero block: scale 0
    return x


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_q8_byte_identical(shape):
    x = _array(shape, seed=len(shape) * 1000 + int(np.prod(shape)), scale=3.0)
    want = jadamw.quantize_q8(jnp.asarray(x))
    got = adamw.quantize_q8(torch.from_numpy(x))
    assert got["q"].dtype == torch.int8 and got["q"].shape == x.shape
    assert got["scale"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert got["scale"].numpy().tobytes() == np.asarray(want["scale"]).tobytes()
    back_j = np.asarray(jadamw.dequantize_q8(want, shape))
    back_t = adamw.dequantize_q8(got, shape)
    assert back_t.shape == shape and back_t.numpy().tobytes() == back_j.tobytes()


def test_quantize_rounds_half_to_even():
    # a block whose scale is exactly 1 (max |x| = 127): x / 1 lands on .5
    x = np.zeros(130, np.float32)
    x[:6] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5]
    x[128:] = [0.5, 127.0]
    got = adamw.quantize_q8(torch.from_numpy(x))
    want = jadamw.quantize_q8(jnp.asarray(x))
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    assert got["q"][:6].tolist() == [127, 0, 2, 2, 0, -2]


def _params(seed):
    rng = np.random.default_rng(seed)
    return {
        "embed": rng.standard_normal((64, 40)).astype(np.float32),
        "norm": (rng.standard_normal((40,)) * 0.1).astype(np.float32),
        "w": rng.standard_normal((3, 40, 200)).astype(np.float32),
    }


def _scale_close(got: np.ndarray, want: np.ndarray, tol: float, what: str):
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{what}: max err {err} > {tol} x scale {scale}"


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("clip", [1.0, None])
def test_adamw_updates_match_jax(quantize, clip):
    """Two updates from the initial state (the second with nonzero moments
    and count 2), with weight decay and a schedule, clip on and off."""
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.01, grad_clip=clip,
              quantize_moments=quantize)
    jopt = jadamw.adamw(jsched.warmup_cosine(3e-3, 1, 10), **kw)
    topt = adamw.adamw(schedules.warmup_cosine(3e-3, 1, 10), **kw)
    p_np = _params(0)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p_np.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(2):
        g_np = {k: v * 5 for k, v in _params(step + 1).items()}
        jp, js = jax.jit(jopt.update)({k: jnp.asarray(v) for k, v in g_np.items()}, js, jp)
        before = {k: v.clone() for k, v in tp.items()}
        tp_in, ts_in = dict(tp), {mom: dict(ts[mom]) for mom in ("m", "v")}
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g_np.items()}, ts, tp)
        for k, v in before.items():  # in place: the same tensors come back, updated
            assert tp[k] is tp_in[k] and not torch.equal(v, tp[k])
            if not quantize:
                assert all(ts[mom][k] is ts_in[mom][k] for mom in ("m", "v"))
        assert int(ts["count"]) == int(js["count"]) == step + 1
        for k in p_np:
            _scale_close(tp[k].numpy(), np.asarray(jp[k]), UPDATE_TOL, f"param {k}")
            for mom in ("m", "v"):
                if quantize:
                    got, want = ts[mom][k], js[mom][k]
                    assert got["q"].shape == want["q"].shape
                    assert np.abs(got["q"].numpy().astype(int)
                                  - np.asarray(want["q"]).astype(int)).max() <= 1
                    np.testing.assert_allclose(got["scale"].numpy(), np.asarray(want["scale"]),
                                               rtol=UPDATE_TOL * 10, atol=0)
                else:
                    _scale_close(ts[mom][k].numpy(), np.asarray(js[mom][k]), UPDATE_TOL,
                                 f"{mom} {k}")


def test_adamw_keeps_bf16_params_in_their_dtype():
    """The update of a bfloat16 param is taken in float32 and cast back
    once, as in JAX: the same bits as JAX's, moments in float32."""
    w = np.linspace(-2, 2, 300, dtype=np.float32)
    g = np.cos(w * 7)
    opt, jopt = adamw.adamw(1e-2), jadamw.adamw(1e-2)
    p = {"w": torch.from_numpy(w).bfloat16()}
    w0 = p["w"].clone()
    new, state = opt.update({"w": torch.from_numpy(g).bfloat16()}, opt.init(p), p)
    assert new["w"].dtype == torch.bfloat16 and state["m"]["w"].dtype == torch.float32
    jp = {"w": jnp.asarray(w).astype(jnp.bfloat16)}
    jnew, _ = jopt.update({"w": jnp.asarray(g).astype(jnp.bfloat16)}, jopt.init(jp), jp)
    np.testing.assert_array_equal(new["w"].float().numpy(),
                                  np.asarray(jnew["w"].astype(jnp.float32)))
    assert new["w"] is p["w"] and not torch.equal(new["w"], w0)


@pytest.mark.parametrize("peak,warmup,total", [(3e-3, 20, 100), (1e-2, 0, 10), (3e-3, 20, 8)])
def test_warmup_cosine_matches_jax(peak, warmup, total):
    steps = np.arange(0, total + 30, dtype=np.int32)
    want = np.asarray(jax.vmap(jsched.warmup_cosine(peak, warmup, total))(jnp.asarray(steps)))
    got = schedules.warmup_cosine(peak, warmup, total)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2 ** -22, atol=0)
    one = schedules.warmup_cosine(peak, warmup, total)(torch.tensor(3, dtype=torch.int32))
    assert one.shape == () and one.dtype == torch.float32


def test_constant_schedule():
    got = schedules.constant(2.5e-4)(torch.tensor(7, dtype=torch.int32))
    want = jsched.constant(2.5e-4)(jnp.asarray(7, jnp.int32))
    assert got.dtype == torch.float32 and float(got) == float(want)


@pytest.mark.gpu
def test_adamw_update_peak_bytes_per_parameter():
    """In place, an update of bfloat16 weights with float32 moments holds the
    weights, the bfloat16 gradients and both moments (12 bytes a parameter)
    plus one leaf's float32 temporaries, not a second copy of the moments
    and weights (22 bytes a parameter out of place)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    shapes = [(4096, 2048)] * 8 + [(2048,)] * 4
    params = {f"w{i}": torch.randn(s, generator=gen, device=dev).bfloat16()
              for i, s in enumerate(shapes)}
    grads = {n: torch.randn(p.shape, generator=gen, device=dev).bfloat16()
             for n, p in params.items()}
    opt = adamw.adamw(1e-3, weight_decay=0.01)
    state = opt.init(params)
    n = sum(p.numel() for p in params.values())
    largest = max(p.numel() for p in params.values())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    assert base >= 12 * n
    torch.cuda.reset_peak_memory_stats()
    out, new_state = opt.update(grads, state, params)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert out is params and new_state is state
    # each float32 temporary of the largest leaf is 4 bytes an entry; a few
    # of them live at once
    assert extra <= 6 * 4 * largest, (extra, largest)
    assert torch.cuda.memory_allocated() - base <= 4096
