"""Port's encoder/decoder (``models/encdec.py``, whisper) against the JAX
package on the reduced whisper-tiny config: the JAX weights (``init_params``
from a PRNG key) carried over with ``convert.lm_params_from_numpy``, both
packages fed the same numpy-seeded frames and tokens.

Tolerances: in float32 both packages do the same arithmetic and differ in
summation order only, so outputs, logits and caches agree to TOL (1e-4) and
each gradient leaf to GRAD_TOL of that leaf's largest entry.  In bfloat16
the frameworks round intermediates at different places (XLA once per fused
chain, PyTorch after each op), so the logits agree to BF16_TOL, absolute on
logits of a few units (a bfloat16 step there is 2**-6 to 2**-5)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import encdec as jencdec  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    _port_named,
    kv_cache_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.models import api, encdec  # noqa: E402

TOL = 1e-4
GRAD_TOL = 1e-4
BF16_TOL = 0.1
ARCH = "whisper-tiny"
MAX_POS = 12  # pos_dec rows: the decode test steps one past them
_jax_init = jax.jit(japi.init_params, static_argnames=("cfg", "max_decode_len"))


def _configs(dtype="float32"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype)
    return (dataclasses.replace(jax_config(ARCH, reduced=True), **kw),
            dataclasses.replace(get_config(ARCH, reduced=True), **kw))


_MODELS: dict = {}


def _models(dtype="float32"):
    """(jax cfg, port cfg, jax params, port EncDec) with the same weights."""
    jc, tc = _configs(dtype)
    if dtype not in _MODELS:
        jp = _jax_init(jax.random.PRNGKey(5), cfg=jc, max_decode_len=MAX_POS)
        _MODELS[dtype] = (jp, lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp),
                                                   device="cpu"))
    return (jc, tc, *_MODELS[dtype])


def _inputs(cfg, b, s, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    return frames, tokens


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_params_round_trip():
    """The JAX tree (``enc`` and ``dec`` stacked layer-leading) converts into
    an ``EncDec`` whose parameter names are the tree's paths, and back."""
    jc, tc, jp, model = _models()
    assert isinstance(model, encdec.EncDec) and model.pos_dec.shape == (MAX_POS, tc.d_model)
    tree = jax.tree.map(np.asarray, jp)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    names = {n for n, _ in model.named_parameters()}
    assert {"embed", "pos_dec", "enc.0.attn.wq", "enc.1.mlp.w_down", "enc_ln.g",
            "dec.0.self_attn.wk", "dec.1.cross_attn.wo", "dec.0.ln3.b", "dec_ln.b"} <= names
    assert len(names) == len(_port_named(tree))


def test_sinusoid_matches_jax():
    """The same expression; XLA's and PyTorch's float32 ``exp`` may part by
    one ulp, which moves the angle of position p by up to p·2^-23: at
    whisper's 1,500 frames, 1.8e-4."""
    for length, d in ((7, 64), (1500, 384), (3, 2)):
        np.testing.assert_allclose(encdec._sinusoid(length, d, "cpu").numpy(),
                                   np.asarray(jencdec._sinusoid(length, d)), rtol=0,
                                   atol=max(TOL, length * 2.0**-23))


def test_encode_matches_jax():
    jc, tc, jp, model = _models()
    frames, _ = _inputs(jc, 2, 1, seed=1)
    want = np.asarray(japi.encode_memory(jp, jnp.asarray(frames), jc))
    got = api.encode_memory(model, torch.from_numpy(frames), tc)
    assert got.shape == (2, tc.encoder_seq, tc.d_model) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_forward_logits_match_jax():
    jc, tc, jp, model = _models()
    frames, tokens = _inputs(jc, 2, 10, seed=2)
    want = np.asarray(japi.forward_logits(jp, {"tokens": tokens, "frames": frames}, jc))
    got = api.forward_logits(model, {"tokens": tokens, "frames": frames}, tc)
    assert got.shape == (2, 10, tc.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_train_loss_and_grads_match_jax(monkeypatch):
    """The loss and every gradient leaf (encoder, decoder, tied embedding,
    ``pos_dec``) against ``jax.grad``; each encoder and decoder layer is
    recomputed in the backward, as ``jax.checkpoint`` wraps JAX's scans."""
    jc, tc, jp, _ = _models()
    frames, tokens = _inputs(jc, 2, 10, seed=3)
    batch = {"tokens": jnp.asarray(tokens), "frames": jnp.asarray(frames)}
    (loss, metrics), g = jax.jit(jax.value_and_grad(
        lambda p: japi.train_loss(p, batch, jc), has_aux=True))(jp)
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    model.requires_grad_(True)
    calls = []
    for name in ("_enc_layer", "_dec_layer"):
        real = getattr(encdec, name)
        monkeypatch.setattr(encdec, name,
                            lambda *a, real=real, name=name: calls.append(name) or real(*a))
    named = dict(model.named_parameters())
    tloss, tmetrics = api.train_loss(model, {"tokens": tokens, "frames": frames}, tc)
    assert len(calls) == tc.encoder_layers + tc.num_layers
    grads = dict(zip(named, torch.autograd.grad(tloss, list(named.values()))))
    assert len(calls) == 2 * (tc.encoder_layers + tc.num_layers)
    assert set(tmetrics) == set(metrics) == {"lm_loss", "total_loss"}
    assert abs(float(tloss.detach()) - float(loss)) <= 1e-5 * abs(float(loss))
    want = _port_named(jax.tree.map(np.asarray, g))
    assert set(want) == set(grads)
    for name, gt in grads.items():
        w = want[name]
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(gt.numpy() - w).max()) <= GRAD_TOL * scale, name


def test_decode_and_caches_match_jax_past_the_end():
    """The encoder memory attached (cross K/V per layer), then decode steps
    to one past ``MAX_POS`` (the cache's length too): logits each step and
    all four caches after; past the end both clamp, ``pos_dec`` to its last
    row and the self K/V write to the last slot."""
    jc, tc, jp, model = _models()
    frames, tokens = _inputs(jc, 2, MAX_POS + 1, seed=4)
    jcache = japi.init_cache(jc, 2, MAX_POS)
    jcache = japi.attach_memory(jcache, japi.encode_memory(jp, jnp.asarray(frames), jc), jp, jc)
    tcache = api.init_cache(tc, 2, MAX_POS, device="cpu")
    tcache = api.attach_memory(tcache, api.encode_memory(model, frames, tc), model, tc)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    for key in ("mem_k", "mem_v"):
        assert mine[key].shape == theirs[key].shape == (
            tc.num_layers, 2, tc.encoder_seq, tc.num_heads, tc.head_dim)
        np.testing.assert_allclose(mine[key], theirs[key], rtol=TOL, atol=TOL)
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jc))
    for i in range(MAX_POS + 1):
        jl, jcache = jstep(jp, jcache, jnp.asarray(tokens[:, i:i + 1]))
        tl, tcache = api.decode_step(model, tcache, torch.from_numpy(tokens[:, i:i + 1]), tc)
        assert tl.shape == (2, 1, tc.vocab_size)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    assert int(mine["t"]) == int(theirs["t"]) == MAX_POS + 1 and mine["t"].dtype == np.int32
    for key in ("self_k", "self_v", "mem_k", "mem_v"):
        assert mine[key].shape == theirs[key].shape
        np.testing.assert_allclose(mine[key], theirs[key], rtol=TOL, atol=TOL)


def test_stepped_decode_matches_the_full_forward():
    jc, tc, jp, model = _models()
    frames, tokens = _inputs(jc, 2, 8, seed=6)
    full = api.forward_logits(model, {"tokens": tokens, "frames": frames}, tc)
    cache = api.init_cache(tc, 2, 8, device="cpu")
    cache = api.attach_memory(cache, api.encode_memory(model, frames, tc), model, tc)
    stepped = torch.cat([api.decode_step(model, cache, tokens[:, i:i + 1], tc)[0]
                         for i in range(8)], dim=1)
    np.testing.assert_allclose(stepped.numpy(), full.numpy(), rtol=TOL, atol=TOL)


def test_bf16_forward_and_decode_close_to_jax():
    jc, tc, jp, model = _models("bfloat16")
    assert model.embed.dtype == torch.bfloat16
    frames, tokens = _inputs(jc, 2, 10, seed=7)
    want = _f32(japi.forward_logits(jp, {"tokens": tokens, "frames": frames}, jc))
    got = api.forward_logits(model, {"tokens": tokens, "frames": frames}, tc)
    assert got.dtype == torch.bfloat16  # the tied head in the compute dtype
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=BF16_TOL)
    jcache = japi.attach_memory(japi.init_cache(jc, 2, 4), japi.encode_memory(jp, frames, jc),
                                jp, jc)
    tcache = api.attach_memory(api.init_cache(tc, 2, 4, device="cpu"),
                               api.encode_memory(model, frames, tc), model, tc)
    assert tcache["self_k"].dtype == tcache["mem_k"].dtype == torch.bfloat16
    for i in range(4):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(tokens[:, i:i + 1]), jc)
        tl, tcache = api.decode_step(model, tcache, tokens[:, i:i + 1], tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=BF16_TOL)


def test_dummy_batch_and_init():
    """``make_dummy_batch`` adds ``frames`` in the compute dtype, drawn from
    the call's generator (the same seed, the same batch); ``init_params``
    sizes ``pos_dec`` by ``max_decode_len``."""
    cfg = get_config(ARCH, reduced=True)
    batch = api.make_dummy_batch(cfg, 3, 5, seed=2, device="cpu")
    assert set(batch) == {"tokens", "frames"}
    assert batch["frames"].shape == (3, cfg.encoder_seq, cfg.d_model)
    assert batch["frames"].dtype == torch.bfloat16 and batch["tokens"].dtype == torch.int32
    again = api.make_dummy_batch(cfg, 3, 5, seed=2, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    model = api.init_params(0, cfg, max_decode_len=20, device="cpu")
    assert isinstance(model, encdec.EncDec) and model.pos_dec.shape == (20, cfg.d_model)
    assert model.enc_ln.g.dtype == torch.bfloat16 and not model.embed.requires_grad
    assert float(model.enc[0].ln1.g.float().min()) == 1.0  # LayerNorm gains start at one


def test_full_width_parameter_count():
    """whisper-tiny at full width on the meta device: ``param_counts()``
    plus what it leaves out, ``pos_dec`` (max_decode_len x D), each layer's
    LayerNorm biases and gains beyond the two per layer it counts (the
    encoder's two LayerNorms, the decoder's third), and ``enc_ln`` and
    ``dec_ln``."""
    cfg = get_config(ARCH)
    model = encdec.EncDec(cfg, max_pos=448, device="meta")
    n = sum(p.numel() for p in model.parameters())
    d = cfg.d_model
    extra = 448 * d + cfg.encoder_layers * 4 * d + cfg.num_layers * 4 * d + 4 * d
    assert n == cfg.param_counts()["total"] + extra
    assert 36e6 < n - 448 * d < 37e6
    assert len(model.enc) == len(model.dec) == 4 and model.dec[0].cross_attn.wk.shape == (384, 384)
