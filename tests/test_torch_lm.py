"""Port's LM against the JAX package, on the reduced phi3, qwen1.5,
gemma-2b and gemma3 configs, the reduced MLA + MoE configs
(deepseek-v2-lite, deepseek-v3 with its query LoRA and MTP subtree) and the
reduced SSM and hybrid configs (mamba2, zamba2 with its groups and shared
attention block): the JAX
weights (``init_params`` from a PRNG key) are carried over as numpy
(``convert.lm_params_from_numpy``) and both packages run the same
numpy-seeded tokens.  Integer results (the MLA caches' ``pos``) are exact.

Tolerances: in float32 both packages do the same arithmetic and differ in
summation order only (matmul blocking, einsum order), so logits and caches
agree to 1e-4.  In bfloat16 the two frameworks round intermediates at
different places (XLA fuses elementwise chains and rounds once; PyTorch
rounds after each op), so logits agree only to a few bfloat16 steps of
their scale: BF16_TOL below."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import get_config, list_archs  # noqa: E402
from repro_torch.convert import (  # noqa: E402
    kv_cache_to_numpy,
    lm_params_from_numpy,
    lm_params_to_numpy,
)
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import api, attention, encdec, layers, lm  # noqa: E402

TOL = 1e-4
# absolute, on logits up to ~4.5 (bfloat16 step 2**-5 there); the reduced phi3
# forward measures 0.051 on the CPU
BF16_TOL = 0.1
# pixtral-12b's backbone (mistral-nemo) on text alone; its vision prefix below
ARCHS = ["phi3-medium-14b", "qwen1.5-4b", "gemma-2b", "gemma3-1b", "pixtral-12b"]
MOE_ARCHS = ["deepseek-v2-lite-16b", "deepseek-v3-671b"]
SSM_ARCHS = ["mamba2-2.7b", "zamba2-7b"]
# the last two families ported: the vision prefix and the encoder/decoder
LAST_FAMILIES = ["pixtral-12b", "whisper-tiny"]
# jitted: JAX's op-by-op dispatch compiles every op of the MoE/MLA stacks
_jax_init = jax.jit(japi.init_params, static_argnames=("cfg",))


def _configs(arch, dtype="float32", impl="xla"):
    kw = dict(param_dtype=dtype, compute_dtype=dtype, attn_impl=impl)
    return (dataclasses.replace(jax_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


_PARAMS: dict = {}


def _models(arch, dtype="float32", impl="xla"):
    """(jax cfg, port cfg, jax params, port LM) with the same weights."""
    jc, tc = _configs(arch, dtype, impl)
    if (arch, dtype) not in _PARAMS:
        jp = _jax_init(jax.random.PRNGKey(7), cfg=jc)
        tree = jax.tree.map(np.asarray, jp)
        _PARAMS[arch, dtype] = (jp, lm_params_from_numpy(tc, tree, device="cpu"))
    return (jc, tc, *_PARAMS[arch, dtype])


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


@pytest.mark.parametrize("variant", ["swiglu", "geglu", "gelu"])
def test_layers_match_jax(variant):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 6, 32), np.float32)
    gamma, beta = rng.standard_normal(32, np.float32), rng.standard_normal(32, np.float32)
    t = torch.from_numpy
    np.testing.assert_allclose(layers.rms_norm(t(x), t(gamma)).numpy(),
                               np.asarray(jlayers.rms_norm(x, gamma)), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(layers.layer_norm(t(x), t(gamma), t(beta)).numpy(),
                               np.asarray(jlayers.layer_norm(x, gamma, beta)), rtol=TOL, atol=TOL)
    pos = np.arange(6, dtype=np.int32)
    jc, js = jlayers.rope(jnp.asarray(pos), 16, 1e4)
    tc, ts = layers.rope(t(pos), 16, 1e4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=TOL, atol=TOL)
    xh = x.reshape(2, 6, 2, 16)
    np.testing.assert_allclose(layers.apply_rope(t(xh), tc[None], ts[None]).numpy(),
                               np.asarray(jlayers.apply_rope(xh, jc[None], js[None])),
                               rtol=TOL, atol=TOL)
    jp = jlayers.mlp_init(jax.random.PRNGKey(0), 32, 48, variant, dtype=jnp.float32)
    tp = {k: t(np.array(v)) for k, v in jp.items()}
    np.testing.assert_allclose(layers.mlp_apply(tp, t(x), variant).numpy(),
                               np.asarray(jlayers.mlp_apply(jp, x, variant)), rtol=TOL, atol=TOL)
    mlp = layers.MLP(None, 32, 48, variant, dtype=torch.float32, device="cpu")
    assert sorted(n for n, _ in mlp.named_parameters()) == sorted(jp)


def test_cross_attention_matches_jax():
    jc, tc = _configs("whisper-tiny")
    params = jattn.cross_attn_init(jax.random.PRNGKey(1), jc, dtype=jnp.float32)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 5, jc.d_model), np.float32)
    memory = rng.standard_normal((2, 9, jc.d_model), np.float32)
    want = np.asarray(jattn.cross_attention(params, x, memory, jc))
    got = attention.cross_attention({k: torch.from_numpy(np.array(v)) for k, v in params.items()},
                                    torch.from_numpy(x), torch.from_numpy(memory), tc)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip(arch):
    jc, tc, jp, model = _models(arch)
    tree = jax.tree.map(np.asarray, jp)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    names = {n for n, _ in model.named_parameters()}
    assert "tail.0.mixer.wq" in names and "embed" in names
    assert ("lm_head" in names) != tc.tie_embeddings


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_jax(arch, impl):
    jc, tc, jp, model = _models(arch, impl=impl)
    toks = _tokens(jc, 2, 40, seed=1)
    want = np.asarray(japi.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jc))
    got = api.forward_logits(model, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 40, tc.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch,flash_calls", [("phi3-medium-14b", 2), ("qwen1.5-4b", 2),
                                               ("gemma-2b", 2), ("gemma3-1b", 0)])
def test_flash_path_taken_under_jax_conditions(arch, flash_calls, monkeypatch):
    """pallas_flash routes each layer's causal attention through the flash
    wrapper, except where the JAX package keeps einsum (a sliding window)."""
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    jc, tc, jp, model = _models(arch, impl="pallas_flash")
    api.forward_logits(model, {"tokens": _tokens(tc, 1, 16)}, tc)
    assert len(calls) == flash_calls
    _, tc_xla, _, _ = _models(arch, impl="xla")
    api.forward_logits(model, {"tokens": _tokens(tc, 1, 16)}, tc_xla)
    assert len(calls) == flash_calls


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_match_jax(arch):
    jc, tc, jp, model = _models(arch)
    toks = _tokens(jc, 2, 8, seed=2)
    max_len = 12
    jcache = japi.init_cache(jc, 2, max_len)
    tcache = api.init_cache(tc, 2, max_len, device="cpu")
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jc))
    for i in range(8):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = api.decode_step(model, tcache, torch.from_numpy(toks[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine = kv_cache_to_numpy(tcache)
    theirs = jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    assert int(mine["t"]) == int(theirs["t"]) == 8
    np.testing.assert_array_equal(mine["tail"]["pos"], theirs["tail"]["pos"])
    for key in ("k", "v"):
        assert mine["tail"][key].shape == theirs["tail"][key].shape
        np.testing.assert_allclose(mine["tail"][key], theirs["tail"][key], rtol=TOL, atol=TOL)


def test_ring_cache_decode_matches_jax():
    """An all-local gemma3 stack keeps window-sized ring caches; decoding past
    the window wraps them in both packages alike."""
    jc, tc = _configs("gemma3-1b")
    jc = dataclasses.replace(jc, num_layers=2)  # layers 0, 1 are local (period 3)
    tc = dataclasses.replace(tc, num_layers=2)
    jp = japi.init_params(jax.random.PRNGKey(3), jc)
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    toks = _tokens(jc, 2, 14, seed=3)
    jcache, tcache = japi.init_cache(jc, 2, 20), api.init_cache(tc, 2, 20, device="cpu")
    assert tcache["tail"][0]["k"].shape[1] == tc.sliding_window == 8
    for i in range(14):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tcache = api.decode_step(model, tcache, toks[:, i:i + 1], tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    np.testing.assert_array_equal(mine["tail"]["pos"], theirs["tail"]["pos"])
    np.testing.assert_allclose(mine["tail"]["k"], theirs["tail"]["k"], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches_jax_and_forward(arch):
    jc, tc, jp, model = _models(arch)
    toks = _tokens(jc, 2, 10, seed=4)
    jl, jcache = jlm.prefill(jp, jnp.asarray(toks), jc, max_len=16)
    tl, tcache = lm.prefill(model, torch.from_numpy(toks), tc, max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    np.testing.assert_allclose(mine["tail"]["v"], theirs["tail"]["v"], rtol=TOL, atol=TOL)
    # the stepped prefill and the full-sequence forward agree
    full = api.forward_logits(model, {"tokens": toks}, tc)
    np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
def test_bf16_forward_and_decode_close_to_jax(impl):
    jc, tc, jp, model = _models("phi3-medium-14b", "bfloat16", impl)
    assert model.embed.dtype == torch.bfloat16
    toks = _tokens(jc, 2, 32, seed=5)
    want = _f32(japi.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jc))
    got = api.forward_logits(model, {"tokens": toks}, tc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=BF16_TOL)
    jcache, tcache = japi.init_cache(jc, 2, 8), api.init_cache(tc, 2, 8, device="cpu")
    for i in range(4):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tcache = api.decode_step(model, tcache, toks[:, i:i + 1], tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=BF16_TOL)


def test_steps_match_jax():
    jc, tc, jp, model = _models("qwen1.5-4b")
    toks = _tokens(jc, 3, 12, seed=6)
    want = np.asarray(jsteps.make_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)}))
    got = steps.make_prefill_step(tc)(model, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    jnext, _ = jsteps.make_serve_step(jc)(jp, japi.init_cache(jc, 3, 4), jnp.asarray(toks[:, :1]))
    tnext, tcache = steps.make_serve_step(tc)(model, api.init_cache(tc, 3, 4, device="cpu"),
                                              toks[:, :1])
    assert tnext.dtype == torch.int32 and tcache["t"] == 1
    np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))


@pytest.mark.parametrize("arch", LAST_FAMILIES)
def test_unported_families_raise(arch):
    """The two families that raised ``NotImplementedError`` until they were
    ported now build through every entry point: the model (an ``EncDec``
    for whisper, an ``LM`` with ``vision_proj`` for pixtral), the decode
    cache, the dummy batch with its ``frames`` or ``patch_embeds``, and the
    train step."""
    cfg = get_config(arch, reduced=True)
    model = api.init_params(0, cfg, max_decode_len=24, device="cpu")
    batch = api.make_dummy_batch(cfg, 2, 8, seed=1, device="cpu")
    cache = api.init_cache(cfg, 2, 24, device="cpu")
    assert callable(steps.make_train_step(cfg, None))
    if cfg.encoder_decoder:
        assert isinstance(model, encdec.EncDec) and set(batch) == {"tokens", "frames"}
        assert cache["self_k"].shape == (cfg.num_layers, 2, 24, cfg.num_heads, cfg.head_dim)
        cache = api.attach_memory(cache, api.encode_memory(model, batch["frames"], cfg),
                                  model, cfg)
    else:
        assert isinstance(model, lm.LM) and set(batch) == {"tokens", "patch_embeds"}
        assert model.vision_proj.shape == (cfg.vision_dim, cfg.d_model)
        assert batch["patch_embeds"].shape == (2, cfg.num_patches, cfg.vision_dim)
    with torch.no_grad():
        logits = api.forward_logits(model, batch, cfg)
        step_logits, cache = api.decode_step(model, cache, batch["tokens"][:, :1], cfg)
        loss, _ = api.train_loss(model, batch, cfg)
    n_prefix = cfg.num_patches if cfg.vision_prefix else 0
    assert logits.shape == (2, n_prefix + 8, cfg.vocab_size) and np.isfinite(float(loss))
    assert step_logits.shape == (2, 1, cfg.vocab_size) and cache["t"] == 1


def test_api_surface():
    assert list_archs() == sorted(list_archs()) and len(list_archs()) == 10
    wcfg = get_config("whisper-tiny", reduced=True)
    wmodel = api.init_params(0, wcfg, max_decode_len=8, device="cpu")
    frames = api.make_dummy_batch(wcfg, 1, 4, device="cpu")["frames"]
    memory = api.encode_memory(wmodel, frames, wcfg)
    assert memory.shape == frames.shape and memory.dtype == torch.bfloat16
    cache = api.attach_memory(api.init_cache(wcfg, 1, 8, device="cpu"), memory, wmodel, wcfg)
    assert cache["mem_k"].shape == (wcfg.num_layers, 1, wcfg.encoder_seq, wcfg.num_heads,
                                    wcfg.head_dim)
    cfg = get_config("phi3-medium-14b", reduced=True)
    batch = api.make_dummy_batch(cfg, 2, 5, seed=1, device="cpu")
    assert batch["tokens"].shape == (2, 5) and batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < cfg.vocab_size
    model = api.init_params(0, cfg, device="cpu")
    again = api.init_params(0, cfg, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))
    assert model.embed.dtype == torch.bfloat16 and not model.embed.requires_grad
    # param_counts leaves the final norm's d_model weights out
    assert sum(p.numel() for p in model.parameters()) == cfg.param_counts()["total"] + cfg.d_model


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi3-medium-14b", reduced=True)
    for make in (lambda: api.init_params(0, cfg), lambda: api.init_cache(cfg, 1, 4),
                 lambda: api.make_dummy_batch(cfg, 1, 4)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_full_config_sizes():
    """phi3-medium-14b at full width: the parameter count the model builds
    (on the meta device: nothing allocated) is the config's."""
    cfg = get_config("phi3-medium-14b")
    model = lm.LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_counts()["total"] + cfg.d_model and 14.5e9 < n < 14.8e9
    assert len(model.tail) == 40 and model.tail[0].mixer.wk.shape == (5120, 1280)


# -- the MLA + MoE family --------------------------------------------------------
def _no_drop(cfg):
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.top_k)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_params_round_trip(arch):
    """The JAX tree (the ``mtp`` subtree included) converts into the port
    and back; the MoE routers stay float32 in a bfloat16 model."""
    jc, tc, jp, model = _models(arch, "bfloat16")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    params = dict(model.named_parameters())
    assert params["tail.0.ffn.router"].dtype == torch.float32
    assert params["tail.0.ffn.w_gate"].dtype == torch.bfloat16
    assert params["prefix.0.ffn.w_gate"].ndim == 2  # the leading dense layer
    assert ("mtp.block.ffn.router" in params) == bool(tc.mtp_depth)
    assert ("tail.0.mixer.wq_a" in params) == bool(tc.q_lora_rank)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_forward_logits_and_aux_match_jax(arch):
    jc, tc, jp, model = _models(arch)
    toks = _tokens(jc, 2, 40, seed=1)
    _, want, want_aux = jax.jit(jlm.forward, static_argnames=("cfg",))(
        jp, {"tokens": jnp.asarray(toks)}, cfg=jc)
    _, got, aux = lm.forward(model, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 40, tc.vocab_size) and float(aux) > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_decode_steps_and_caches_match_jax(arch):
    jc, tc, jp, model = _models(arch)
    toks = _tokens(jc, 2, 8, seed=2)
    jcache = japi.init_cache(jc, 2, 12)
    tcache = api.init_cache(tc, 2, 12, device="cpu")
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jc))
    for i in range(8):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = api.decode_step(model, tcache, torch.from_numpy(toks[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    assert sorted(mine["tail"]) == ["c_kv", "k_pe", "pos"] and int(mine["t"]) == 8
    for la, lb in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert la.shape == lb.shape and la.dtype == lb.dtype
        np.testing.assert_allclose(la, lb, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(mine["tail"]["pos"], theirs["tail"]["pos"])


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_matches_jax_and_no_drop_forward(arch):
    """The stepped prefill (absorbed MLA, no-drop MoE per step) equals JAX's,
    and its argmax equals a no-drop full-sequence forward's at every
    position (JAX's ``test_decode_steps_match_prefill``)."""
    jc, tc, jp, model = _models(arch)
    toks = _tokens(jc, 2, 10, seed=4)
    jl, _ = jax.jit(jlm.prefill, static_argnames=("cfg", "max_len"))(
        jp, jnp.asarray(toks), cfg=jc, max_len=16)
    tl, tcache = lm.prefill(model, torch.from_numpy(toks), tc, max_len=16)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    assert tcache["t"] == 10
    full = steps.make_prefill_step(_no_drop(tc))(model, {"tokens": toks})
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), full.argmax(-1).numpy())
    np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=TOL, atol=TOL)
    tnext, _ = steps.make_serve_step(tc)(model, api.init_cache(tc, 2, 4, device="cpu"),
                                         toks[:, :1])
    np.testing.assert_array_equal(tnext.numpy(), tl[:, 0].argmax(-1).numpy())


def test_moe_bf16_close_to_jax():
    jc, tc, jp, model = _models("deepseek-v2-lite-16b", "bfloat16")
    toks = _tokens(jc, 2, 32, seed=5)
    # op by op, as the dense bf16 test runs it: under jit XLA fuses and
    # rounds at other places than PyTorch does
    want = _f32(japi.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jc))
    got = api.forward_logits(model, {"tokens": toks}, tc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=BF16_TOL)
    jcache, tcache = japi.init_cache(jc, 2, 8), api.init_cache(tc, 2, 8, device="cpu")
    assert tcache["tail"][0]["c_kv"].dtype == torch.bfloat16
    for i in range(4):
        jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tcache = api.decode_step(model, tcache, toks[:, i:i + 1], tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=BF16_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_training_raises(arch):
    """The MoE/MTP family trains (``tests/test_torch_train.py`` holds it to
    JAX): its loss and train step run.  The same config flagged with a
    vision prefix (which raised while that family was unported) trains on a
    batch with no ``patch_embeds`` text-only, as JAX's does
    (``repro/models/lm.py:208``): the same loss and metrics."""
    jc, tc, jp, model = _models(arch)
    batch = {"tokens": _tokens(tc, 1, 8)}
    total, metrics = api.train_loss(model, batch, tc)
    assert np.isfinite(float(total)) and ("mtp_loss" in metrics) == bool(tc.mtp_depth)
    steps.make_train_step(tc, None)
    flagged = dataclasses.replace(tc, vision_prefix=True)
    total_v, metrics_v = api.train_loss(model, batch, flagged)
    assert float(total_v) == float(total) and set(metrics_v) == set(metrics)
    assert callable(steps.make_train_step(flagged, None))


def test_full_deepseek_v2_lite_size():
    """deepseek-v2-lite-16b at full width on the meta device: the config's
    parameter count plus the norms ``param_counts`` leaves out (the final
    norm and each layer's ``kv_norm``)."""
    cfg = get_config("deepseek-v2-lite-16b")
    model = lm.LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    total = cfg.param_counts()["total"]
    assert total == 15_706_468_352
    assert n == total + cfg.d_model + cfg.num_layers * cfg.kv_lora_rank
    assert len(model.prefix) == 1 and len(model.tail) == 26
    assert model.tail[0].ffn.w_gate.shape == (64, 2048, 1408)
    assert model.tail[0].ffn.shared.w_gate.shape == (2048, 2816)
    assert model.tail[0].ffn.router.dtype == torch.float32
    assert model.tail[0].mixer.wkv_a.shape == (2048, 576)
    assert model.prefix[0].ffn.w_gate.shape == (2048, 10_944)


# -- the SSM and hybrid families ----------------------------------------------------
def _ssm_tokens(cfg, b, s, seed):
    """s a multiple of the reduced configs' SSD chunk (8): the chunked scan
    takes no ragged length, in either package."""
    assert s % cfg.ssm_chunk == 0
    return _tokens(cfg, b, s, seed)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_params_round_trip(arch):
    """The JAX tree (``groups`` stacked (G, L, ...), ``shared_attn``, the
    ``tail``) converts into the port and back; the Mamba blocks carry no
    FFN, ``a_log``/``dt_bias``/``d_skip`` stay float32 in a bf16 model."""
    jc, tc, jp, model = _models(arch, "bfloat16")
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    back = lm_params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape and np.array_equal(a, b)
    params = dict(model.named_parameters())
    assert not any(".ffn." in n or n.endswith("norm2") for n in params
                   if n.startswith(("groups.", "tail.")))
    assert params["tail.0.mixer.a_log"].dtype == torch.float32
    assert params["tail.0.mixer.w_in"].dtype == torch.bfloat16
    assert ("shared_attn.mlp.w_up" in params) == bool(tc.hybrid_attn_period)
    if tc.hybrid_attn_period:
        assert len(model.groups) == 2 and len(model.groups[0]) == 3 and len(model.tail) == 1
        assert jp["groups"]["mixer"]["w_in"].shape[:2] == (2, 3)


@pytest.mark.parametrize("arch,impl", [("mamba2-2.7b", "xla"), ("zamba2-7b", "xla"),
                                       ("zamba2-7b", "pallas_flash")])
def test_ssm_forward_logits_match_jax(arch, impl):
    """zamba2 with ``pallas_flash`` against JAX's Pallas kernel in interpret
    mode: the shared block's attention is the flash call, once a group."""
    jc, tc, jp, model = _models(arch, impl=impl)
    toks = _ssm_tokens(jc, 2, 32, seed=1)
    want = np.asarray(japi.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jc))
    got = api.forward_logits(model, {"tokens": torch.from_numpy(toks)}, tc)
    assert got.shape == (2, 32, tc.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_zamba2_flash_calls_once_a_group(monkeypatch):
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    jc, tc, jp, model = _models("zamba2-7b", impl="pallas_flash")
    api.forward_logits(model, {"tokens": _ssm_tokens(tc, 1, 16, seed=2)}, tc)
    assert calls == [(1, 16, tc.num_heads, tc.head_dim)] * (tc.num_layers // tc.hybrid_attn_period)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_steps_and_caches_match_jax(arch):
    """Mamba states (conv ring, float32 SSM state) per layer, stacked (G, L,
    ...) in ``groups``, and the shared block's KV cache of each group."""
    jc, tc, jp, model = _models(arch)
    toks = _tokens(jc, 2, 8, seed=2)
    jcache = japi.init_cache(jc, 2, 12)
    tcache = api.init_cache(tc, 2, 12, device="cpu")
    jstep = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jc))
    for i in range(8):
        jl, jcache = jstep(jp, jcache, jnp.asarray(toks[:, i:i + 1]))
        tl, tcache = api.decode_step(model, tcache, torch.from_numpy(toks[:, i:i + 1]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    assert jax.tree.structure(mine) == jax.tree.structure(theirs)
    assert sorted(mine["tail"]) == ["conv", "ssm"] and int(mine["t"]) == 8
    assert ("shared" in mine) == bool(tc.hybrid_attn_period)
    for la, lb in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
        assert la.shape == lb.shape and la.dtype == lb.dtype
        np.testing.assert_allclose(la, lb, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_prefill_matches_jax_and_forward(arch):
    """The stepped prefill (one recurrent step a token) equals JAX's and the
    full-sequence forward (the chunked scan) at every position."""
    jc, tc, jp, model = _models(arch)
    toks = _ssm_tokens(jc, 2, 16, seed=4)
    jl, jcache = jax.jit(jlm.prefill, static_argnames=("cfg", "max_len"))(
        jp, jnp.asarray(toks), cfg=jc, max_len=20)
    tl, tcache = lm.prefill(model, torch.from_numpy(toks), tc, max_len=20)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL, atol=TOL)
    mine, theirs = kv_cache_to_numpy(tcache), jax.tree.map(np.asarray, jcache)
    np.testing.assert_allclose(mine["tail"]["ssm"], theirs["tail"]["ssm"], rtol=TOL, atol=TOL)
    full = steps.make_prefill_step(tc)(model, {"tokens": toks})
    np.testing.assert_allclose(tl.numpy(), full.numpy(), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_serve_steps_match_jax(arch):
    jc, tc, jp, model = _models(arch)
    toks = _ssm_tokens(jc, 3, 8, seed=6)
    want = np.asarray(jsteps.make_prefill_step(jc)(jp, {"tokens": jnp.asarray(toks)}))
    got = steps.make_prefill_step(tc)(model, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    jcache, tcache = japi.init_cache(jc, 3, 6), api.init_cache(tc, 3, 6, device="cpu")
    jserve, tserve = jax.jit(jsteps.make_serve_step(jc)), steps.make_serve_step(tc)
    jnext, tnext = jnp.asarray(toks[:, :1]), toks[:, :1]
    for _ in range(5):  # greedy: each step feeds its own token back
        jnext, jcache = jserve(jp, jcache, jnext)
        tnext, tcache = tserve(model, tcache, tnext)
        assert tnext.dtype == torch.int32
        np.testing.assert_array_equal(tnext.numpy(), np.asarray(jnext))
        jnext, tnext = jnext[:, None], tnext[:, None]
    assert tcache["t"] == 5


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_bf16_close_to_jax(arch):
    """JAX runs op by op here (``disable_jit``), rounding after each op as
    PyTorch does: its layer scans, compiled, fuse the bf16 chains of the
    conv, the gates and the norms and round elsewhere (on reduced zamba2
    that moves JAX's own logits 0.16 from its op-by-op ones)."""
    jc, tc, jp, model = _models(arch, "bfloat16")
    toks = _ssm_tokens(jc, 2, 32, seed=5)
    with jax.disable_jit():
        want = _f32(japi.forward_logits(jp, {"tokens": jnp.asarray(toks)}, jc))
    got = api.forward_logits(model, {"tokens": toks}, tc)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), want, rtol=0, atol=BF16_TOL)
    jcache, tcache = japi.init_cache(jc, 2, 8), api.init_cache(tc, 2, 8, device="cpu")
    assert tcache["tail"][0]["conv"].dtype == torch.bfloat16
    assert tcache["tail"][0]["ssm"].dtype == torch.float32
    for i in range(4):
        with jax.disable_jit():
            jl, jcache = japi.decode_step(jp, jcache, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tcache = api.decode_step(model, tcache, toks[:, i:i + 1], tc)
        np.testing.assert_allclose(_f32(tl), _f32(jl), rtol=0, atol=BF16_TOL)


def _rel_rms_top1(got, want):
    g, w = _f32(got), _f32(want)
    return (float(np.linalg.norm(g - w) / np.linalg.norm(w)),
            float((g.argmax(-1) == w.argmax(-1)).mean()))


def test_ssm_bf16_paths_part_as_jax_at_depth():
    """mamba2 at its full depth (64 layers) and a reduced width (d_model
    256, 8 heads of 64, state 64), bf16, 4 x 32 seeded tokens: the
    full-sequence forward, the stepped prefill, and the float32 stepped
    prefill of the same weights, in each package (JAX compiled, as it
    runs).  In bf16 the two paths' roundings compound over the depth, and
    JAX's own two paths land about as far from each other and from float32
    as the port's: each of the port's three distances stays within 1.25x
    of JAX's.  Prints the readings."""
    kw = dict(num_layers=64, d_model=256, ssm_head_dim=64, ssm_state=64, ssm_chunk=8)

    def configs(dtype):
        d = dict(kw, param_dtype=dtype, compute_dtype=dtype)
        return (dataclasses.replace(jax_config("mamba2-2.7b", reduced=True), **d),
                dataclasses.replace(get_config("mamba2-2.7b", reduced=True), **d))

    (jc, tc), (jc32, tc32) = configs("bfloat16"), configs("float32")
    jp = _jax_init(jax.random.PRNGKey(7), cfg=jc)
    model = lm_params_from_numpy(tc, jax.tree.map(np.asarray, jp), device="cpu")
    model32 = lm_params_from_numpy(
        tc32, jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), jp), device="cpu")
    toks = _ssm_tokens(jc, 4, 32, seed=5)
    with torch.no_grad():
        ref = lm.prefill(model32, torch.from_numpy(toks), tc32, max_len=32)[0]
        port = (api.forward_logits(model, {"tokens": toks}, tc),
                lm.prefill(model, torch.from_numpy(toks), tc, max_len=32)[0])
    forward = jax.jit(lambda p, t: japi.forward_logits(p, {"tokens": t}, jc))
    ours = (forward(jp, jnp.asarray(toks)), jlm.prefill(jp, jnp.asarray(toks), jc, max_len=32)[0])
    readings = {}
    for name, (fwd, stepped) in (("port", port), ("jax", ours)):
        readings[name] = {"forward_vs_stepped": _rel_rms_top1(fwd, stepped),
                          "forward_vs_float32": _rel_rms_top1(fwd, ref),
                          "stepped_vs_float32": _rel_rms_top1(stepped, ref)}
    print("relative RMS, top-1 agreement:", readings)
    for what, (rel, _) in readings["port"].items():
        assert rel <= 1.25 * readings["jax"][what][0], what


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_training_raises(arch):
    """Training no longer raises for the SSM and hybrid configs (it did
    while they only served): ``train_loss`` gives JAX's metrics and
    ``make_train_step`` builds, as it does now for the encoder/decoder and
    the vision prefix too.  The gradients are held against ``jax.grad`` in
    ``tests/test_torch_train.py``."""
    jc, tc, jp, model = _models(arch)
    toks = _tokens(tc, 1, 8)
    with torch.no_grad():
        _, metrics = api.train_loss(model, {"tokens": toks}, tc)
    _, want = japi.train_loss(jp, {"tokens": jnp.asarray(toks)}, jc)
    assert set(metrics) == set(want) == {"lm_loss", "aux_loss", "total_loss"}
    for k in metrics:
        np.testing.assert_allclose(float(metrics[k]), float(want[k]), rtol=TOL, atol=TOL)
    assert callable(steps.make_train_step(tc, None))
    for other in LAST_FAMILIES:
        assert callable(steps.make_train_step(get_config(other, reduced=True), None))


@pytest.mark.parametrize("arch,n_params", [("mamba2-2.7b", 2_831_296_000),
                                           ("zamba2-7b", 6_699_750_608)])
def test_full_ssm_sizes(arch, n_params):
    """mamba2-2.7b and zamba2-7b at full width on the meta device: the
    config's count, less the norm2 a Mamba block lacks, plus what it leaves
    out (each block's ``d_skip`` and ``conv_b``, the final norm and the
    shared block's two norms)."""
    cfg = get_config(arch)
    model = lm.LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    conv_dim = cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    extra = cfg.d_model + cfg.num_layers * (cfg.ssm_heads + conv_dim - cfg.d_model)
    if cfg.hybrid_attn_period:
        extra += 2 * cfg.d_model
        assert len(model.groups) == 13 and len(model.groups[0]) == 6 and len(model.tail) == 3
        assert model.shared_attn.attn.wq.shape == (3584, 32 * 112)
        assert model.shared_attn.mlp.w_up.shape == (3584, 14_336)
    else:
        assert len(model.tail) == 64 and len(model.groups) == 0
    assert n == cfg.param_counts()["total"] + extra == n_params
    assert model.tail[0].mixer.w_in.shape == (
        cfg.d_model, 2 * cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state + cfg.ssm_heads)


# -- the vision prefix (pixtral) ----------------------------------------------------
def _patches(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((b, cfg.num_patches, cfg.vision_dim)).astype(np.float32)


@pytest.mark.parametrize("impl", ["xla", "pallas_flash"])
def test_vision_prefix_forward_matches_jax(impl, monkeypatch):
    """Reduced pixtral with ``patch_embeds``: the projected patches go before
    the tokens and attention runs causal over both, on the einsum path and
    on flash (JAX's in interpret mode; the port's plain version on the CPU),
    one flash call a layer over all P + S positions."""
    calls = []
    real = flash_ops.flash_attention
    monkeypatch.setattr(flash_ops, "flash_attention",
                        lambda q, *a, **k: calls.append(q.shape[1]) or real(q, *a, **k))
    jc, tc, jp, model = _models("pixtral-12b", impl=impl)
    toks, patches = _tokens(jc, 2, 24, seed=8), _patches(jc, 2, seed=8)
    want = np.asarray(japi.forward_logits(
        jp, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(patches)}, jc))
    got = api.forward_logits(model, {"tokens": toks, "patch_embeds": patches}, tc)
    assert got.shape == (2, tc.num_patches + 24, tc.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    assert calls == ([tc.num_patches + 24] * tc.num_layers if impl == "pallas_flash" else [])
    # the prefix changes the tokens' logits: the patches are attended to
    text = api.forward_logits(model, {"tokens": toks}, tc)
    assert float((text - got[:, tc.num_patches:]).abs().max()) > 1e-2


def test_full_pixtral_size():
    """pixtral-12b at full width on the meta device: the config's count
    (``vision_proj`` included) plus the final norm."""
    cfg = get_config("pixtral-12b")
    model = lm.LM(cfg, device="meta")
    n = sum(p.numel() for p in model.parameters())
    assert n == cfg.param_counts()["total"] + cfg.d_model and 12.2e9 < n < 12.3e9
    assert model.vision_proj.shape == (1024, 5120) and len(model.tail) == 40
    assert model.tail[0].mixer.wk.shape == (5120, 8 * 128)
