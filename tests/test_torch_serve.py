"""Port's LM data plane and serving driver against the JAX package: the
token feature set, the loader's point-in-time batches, the serving plane's
online GETs and the whole request path (GET -> stepped prefill -> greedy
decode), on the CPU with numpy-seeded inputs."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.core.featurestore import FeatureStore as JaxFeatureStore  # noqa: E402
from repro.data import loader as jloader  # noqa: E402
from repro.data.sources import TokenEventSource as JaxTokenEventSource  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.core.featurestore import FeatureStore  # noqa: E402
from repro_torch.core.offline_store import CREATION_TS, EVENT_TS  # noqa: E402
from repro_torch.data import loader  # noqa: E402
from repro_torch.data.sources import TokenEventSource  # noqa: E402
from repro_torch.kernels.online_lookup import ops as lookup_ops  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

HOUR = loader.HOUR


def _planes(seed=0, **src_kw):
    kw = dict(seed=seed, vocab_size=512, num_docs=32, chunk_len=16, chunks_per_bucket=64)
    kw.update(src_kw)
    jfs = JaxFeatureStore("leak-test", interpret=True)
    jsrc = JaxTokenEventSource("tok", **kw)
    jfs.register_source(jsrc)
    jspec = jfs.create_feature_set(jloader.TokenFeatureSet(jsrc))
    tfs = FeatureStore("leak-test", device="cpu")
    tsrc = TokenEventSource("tok", **kw)
    tfs.register_source(tsrc)
    tspec = tfs.create_feature_set(loader.TokenFeatureSet(tsrc))
    return (jfs, jspec), (tfs, tspec)


def test_token_feature_set_matches_jax():
    (_, jspec), (_, tspec) = _planes()
    assert tspec.name == jspec.name == "token_chunks" and tspec.version == jspec.version
    assert [f.name for f in tspec.features] == [f.name for f in jspec.features]
    assert [f.dtype for f in tspec.features] == [f.dtype for f in jspec.features]
    assert tspec.entity.name == jspec.entity.name
    assert tspec.entity.join_keys == jspec.entity.join_keys
    assert dataclasses.asdict(tspec.materialization) == dataclasses.asdict(jspec.materialization)
    for field in ("source_name", "timestamp_col", "source_lookback", "expected_delay"):
        assert getattr(tspec, field) == getattr(jspec, field), field
    assert tspec.transform.name == jspec.transform.name
    assert loader.HOUR == jloader.HOUR


@pytest.mark.parametrize("rank,world,seq_len", [(0, 1, 32), (1, 2, 40), (0, 1, 200)])
def test_sample_batch_byte_identical(rank, world, seq_len):
    (jfs, jspec), (tfs, tspec) = _planes(seed=3)
    kw = dict(seq_len=seq_len, batch_size=4, chunk_len=16, seed=3, rank=rank, world=world)
    jl = jloader.FeatureStoreLoader(store=jfs, spec=jspec, **kw)
    tl = loader.FeatureStoreLoader(store=tfs, spec=tspec, **kw)
    for hours in (3, 7):
        jl.advance(hours * HOUR)
        tl.advance(hours * HOUR)
        for step in (0, 5, 11):
            a, b = jl.sample_batch(step), tl.sample_batch(step)
            assert sorted(a) == sorted(b)
            for key in ("tokens", "__max_event_ts__", "__observation_ts__"):
                assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
            assert (b["__max_event_ts__"] <= b["__observation_ts__"]).all()
    assert tl.state_dict() == jl.state_dict()


def test_serving_plane_serves_jax_contexts():
    cfg_j, cfg_t = jax_config("phi3-medium-14b", reduced=True), get_config("phi3-medium-14b",
                                                                             reduced=True)
    jfs, jspec, jsrc = jserve.build_serving_plane(cfg_j, seed=0)
    tfs, tspec, tsrc = serve.build_serving_plane(cfg_t, seed=0, device="cpu")
    ids = np.random.default_rng(0).integers(0, tsrc.num_docs + 8, 40).astype(np.int64)
    jv, jf = jfs.get_online_features(jspec.name, jspec.version, [ids])
    before = lookup_ops.counter.launches
    tv, tf = tfs.get_online_features(tspec.name, tspec.version, [ids])
    assert lookup_ops.counter.launches == before  # a CPU store runs the plain lookup
    assert np.array_equal(jf, tf) and np.array_equal(jv, tv)
    assert tf.sum() > 0 and not tf.all()  # warm sessions and cold ids
    # no online/offline skew: each served context is the offline latest chunk
    hist = tfs.offline.read(tspec.name, tspec.version)
    cols = [f.name for f in tspec.features]
    for i in np.flatnonzero(tf):
        rows = np.flatnonzero(hist["doc_id"] == ids[i])
        latest = rows[np.lexsort((hist[CREATION_TS][rows], hist[EVENT_TS][rows]))[-1]]
        assert np.array_equal(tv[i], np.array([hist[c][latest] for c in cols], np.float32))


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "gemma3-1b", "deepseek-v2-lite-16b",
                                  "mamba2-2.7b", "zamba2-7b", "whisper-tiny", "pixtral-12b"])
def test_serve_generates_jax_tokens(arch, monkeypatch):
    """JAX's own ``main`` (float32 config) and the port's ``serve`` on the
    same weights, carried over as numpy, generate the same tokens (for
    deepseek-v2-lite through absorbed-MLA decode and no-drop MoE, for
    mamba2 and zamba2 through recurrent Mamba steps and the shared block's
    KV cache, for whisper through the encoder over zero frames and the
    cross K/V attached to the cache, pixtral text-only).  JAX's ``main``
    sizes whisper's ``pos_dec`` by the 32-token prompt plus the new tokens,
    and so do the weights drawn here."""
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    cfg_j = dataclasses.replace(jax_config(arch, reduced=True), **f32)
    cfg_t = dataclasses.replace(get_config(arch, reduced=True), **f32)
    monkeypatch.setattr(jserve, "get_config", lambda a, reduced: cfg_j)
    argv = ["--arch", arch, "--requests", "4", "--new-tokens", "6", "--seed", "1"]
    want = jserve.main(argv)
    tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(1), cfg_j,
                                                     max_decode_len=32 + 6))
    model = lm_params_from_numpy(cfg_t, tree, device="cpu")
    got = serve.serve(cfg_t, requests=4, new_tokens=6, seed=1, device="cpu", params=model,
                      keep_logits=True)
    assert got["context_hits"] == want["context_hits"] > 0
    assert got["tokens_generated"] == want["tokens_generated"] == 24
    assert got["generated"].shape == (4, 6)
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["prompt_logits"].shape == (4, got["prompts"].shape[1], cfg_t.vocab_size)
    assert (got["encode_ms"] is not None) == cfg_t.encoder_decoder


def test_main_runs_phi3_on_cpu():
    """``python -m repro_torch.launch.serve --arch phi3-medium-14b`` on the
    CPU: the reduced config, weights drawn from the seed."""
    out = serve.main(["--arch", "phi3-medium-14b"], device="cpu")
    cfg = get_config("phi3-medium-14b", reduced=True)
    assert out["requests"] == 8 and out["tokens_generated"] == 128
    assert out["generated"].shape == (8, 16)
    assert (0 <= out["generated"]).all() and (out["generated"] < cfg.vocab_size).all()
    assert out["prompts"].shape == (8, 32) and (out["prompts"] < cfg.vocab_size).all()
    np.testing.assert_array_equal(out["prompts"][~out["found"]], 1)
    again = serve.main(["--arch", "phi3-medium-14b"], device="cpu")
    np.testing.assert_array_equal(out["generated"], again["generated"])


@pytest.mark.parametrize("arch", ["whisper-tiny", "pixtral-12b"])
def test_main_runs_the_last_families_on_cpu(arch):
    """``python -m repro_torch.launch.serve --arch whisper-tiny`` (or
    ``pixtral-12b``) on the CPU: the reduced config, weights drawn from the
    seed, the same tokens twice."""
    out = serve.main(["--arch", arch, "--requests", "4", "--new-tokens", "4"], device="cpu")
    cfg = get_config(arch, reduced=True)
    assert out["generated"].shape == (4, 4) and (out["generated"] < cfg.vocab_size).all()
    assert out["context_hits"] > 0 and (out["encode_ms"] is not None) == cfg.encoder_decoder
    again = serve.main(["--arch", arch, "--requests", "4", "--new-tokens", "4"], device="cpu")
    np.testing.assert_array_equal(out["generated"], again["generated"])


def test_main_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "phi3-medium-14b"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.build_serving_plane(get_config("phi3-medium-14b", reduced=True))
