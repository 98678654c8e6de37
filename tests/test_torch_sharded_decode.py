"""Decoding on a mesh: the port's serve step on (2,2), (1,4) and (4,1) gloo
meshes of four CPU ranks against the port's unsharded step and the JAX
package's ``api.decode_step``, from the same JAX weights (float32).

Each case steps a prompt of PROMPT tokens, all but the last through
``api.decode_step``, then takes STEPS greedy ``serve_step``s, the first fed
the prompt's last token and each next one the token before, for BATCH
requests in a cache of MAX_LEN positions; the model is placed by
``sharding.param_specs`` and the cache by ``sharding.cache_specs``.  One
spawn of four ranks a mesh runs every case of that mesh:

  * (2,2): all ten reduced archs (KV heads over ``model`` for qwen, the
    whisper decoder and zamba2's shared block; a sequence-parallel cache
    for the MQA gemmas; MLA's compressed cache on its sequence; the SSM
    state on its heads and the conv ring on its channels);
  * (1,4): the layouts that change there: phi3 (2 KV heads: sequence
    parallel), gemma3 with an all-local ring of 4 (one slot a rank, the
    ring wrapping), deepseek-v2-lite (MLA + MoE), mamba2 and whisper with 6
    heads (its sequence-parallel self and cross caches);
  * (4,1): the batch over four ranks, nothing over ``model``.

Every greedy token equals the unsharded port's and JAX's.  Every step's
logits are within RTOL of the unsharded port's (the sequence-parallel
softmax and the row-parallel products sum in another order) and within
``test_torch_lm.TOL`` of JAX's.  Every leaf of the final cache, gathered
whole, holds the unsharded port's positions exactly and its keys, values
and states within RTOL.  The caches' placements are asserted, so each
layout named above is the one that ran."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_mesh_workers as workers  # noqa: E402
from repro.configs import get_config as jax_config  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

pytestmark = pytest.mark.proc

RTOL = 1e-5   # sharded against unsharded, the port's own step
TOL = 1e-4    # test_torch_lm's, against JAX
PROMPT, STEPS, MAX_LEN, BATCH = 4, 4, 16, 4

# case name: (arch, config changes)
CASES = {
    "phi3-medium-14b": ("phi3-medium-14b", {}),
    "qwen1.5-4b": ("qwen1.5-4b", {}),
    "gemma-2b": ("gemma-2b", {}),
    "gemma3-1b": ("gemma3-1b", {}),
    "gemma3-1b/ring": ("gemma3-1b", {"num_layers": 2, "sliding_window": 4}),
    "pixtral-12b": ("pixtral-12b", {}),
    "deepseek-v2-lite-16b": ("deepseek-v2-lite-16b", {}),
    "deepseek-v3-671b": ("deepseek-v3-671b", {}),
    "mamba2-2.7b": ("mamba2-2.7b", {}),
    "zamba2-7b": ("zamba2-7b", {}),
    "whisper-tiny": ("whisper-tiny", {}),
    "whisper-tiny/6 heads": ("whisper-tiny", {"num_heads": 6}),
}
MESHES = {
    (2, 2): ["phi3-medium-14b", "qwen1.5-4b", "gemma-2b", "gemma3-1b", "pixtral-12b",
             "deepseek-v2-lite-16b", "deepseek-v3-671b", "mamba2-2.7b", "zamba2-7b",
             "whisper-tiny"],
    (1, 4): ["phi3-medium-14b", "gemma3-1b/ring", "deepseek-v2-lite-16b", "mamba2-2.7b",
             "whisper-tiny/6 heads"],
    (4, 1): ["qwen1.5-4b", "deepseek-v2-lite-16b", "mamba2-2.7b", "whisper-tiny"],
}
# (mesh, case): {cache leaf: the placement it must have}; "S" a sequence
# sharded over model, "H" heads, "C" channels, "B" the batch alone (over
# data, nothing over model)
LAYOUTS = {
    ((2, 2), "qwen1.5-4b"): {"k": "H"},
    ((2, 2), "gemma-2b"): {"k": "S"},
    ((2, 2), "gemma3-1b"): {"k": "S"},
    ((2, 2), "phi3-medium-14b"): {"k": "H"},
    ((2, 2), "deepseek-v2-lite-16b"): {"c_kv": "S", "k_pe": "S"},
    ((2, 2), "mamba2-2.7b"): {"ssm": "H", "conv": "C"},
    ((2, 2), "zamba2-7b"): {"ssm": "H", "conv": "C", "k": "H"},
    ((2, 2), "whisper-tiny"): {"self_k": "H", "mem_k": "H"},
    ((1, 4), "phi3-medium-14b"): {"k": "S"},
    ((1, 4), "gemma3-1b/ring"): {"k": "S"},
    ((1, 4), "deepseek-v2-lite-16b"): {"c_kv": "S"},
    ((1, 4), "mamba2-2.7b"): {"ssm": "H", "conv": "C"},
    ((1, 4), "whisper-tiny/6 heads"): {"self_k": "S", "mem_k": "S"},
    ((4, 1), "qwen1.5-4b"): {"k": "B"},
    ((4, 1), "mamba2-2.7b"): {"ssm": "B", "conv": "B"},
    ((4, 1), "whisper-tiny"): {"self_k": "B"},
}
# the tensor dim of each layout letter, by leaf
_DIMS = {"k": {"B": 0, "S": 1, "H": 2}, "c_kv": {"S": 1}, "k_pe": {"S": 1},
         "ssm": {"B": 0, "H": 1}, "conv": {"B": 0, "C": 2}, "self_k": {"B": 1, "S": 2, "H": 3},
         "mem_k": {"S": 2, "H": 3}}


def _cfgs(arch, changes):
    kw = dict(param_dtype="float32", compute_dtype="float32", attn_impl="xla", **changes)
    return (dataclasses.replace(jax_config(arch, reduced=True), **kw),
            dataclasses.replace(get_config(arch, reduced=True), **kw))


_INPUTS: dict = {}


def _inputs(name):
    """(JAX config, port config, JAX weights as numpy, prompt, frames)."""
    if name not in _INPUTS:
        arch, changes = CASES[name]
        jc, tc = _cfgs(arch, changes)
        seed = sorted(CASES).index(name)
        tree = jax.tree.map(np.asarray, japi.init_params(jax.random.PRNGKey(seed), jc,
                                                         max_decode_len=MAX_LEN))
        rng = np.random.default_rng(seed)
        prompt = rng.integers(0, jc.vocab_size, (BATCH, PROMPT)).astype(np.int32)
        frames = (rng.standard_normal((BATCH, jc.encoder_seq, jc.d_model)).astype(np.float32)
                  if jc.encoder_decoder else None)
        _INPUTS[name] = (jc, tc, tree, prompt, frames)
    return _INPUTS[name]


@pytest.fixture(scope="module")
def sharded():
    """Each mesh's cases, four ranks a mesh, the three meshes at once: rank
    0's results by (mesh, case)."""
    from concurrent.futures import ThreadPoolExecutor

    def run(shape):
        cases = [(n, *_inputs(n)[1:4], STEPS, MAX_LEN, _inputs(n)[4]) for n in MESHES[shape]]
        # about 50 s alone; the limit leaves room for a loaded machine
        return run_ranks(workers.sharded_decode, 4, args=(cases, shape), timeout=600)

    with ThreadPoolExecutor(len(MESHES)) as pool:
        spawned = dict(zip(MESHES, pool.map(run, MESHES)))
    out = {}
    for shape, ranks in spawned.items():
        for n in MESHES[shape]:
            out[shape, n] = ranks[0][n]
            for r in ranks[1:]:  # every rank returns the same gathered results
                assert all(np.array_equal(a, b) for a, b in zip(r[n]["tokens"],
                                                                 ranks[0][n]["tokens"]))
    return out


_UNSHARDED: dict = {}


def _unsharded(name):
    """(the port's unsharded run, JAX's logits and tokens)."""
    if name not in _UNSHARDED:
        jc, tc, tree, prompt, frames = _inputs(name)
        port = workers.decode_run(tc, tree, prompt, STEPS, MAX_LEN, frames)
        jp = jax.tree.map(jnp.asarray, tree)
        cache = japi.init_cache(jc, BATCH, MAX_LEN)
        if frames is not None:
            cache = japi.attach_memory(cache, japi.encode_memory(jp, jnp.asarray(frames), jc),
                                       jp, jc)
        step = jax.jit(lambda p, c, t: japi.decode_step(p, c, t, jc))
        logits, tokens = [], []
        tok = prompt[:, :1]
        for i in range(PROMPT + STEPS - 1):
            out, cache = step(jp, cache, jnp.asarray(tok))
            logits.append(np.asarray(out)[:, -1])
            if i + 1 < PROMPT:
                tok = prompt[:, i + 1:i + 2]
            else:
                tokens.append(logits[-1].argmax(-1).astype(np.int32))
                tok = tokens[-1][:, None]
        _UNSHARDED[name] = port, {"logits": logits, "tokens": tokens}
    return _UNSHARDED[name]


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}.")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], np.asarray(tree)


@pytest.mark.parametrize("shape,name", [(s, n) for s, names in MESHES.items() for n in names],
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_serve_steps_on_a_mesh_match_unsharded_and_jax(shape, name, sharded):
    got = sharded[shape, name]
    port, jax_run = _unsharded(name)
    for i, (g, p, j) in enumerate(zip(got["tokens"], port["tokens"], jax_run["tokens"])):
        np.testing.assert_array_equal(g, p, err_msg=f"greedy step {i}")
        np.testing.assert_array_equal(g, j, err_msg=f"greedy step {i} against JAX")
    assert len(got["tokens"]) == len(jax_run["tokens"]) == STEPS
    assert len(got["logits"]) == len(port["logits"]) == len(jax_run["logits"]) == PROMPT + STEPS - 1
    for i, (g, p, j) in enumerate(zip(got["logits"], port["logits"], jax_run["logits"])):
        np.testing.assert_allclose(g, p, rtol=RTOL, atol=RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(g, j, rtol=TOL, atol=TOL, err_msg=f"step {i} against JAX")
    mine, want = dict(_leaves(got["cache"])), dict(_leaves(port["cache"]))
    assert set(mine) == set(want)
    for leaf, w in want.items():
        if w.dtype.kind in "iu":
            np.testing.assert_array_equal(mine[leaf], w, err_msg=leaf)
        else:
            np.testing.assert_allclose(mine[leaf], w, rtol=RTOL, atol=RTOL, err_msg=leaf)
    for leaf, kind in LAYOUTS.get((shape, name), {}).items():
        placements = got["placements"][leaf]
        model = placements[-1]  # the model axis is the mesh's last
        if kind == "B":
            assert placements[0] == f"Shard(dim={_DIMS[leaf]['B']})", (leaf, placements)
            assert model == "Replicate()", (leaf, placements)
        else:
            assert model == f"Shard(dim={_DIMS[leaf][kind]})", (leaf, placements)


# (case, arch, max_len, positions written); the leaf sharded over model and
# its dim; "conv" shifts its whole ring each step
WRITES = [("attention", "gemma-2b", 8, (2, 5), "k", 1),
          ("mla", "deepseek-v2-lite-16b", 8, (2, 5), "c_kv", 1),
          ("conv ring", "mamba2-2.7b", 8, (3,), "conv", 2)]


@pytest.fixture(scope="module")
def writes():
    cases = [(name, arch, max_len, positions) for name, arch, max_len, positions, *_ in WRITES]
    return run_ranks(workers.cache_writes, 4, args=(cases,), timeout=200)[0]


@pytest.mark.parametrize("name,arch,max_len,positions,leaf,dim", WRITES, ids=[w[0] for w in WRITES])
def test_sharded_cache_writes_read_back(name, arch, max_len, positions, leaf, dim, writes):
    """The lost write, pinned: a sequence-parallel attention cache (MQA), a
    sequence-sharded MLA cache and a channel-sharded conv ring on (2,2),
    each written by its decode step on local shards (DTensor's
    ``__setitem__`` into a cache sharded on its sequence writes nothing and
    raises nothing).  Read back whole, each written position holds the
    unsharded step's value (within RTOL) and every other position is
    unchanged, bit for bit; for the ring (every slot shifts) and the SSM
    state, every value is the unsharded step's."""
    got = writes[name]
    assert got["placements"][leaf][-1] == f"Shard(dim={dim})", got["placements"][leaf]
    for key, mesh in got["mesh"].items():
        before, plain = got["before"][key], got["plain"][key]
        if name == "conv ring":
            np.testing.assert_allclose(mesh, plain, rtol=RTOL, atol=RTOL, err_msg=key)
            assert not np.array_equal(mesh, before), key
            continue
        written = np.zeros(before.shape[1], dtype=bool)
        written[list(positions)] = True
        np.testing.assert_allclose(mesh[:, written], plain[:, written], rtol=RTOL, atol=RTOL,
                                   err_msg=key)
        assert not np.array_equal(mesh[:, written], before[:, written]), key
        np.testing.assert_array_equal(mesh[:, ~written], before[:, ~written], err_msg=key)
