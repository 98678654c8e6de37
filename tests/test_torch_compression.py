"""The port's gradient compression (``repro_torch/optim/compression.py``)
against the JAX package's ``optim/compression.py``: ``GradCompressor``'s
restored gradients and residuals byte-identical to JAX's over three steps
of error feedback (the q8 codec is byte-identical, so are its round trips),
and ``pod_allreduce_compressed`` on a 2-rank (pod=2, data=1, model=1) gloo
mesh equal, bit for bit, to the mean of both ranks' restored values, each
rank keeping its own residual, for plain and DTensor gradients; the
identity without a ``pod`` axis wider than 1.  The q8 codec on DTensors
(on each rank's blocks, the last dim gathered where a shard would split a
block) gives the unsharded codec's bytes."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import test_torch_mesh_workers as workers  # noqa: E402
from repro.optim import compression as jcomp  # noqa: E402
from repro_torch.launch.mesh import AbstractMesh, run_ranks  # noqa: E402
from repro_torch.optim import compression  # noqa: E402

SHAPES = {"w": (4, 300), "b": (7,), "s": ()}


def _grads(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {k: np.asarray(rng.standard_normal(s) * 10 ** rng.uniform(-3, 1), dtype=np.float32)
            for k, s in SHAPES.items()}


def test_grad_compressor_is_byte_identical_to_jax():
    jc, tc = jcomp.GradCompressor(), compression.GradCompressor()
    g0 = _grads(0)
    jr = jc.init({k: jnp.asarray(v) for k, v in g0.items()})
    tr = tc.init({k: torch.from_numpy(v) for k, v in g0.items()})
    for step in range(3):
        g = _grads(step)
        jg, jr = jc.compress_decompress({k: jnp.asarray(v) for k, v in g.items()}, jr)
        tg, tr = tc.compress_decompress({k: torch.from_numpy(v) for k, v in g.items()}, tr)
        for k in SHAPES:
            assert np.asarray(jg[k]).tobytes() == tg[k].numpy().tobytes(), (step, k)
            assert np.asarray(jr[k]).tobytes() == tr[k].numpy().tobytes(), (step, k)


def test_pod_allreduce_is_the_identity_without_a_pod_axis():
    g = {k: torch.from_numpy(v) for k, v in _grads(0).items()}
    r = compression.GradCompressor().init(g)
    for mesh in (None, AbstractMesh((4, 2), ("data", "model")),
                 AbstractMesh((1, 2, 2), ("pod", "data", "model"))):
        out, new_r = compression.pod_allreduce_compressed(g, r, mesh)
        assert out is g and new_r is r


@pytest.mark.proc
def test_pod_allreduce_is_the_mean_of_the_restored_values():
    grads = [_grads(10), _grads(11)]
    residuals = [{k: np.asarray(v * 1e-3, dtype=np.float32) for k, v in _grads(20 + i).items()}
                 for i in range(2)]
    ranks = run_ranks(workers.pod_allreduce, 2, args=(grads, residuals), timeout=120)
    restored, kept = [], []
    for g, r in zip(grads, residuals):
        out, res = compression.GradCompressor().compress_decompress(
            {k: torch.from_numpy(v) for k, v in g.items()},
            {k: torch.from_numpy(v) for k, v in r.items()})
        restored.append(out)
        kept.append(res)
    for k in SHAPES:
        want = ((restored[0][k] + restored[1][k]) / 2).numpy()
        for i, out in enumerate(ranks):
            for kind in ("out", "out_dtensor"):
                assert out[kind][k].tobytes() == want.tobytes(), (kind, k, i)
            for kind in ("residual", "residual_dtensor"):
                assert out[kind][k].tobytes() == kept[i][k].numpy().tobytes(), (kind, k, i)
        # and JAX's body on one pod's values: the same restored value
        jres, _ = jcomp.GradCompressor().compress_decompress(
            {k: jnp.asarray(grads[0][k])}, {k: jnp.asarray(residuals[0][k])})
        assert np.asarray(jres[k]).tobytes() == restored[0][k].numpy().tobytes()


def test_q8_on_a_mesh_is_the_unsharded_codec():
    from repro_torch.optim.adamw import dequantize_q8, quantize_q8

    rng = np.random.default_rng(5)
    arrays = {"aligned": rng.standard_normal((4, 256)).astype(np.float32),   # 128 a rank
              "split": rng.standard_normal((4, 300)).astype(np.float32)}     # 150 a rank
    got = run_ranks(workers.q8_on_mesh, 2, args=(arrays,), timeout=120)
    for k, v in arrays.items():
        want = quantize_q8(torch.from_numpy(v))
        back = dequantize_q8(want, v.shape).numpy()
        for out in got:
            assert out[k]["q"].tobytes() == want["q"].numpy().tobytes(), k
            assert out[k]["scale"].tobytes() == want["scale"].numpy().tobytes(), k
            assert out[k]["back"].tobytes() == back.tobytes(), k
            assert out[k]["scale_whole_last"], k
