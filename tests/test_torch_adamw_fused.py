"""AdamW's fused path (``kernels/adamw``, ``csrc/adamw.cu``) against the
optimizer's leaf-by-leaf passes (``optim/adamw.py``).

On the CPU: the kernel's plain version (``ref.adamw_update_ref``) gives
the leaf path's bits for every dtype pair, with and without decay, clip
and a schedule, over three steps; ``update`` sends a leaf to the kernel by
its structure alone (``ops.takes``: plain CUDA tensors, no DTensor, no
int8 blocks), and a card leaf the kernel cannot take (strided, float16,
bf16 moments) raises before anything is updated, checked on fake CUDA
tensors with the launchers stubbed; the kernels' wrappers refuse CPU
tensors; the C entries get every leaf's arguments in one call; the
counters ``adamw.fused`` and ``adamw.elems`` count what was routed, while
tracing only.  On the card (``gpu``): the kernel against the leaf
path bit for bit at the same clip scale, the sum of squares against
``torch.sum`` and from run to run, and the fused path's peak memory.  No
JAX: the ``gpu`` tests run on the card as they are."""

import contextlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch.core.monitoring import read_out  # noqa: E402
from repro_torch.kernels import native  # noqa: E402
from repro_torch.kernels.adamw import ops as fused_ops  # noqa: E402
from repro_torch.kernels.adamw.ref import adamw_sqnorm_ref, adamw_update_ref  # noqa: E402
from repro_torch.optim import adamw, schedules  # noqa: E402

BF16, F32 = torch.bfloat16, torch.float32
B1, B2, EPS = 0.9, 0.95, 1e-8
SHAPES = {"scalar": (), "seven": (7,), "block": (129,), "wide": (3, 300)}
CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def _fresh_records():
    read_out()
    yield
    read_out()


def _leaves(dtype, seed, scale=1.0, device="cpu", shapes=SHAPES):
    rng = np.random.default_rng(seed)
    return {n: torch.from_numpy(np.asarray(rng.standard_normal(s) * scale, dtype=np.float32))
            .to(device=device, dtype=dtype) for n, s in shapes.items()}


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def _same_bits(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(_bits(got), _bits(want)), (
        f"{what}: {int((_bits(got) != _bits(want)).sum())} elements differ")


def _prologue(grads, count, lr, clip):
    """The update's scalars as ``update`` computes them over the leaf path's
    sum of squares."""
    scale = None
    if clip is not None:
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    step = lr(count) if callable(lr) else lr
    return scale, 1.0 - B1 ** count.float(), 1.0 - B2 ** count.float(), step


@pytest.mark.parametrize("schedule", ["float", "warmup_cosine"])
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
@pytest.mark.parametrize("p_dtype,g_dtype", [(BF16, BF16), (BF16, F32), (F32, BF16), (F32, F32)],
                         ids=["bf16-bf16", "bf16-f32", "f32-bf16", "f32-f32"])
def test_ref_is_the_leaf_path_bit_for_bit(p_dtype, g_dtype, weight_decay, clip, schedule):
    lr = 3e-3 if schedule == "float" else schedules.warmup_cosine(3e-3, 2, 10)
    opt = adamw.adamw(lr, b1=B1, b2=B2, eps=EPS, weight_decay=weight_decay, grad_clip=clip)
    params = _leaves(p_dtype, seed=0)
    mine = {n: p.clone() for n, p in params.items()}
    m = {n: torch.zeros(p.shape) for n, p in params.items()}
    v = {n: torch.zeros(p.shape) for n, p in params.items()}
    state = opt.init(params)
    for step in range(3):
        grads = _leaves(g_dtype, seed=step + 1, scale=5.0)  # the clip engages
        scale, bc1, bc2, lr_t = _prologue(grads, torch.tensor(step + 1, dtype=torch.int32),
                                          lr, clip)
        for n, g in grads.items():
            adamw_update_ref(mine[n], g, m[n], v[n], scale=scale, bc1=bc1, bc2=bc2, step=lr_t,
                             b1=B1, b2=B2, eps=EPS, weight_decay=weight_decay)
        params, state = opt.update(grads, state, params)
        for n in params:
            _same_bits(mine[n], params[n], f"step {step} p {n}")
            _same_bits(m[n], state["m"][n], f"step {step} m {n}")
            _same_bits(v[n], state["v"][n], f"step {step} v {n}")


@pytest.mark.parametrize("dtype", [BF16, F32])
def test_sqnorm_on_the_cpu_is_the_float64_sum_of_float32_squares(dtype):
    grads = list(_leaves(dtype, seed=3, scale=2.0).values())
    got = adamw_sqnorm_ref(grads)
    want = sum(float(np.sum(np.square(g.float().numpy()).astype(np.float64))) for g in grads)
    assert got.dtype == F32 and got.shape == ()
    assert float(got) == float(np.float32(want))


def test_kernels_refuse_cpu_tensors():
    """No plain fallback inside the wrappers: the optimizer keeps CPU
    leaves on its own passes, and the kernels take card tensors only."""
    p, g, m, v = (torch.zeros(4, dtype=d) for d in (BF16, BF16, F32, F32))
    scalars = dict(scale=None, bc1=torch.tensor(0.1), bc2=torch.tensor(0.05), step=1e-3,
                   b1=B1, b2=B2, eps=EPS, weight_decay=0.0)
    assert not fused_ops.takes(p, g, m, v)
    with pytest.raises(ValueError, match="runs on cuda"):
        fused_ops.update([(p, g, m, v)], **scalars)
    with pytest.raises(ValueError, match="runs on cuda"):
        fused_ops.sqnorm([g])


def test_sqnorm_blocks():
    assert [fused_ops.sqnorm_blocks(n) for n in (0, 1, 8192, 8193, 1 << 40)] == [0, 1, 1, 2, 1024]


class _Launches:
    """The launchers, stubbed: each records the weights (or gradients) it
    was handed, by name; so does the leaf path (whose ``copy_`` needs a
    real card under ``FakeTensorMode``)."""

    def __init__(self, monkeypatch, named: dict):
        self.names = {id(t): n for n, t in named.items()}
        self.update, self.sqnorm, self.leafwise = [], [], []
        monkeypatch.setattr(fused_ops, "_launch_update", self._update)
        monkeypatch.setattr(fused_ops, "_launch_sqnorm", self._sqnorm)
        monkeypatch.setattr(adamw, "_update_leaf", self._leaf)

    def _leaf(self, p, g, m, v, **kw):
        assert m.dtype == v.dtype == F32 and m.shape == v.shape == p.shape
        self.leafwise.append(self.names[id(p)])

    def _update(self, leaves, scale, bc1, bc2, step, **hyper):
        assert all(s.dtype == F32 and s.dim() == 0 and s.is_cuda for s in (scale, bc1, bc2, step))
        assert hyper == dict(b1=B1, b2=B2, eps=EPS, weight_decay=0.01)
        self.update.append([self.names[id(leaf[0])] for leaf in leaves])

    def _sqnorm(self, grads, blocks, partials, out):
        assert partials.dtype == torch.float64 and partials.numel() == max(sum(blocks), 1)
        self.sqnorm.append(len(grads))


def _card_params():
    """Fake CUDA weights of the kinds the kernel takes: bf16 and a float32
    router."""
    dev = torch.device("cuda")
    return {
        "card": torch.zeros(16, 8, dtype=BF16, device=dev),
        "router": torch.zeros(8, 4, dtype=F32, device=dev),
    }


def _odd_card_params():
    """Fake CUDA weights the kernel cannot take: strided, and float16."""
    dev = torch.device("cuda")
    return {
        "strided": torch.zeros(8, 6, dtype=BF16, device=dev).t(),
        "half": torch.zeros(5, dtype=torch.float16, device=dev),
    }


def _optimizer(**kw):
    return adamw.adamw(schedules.warmup_cosine(1e-3, 2, 10), b1=B1, b2=B2, eps=EPS,
                       weight_decay=0.01, **kw)


def test_routing_sends_plain_contiguous_card_leaves_to_the_kernel(monkeypatch):
    with FakeTensorMode():
        params = _card_params()
        grads = {n: torch.ones_like(p) for n, p in params.items()}
        launches = _Launches(monkeypatch, params)
        opt = _optimizer()
        opt.update(grads, opt.init(params), params)
    assert launches.update == [["card", "router"]]
    assert launches.sqnorm == [2]
    assert launches.leafwise == []


@pytest.mark.parametrize("clip", [1.0, None], ids=["clip", "no-clip"])
@pytest.mark.parametrize("odd,error,match", [
    ("strided weight", ValueError, "contiguous"),
    ("strided gradient", ValueError, "contiguous"),
    ("float16", TypeError, "float16"),
    ("bf16 moments", TypeError, "bfloat16"),
])
def test_routing_raises_on_a_card_leaf_the_kernel_cannot_take(monkeypatch, clip, odd, error,
                                                               match):
    """A plain card leaf goes to the kernel by its structure: one that is
    strided or of a dtype the kernel lacks raises there, before any leaf or
    the step count is updated; it never falls back to the leaf path."""
    with FakeTensorMode():
        params = _card_params()
        dev = params["card"].device
        if odd == "strided weight":
            params["odd"] = _odd_card_params()["strided"]
        elif odd == "float16":
            params["odd"] = _odd_card_params()["half"]
        else:
            params["odd"] = torch.zeros(8, 6, dtype=BF16, device=dev)
        grads = {n: torch.ones_like(p) for n, p in params.items()}
        if odd == "strided gradient":
            grads["odd"] = torch.ones(6, 8, dtype=BF16, device=dev).t()
        launches = _Launches(monkeypatch, params)
        opt = adamw.adamw(1e-3, weight_decay=0.01, grad_clip=clip)
        state = opt.init(params)
        if odd == "bf16 moments":
            state["m"]["odd"] = state["m"]["odd"].to(BF16)
        count = state["count"]
        with pytest.raises(error, match=match):
            opt.update(grads, state, params)
    # no update launched and no leaf stepped (the clip's sum of squares,
    # which writes nothing of the state, may have run)
    assert launches.update == launches.leafwise == []
    assert state["count"] is count


def test_routing_leaves_int8_moments_to_the_leaf_path(monkeypatch):
    # the block codec's ``torch.where`` needs a real card under FakeTensorMode:
    # blocks of the right types stand in for it
    monkeypatch.setattr(adamw, "quantize_q8", lambda x: {
        "q": torch.zeros(x.shape, dtype=torch.int8, device=x.device),
        "scale": torch.zeros((*x.shape[:-1], 1), device=x.device)})
    monkeypatch.setattr(adamw, "dequantize_q8", lambda qs, shape: torch.zeros(
        shape, device=qs["q"].device))
    with FakeTensorMode():
        params = {**_card_params(), **_odd_card_params()}
        grads = {n: torch.ones_like(p) for n, p in params.items()}
        launches = _Launches(monkeypatch, params)
        opt = _optimizer(quantize_moments=True)
        opt.update(grads, opt.init(params), params)
    assert launches.update == [] and launches.sqnorm == []
    assert launches.leafwise == list(params)


def test_routing_leaves_the_cpu_to_the_leaf_path(monkeypatch):
    params = _leaves(BF16, seed=0)
    launches = _Launches(monkeypatch, params)
    opt = _optimizer()
    opt.update(_leaves(BF16, seed=1), opt.init(params), params)
    assert launches.update == [] and launches.sqnorm == []
    assert launches.leafwise == list(params)


def test_routing_leaves_dtensors_to_the_leaf_path():
    """A DTensor weight, its gradient and moments go to the leaf path; the
    same tensors as plain ones go to the kernel."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        mesh = DeviceMesh("cuda", torch.tensor([0, 1]), _init_backend=False)
        with FakeTensorMode():
            dev = torch.device("cuda", 0)
            loc = [torch.zeros(4, 8, dtype=d, device=dev) for d in (BF16, BF16, F32, F32)]
            dist_leaf = [DTensor.from_local(t, mesh, [Shard(0)], run_check=False) for t in loc]
            assert all(t.device == dev and t.is_contiguous() for t in dist_leaf)
            assert fused_ops.takes(*loc)
            assert not fused_ops.takes(*dist_leaf)
            assert not fused_ops.takes(loc[0], dist_leaf[1], loc[2], loc[3])
    finally:
        dist.destroy_process_group()


def test_routing_checks_each_condition(monkeypatch):
    """``takes`` looks at structure alone (plain tensors, all on a card);
    ``update`` refuses each leaf or scalar the kernel cannot take."""
    launched = []
    monkeypatch.setattr(fused_ops, "_launch_update", lambda leaves, *a, **kw: launched.append(
        len(leaves)))
    with FakeTensorMode():
        dev = torch.device("cuda", 0)

        def leaf(p=BF16, g=BF16, m=F32, v=F32, shape=(4, 8)):
            return [torch.zeros(shape, dtype=d, device=dev) for d in (p, g, m, v)]

        def update(leaf_, scalar_dev=dev):
            bc1, bc2 = (torch.zeros((), device=scalar_dev) for _ in range(2))
            fused_ops.update([tuple(leaf_)], scale=None, bc1=bc1, bc2=bc2, step=1e-3, b1=B1,
                             b2=B2, eps=EPS, weight_decay=0.0)

        for ok in (leaf(), leaf(F32, F32), leaf(BF16, F32), leaf(shape=())):
            assert fused_ops.takes(*ok)
            update(ok)
        assert launched == [1] * 4
        # structure only: a dtype or a layout the kernel lacks is update's to refuse
        assert fused_ops.takes(*leaf(m=BF16)) and fused_ops.takes(*leaf(g=torch.float16))
        with pytest.raises(TypeError, match="bfloat16"):
            update(leaf(m=BF16))
        with pytest.raises(TypeError, match="float16"):
            update(leaf(g=torch.float16))
        bad = leaf()
        bad[3] = torch.zeros(8, 4, device=dev).t()
        assert fused_ops.takes(*bad)
        with pytest.raises(ValueError, match="contiguous"):
            update(bad)
        bad = leaf()
        bad[1] = torch.zeros(32, dtype=BF16, device=dev)
        with pytest.raises(ValueError, match="shapes"):
            update(bad)
        with pytest.raises(ValueError, match="scalars"):
            update(leaf(), torch.device("cuda", 1))
        blocks = {"q": torch.zeros(4, 8, dtype=torch.int8, device=dev),
                  "scale": torch.zeros(4, 1, device=dev)}
        assert not fused_ops.takes(*leaf()[:2], blocks, blocks)
        assert launched == [1] * 4
    cpu = [torch.zeros(4, dtype=d) for d in (BF16, BF16, F32, F32)]
    assert not fused_ops.takes(*cpu)


def test_counters_count_what_was_routed_only_while_tracing(monkeypatch):
    with FakeTensorMode():
        params = _card_params()
        grads = {n: torch.ones_like(p) for n, p in params.items()}
        _Launches(monkeypatch, params)
        opt = _optimizer()
        state = opt.init(params)
        with torch.profiler.profile(activities=CPU):
            opt.update(grads, state, params)
            opt.update(grads, state, params)
        traced = read_out()["counters"]
        opt.update(grads, state, params)
        untraced = read_out()["counters"]
    assert traced == {"adamw.fused": 2 * (128 + 32), "adamw.elems": 2 * (128 + 32)}
    assert untraced == {}


def test_counters_on_the_cpu_count_every_parameter_and_no_kernel():
    params = _leaves(BF16, seed=0)
    opt = _optimizer()
    with torch.profiler.profile(activities=CPU):
        opt.update(_leaves(BF16, seed=1), opt.init(params), params)
    n = sum(p.numel() for p in params.values())
    assert read_out()["counters"] == {"adamw.elems": n}


def _fake_library(monkeypatch, calls):
    """The C entries as recorders of their arguments, on CPU tensors."""
    lib = type("Lib", (), {name: staticmethod(lambda *a, name=name: calls.append((name, a))
                                               or 0)
                           for name in ("adamw_update", "adamw_sqnorm")})
    monkeypatch.setattr(fused_ops.native, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


def test_update_entry_takes_every_leaf_in_one_call(monkeypatch):
    """One call of the C entry for all the leaves: their pointers, sizes and
    dtype codes, the scalars' addresses (a constant step by value), the
    float constants; an empty leaf launches nothing and is not counted."""
    assert len(native._SIGNATURES["adamw_update"]) == 21
    calls = []
    _fake_library(monkeypatch, calls)
    leaves = [tuple(torch.zeros(n, dtype=d) for d in dtypes) for n, dtypes in
              ((15, (BF16, F32, F32, F32)), (0, (F32, BF16, F32, F32)))]
    scale, bc1, bc2 = (torch.tensor(x) for x in (0.5, 0.1, 0.0975))
    before = fused_ops.counter.launches
    fused_ops._launch_update(leaves, scale, bc1, bc2, 0.25, b1=B1, b2=B2, eps=EPS,
                             weight_decay=0.0)
    ((name, args),) = calls
    (p, g, m, v, numels, p_codes, g_codes, n, scale_p, bc1_p, bc2_p, step_p, step,
     b1, c1, b2, c2, eps, wd, decay, stream) = args
    assert name == "adamw_update" and n == 2 and stream == 0
    for ptrs, k in ((p, 0), (g, 1), (m, 2), (v, 3)):
        assert list(ptrs) == [leaf[k].data_ptr() for leaf in leaves]
    assert (list(numels), list(p_codes), list(g_codes)) == ([15, 0], [1, 0], [0, 1])
    assert (scale_p, bc1_p, bc2_p) == (scale.data_ptr(), bc1.data_ptr(), bc2.data_ptr())
    assert step_p is None and step == 0.25
    assert (b1, c1, b2, c2, eps, wd, decay) == (B1, 1 - B1, B2, 1 - B2, EPS, 0.0, 0)
    assert fused_ops.counter.launches == before + 1


def test_sqnorm_entry_takes_every_leaf_in_one_call(monkeypatch):
    assert len(native._SIGNATURES["adamw_sqnorm"]) == 8
    calls = []
    _fake_library(monkeypatch, calls)
    grads = [torch.zeros(20_000, dtype=BF16), torch.zeros(3, dtype=F32)]
    blocks = [fused_ops.sqnorm_blocks(g.numel()) for g in grads]
    partials = torch.empty(sum(blocks), dtype=torch.float64)
    out = torch.empty(())
    before = fused_ops.sqnorm_counter.launches
    fused_ops._launch_sqnorm(grads, blocks, partials, out)
    ((name, (ptrs, numels, codes, blks, n, part_p, out_p, stream)),) = calls
    assert name == "adamw_sqnorm" and n == 2 and stream == 0 and blocks == [3, 1]
    assert list(ptrs) == [g.data_ptr() for g in grads] and list(numels) == [20_000, 3]
    assert list(codes) == [1, 0] and list(blks) == blocks
    assert (part_p, out_p) == (partials.data_ptr(), out.data_ptr())
    assert fused_ops.sqnorm_counter.launches == before + 1


# -- on the card ---------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the fused AdamW kernels")
    return torch.device("cuda")


def _card_leaves(dev, seed):
    """Weights and gradients the kernel meets: a size that is no multiple of
    the vector width, a 0-d leaf, weights and gradients at odd storage
    offsets, float32 router-like leaves, and each dtype pair."""
    gen = torch.Generator(device=dev).manual_seed(seed)

    def randn(shape, dtype, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    p = {"odd": randn((1_000_003,), BF16), "scalar": randn((), BF16),
         "offset": randn((70_001,), BF16)[1:], "router": randn((2048, 64), F32),
         "bf16_f32": randn((4099,), BF16), "f32_bf16": randn((3, 1001), F32),
         "wide": randn((4096, 2048), BF16)}
    g_dtype = {"router": F32, "bf16_f32": F32}
    grads = []
    for step in range(3):
        g = {n: randn(x.shape, g_dtype.get(n, BF16), 0.01) for n, x in p.items()}
        g["offset"] = randn((70_003,), BF16, 0.01)[3:]
        grads.append(g)
    return p, grads


@pytest.mark.gpu
@pytest.mark.parametrize("clip", [1.0, None])
@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_kernel_is_the_leaf_path_bit_for_bit_on_card(cuda_device, monkeypatch, clip,
                                                     weight_decay):
    """Three steps through the kernel and through the leaf path, with the
    clip's sum of squares taken the leaf path's way on both (the same clip
    scale): every weight and moment the same bits after each step."""
    monkeypatch.setattr(fused_ops, "sqnorm", lambda gs: sum(
        torch.sum(torch.square(g.float())) for g in gs))
    runs = []
    for route in ("kernel", "leaf"):
        if route == "leaf":
            monkeypatch.setattr(fused_ops, "takes", lambda *a: False)
        params, grads = _card_leaves(cuda_device, seed=7)
        assert params["offset"].storage_offset() == 1 and grads[0]["offset"].storage_offset() == 3
        opt = adamw.adamw(schedules.warmup_cosine(1e-2, 1, 10), weight_decay=weight_decay,
                          grad_clip=clip)
        state = opt.init(params)
        before = fused_ops.counter.launches
        snaps = []
        for g in grads:
            params, state = opt.update(g, state, params)
            snaps.append({n: (params[n].clone(), state["m"][n].clone(), state["v"][n].clone())
                          for n in params})
        torch.cuda.synchronize()
        launched = fused_ops.counter.launches - before
        assert launched == (3 * len(params) if route == "kernel" else 0)
        runs.append(snaps)
    for step, (fused, leaf) in enumerate(zip(*runs)):
        for n in fused:
            for what, got, want in zip("pmv", fused[n], leaf[n]):
                _same_bits(got, want, f"step {step} {what} {n}")


@pytest.mark.gpu
def test_sqnorm_on_card_matches_torch_sum_and_repeats(cuda_device):
    params, grads = _card_leaves(cuda_device, seed=11)
    leaves = list(grads[0].values())
    for g in leaves + [leaves]:
        gs = g if isinstance(g, list) else [g]
        want = float(sum(torch.sum(g_.float() ** 2) for g_ in gs))
        before = fused_ops.sqnorm_counter.launches
        got = fused_ops.sqnorm(gs)
        again = fused_ops.sqnorm(gs)
        assert fused_ops.sqnorm_counter.launches == before + 2
        assert got.dtype == F32 and got.shape == () and got.is_cuda
        assert abs(float(got) - want) <= 1e-6 * want, (float(got), want)
        _same_bits(got, again, "two runs")


@pytest.mark.gpu
def test_fused_update_allocates_at_most_a_megabyte(cuda_device):
    """On the fused path an update allocates the norm's partial sums and a
    few 0-d scalars: at most 1 MB above the weights, gradients and moments,
    whatever the largest leaf."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(4096, 2048)] * 8 + [(2048,)] * 4
    params = {f"w{i}": torch.randn(s, generator=gen, device=cuda_device).bfloat16()
              for i, s in enumerate(shapes)}
    grads = {n: torch.randn(p.shape, generator=gen, device=cuda_device).bfloat16()
             for n, p in params.items()}
    opt = adamw.adamw(1e-3, weight_decay=0.01)
    state = opt.init(params)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = fused_ops.counter.launches
    opt.update(grads, state, params)
    torch.cuda.synchronize()
    assert fused_ops.counter.launches - before == len(params)
    assert torch.cuda.max_memory_allocated() - base <= 1 << 20


@pytest.mark.gpu
@pytest.mark.parametrize("odd", ["strided", "float16"])
def test_a_card_leaf_the_kernel_cannot_take_raises_on_card(cuda_device, odd):
    """A strided or float16 weight on the card raises in the update, before
    its weight or the step count moves: no fallback to the leaf path."""
    w = (torch.ones(64, 48, dtype=BF16, device=cuda_device).t() if odd == "strided"
         else torch.ones(64, dtype=torch.float16, device=cuda_device))
    opt = adamw.adamw(1e-3, weight_decay=0.01)
    params = {"w": w}
    state = opt.init(params)
    with pytest.raises((TypeError, ValueError)):
        opt.update({"w": torch.ones_like(w)}, state, params)
    torch.cuda.synchronize()
    assert bool((w == 1).all()) and int(state["count"]) == 0
