"""The yardstick's arithmetic against hand counts."""

import math

import pytest

from fsbench import flops, peaks, spec
import torch

from fsbench.trace import Trace, reduce

PHI3 = spec.cell(spec.load(), "phi3-medium-14b.prefill-2k").config


def test_flash_bound_is_chip_smokes():
    # B=4, S=T=2,048, H=40, KV=10, D=128: 4·D per (head, visible pair), bf16
    assert flops.flash_fwd_bound_s(PHI3, 4, 2048) * 1e3 == pytest.approx(0.1738, abs=5e-5)
    ops = 4 * 4 * 40 * 128 * (2048 * 2049 // 2)
    assert flops.flash_fwd_bound_s(PHI3, 4, 2048) == ops / peaks.BF16_FLOPS


def test_phi3_forward_flops_by_hand():
    d, f, v, layers = 5120, 17920, 32064, 40
    per_layer = d * d * 2 + 2 * d * 1280 + 3 * d * f
    n = layers * per_layer + d * v
    assert flops.matmul_params(PHI3) == n == 13_795_655_680
    attn = 2 * 256 * 40 * (2048 * 2049 // 2) * 4 * layers
    assert flops.forward_flops(PHI3, 4, 2048) == 2 * n * 8192 + attn
    assert flops.train_flops(PHI3, 4, 2048) == 3 * flops.forward_flops(PHI3, 4, 2048)


def test_moe_counts_active_experts_only():
    c = dict(hidden_size=2048, num_attention_heads=16, num_hidden_layers=2, vocab_size=100,
             kv_lora_rank=512, q_lora_rank=None, qk_nope_head_dim=128, qk_rope_head_dim=64,
             v_head_dim=128, intermediate_size=10944, moe_intermediate_size=1408,
             n_routed_experts=64, num_experts_per_tok=6, n_shared_experts=2,
             first_k_dense_replace=1)
    attn = 2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128 * 2048
    dense = 3 * 2048 * 10944
    moe = 2048 * 64 + 8 * 3 * 2048 * 1408
    assert flops.matmul_params(c) == 2 * attn + dense + moe + 2048 * 100
    assert flops.head_dims(c) == (192, 128)


class _Run:
    def __init__(self, trace, **result):
        self.config, self.trace, self.result, self.spans = PHI3, trace, result, {}


def _reader(name):
    return spec.metric_reader(name)


def test_roofline_mfu_and_idle_readers():
    # two flash calls of 0.5 ms each, one other kernel overlapping the first
    kernels = [("flash_fwd_tc<128>", 0.0, 0.0005), ("gemm", 0.0002, 0.0012),
               ("flash_fwd_tc<128>", 0.002, 0.0005)]
    tr = Trace(kernels, 0.004, [("get", 0.0025, 0.0040)])
    assert tr.busy_s == pytest.approx(0.0019)
    run = _Run(tr, batches=3, batch=4, seq=2048, window_s=2.0)
    bound = flops.flash_fwd_bound_s(PHI3, 4, 2048)
    assert _reader("flash_fwd_roofline.prefill")(run) == pytest.approx(100 * bound / 0.0005)
    assert _reader("device_idle.prefill")(run) == pytest.approx(100 * (1 - 0.0019 / 0.004))
    mfu = 100 * 3 * flops.forward_flops(PHI3, 4, 2048) / (2.0 * peaks.BF16_FLOPS)
    assert _reader("mfu.prefill")(run) == pytest.approx(mfu)
    assert tr.idle_gaps()[0] == ["get", pytest.approx(0.0015)]
    assert tr.device_ops()[0] == ["gemm", 0.0012]
    run.trace = Trace([("gemm", 0.0, 0.001)], 0.002, [])
    assert _reader("flash_fwd_roofline.prefill")(run) is None
    run.spans = {"get": [0.002, 0.004]}
    assert _reader("get_ms.prefill")(run) == pytest.approx(3.0)
    assert math.isfinite(_reader("device_idle.prefill")(run))


class _Event:
    def __init__(self, name, on_card, start, end):
        self._v = (name, on_card, start, end)

    def name(self):
        return self._v[0]

    def device_type(self):
        cuda = torch.autograd.DeviceType
        return cuda.CUDA if self._v[1] else cuda.CPU

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]


def test_reduce_reads_the_window_from_raw_events():
    """Kernels and spans clipped to the window span; the spans' own
    device-side ranges are no kernels."""
    ev = [("fsbench.window", False, 1000, 11000), ("fsbench.window", True, 1500, 10500),
          ("fsbench.get", False, 1000, 3000), ("fsbench.get", True, 2000, 2500),
          ("gemm", True, 500, 2000), ("flash_fwd_tc<128>", True, 4000, 9000),
          ("aten::mm", False, 3000, 3500), ("gemm", True, 10500, 12000)]
    prof = type("P", (), {})()
    prof.profiler = type("K", (), {})()
    prof.profiler.kineto_results = type("R", (), {"events": lambda self: [_Event(*e) for e in ev]})()
    tr = reduce(prof)
    assert tr.window_s == pytest.approx(1e-5)
    assert sorted(tr.kernels) == sorted([("gemm", 0.0, 1e-6), ("flash_fwd_tc<128>", 3e-6, 5e-6),
                                         ("gemm", 9.5e-6, 5e-7)])
    assert tr.spans == [("get", 0.0, 2e-6)]
    assert tr.busy_s == pytest.approx(6.5e-6)
    assert tr.idle_gaps(1) == [["no span", pytest.approx(2e-6)]]


@pytest.mark.parametrize("experts,k,cap", [(8, 2, 8), (64, 6, 16)])
def test_routing_looks_capacity_rule_is_the_ports(experts, k, cap):
    """``diag_routing.kept`` drops what the port's dispatch drops."""
    from repro_torch.models.moe import _dispatch_indices

    from fsbench.diag_routing import kept

    group, groups = 256, 3
    g = torch.Generator().manual_seed(experts)
    skew = torch.rand(experts, generator=g) ** 4  # a few experts overflow
    idx = torch.multinomial(skew.expand(groups * group, -1), k, generator=g)
    _, keep = _dispatch_indices(idx.reshape(groups, group, k), experts, cap)
    want = torch.where(keep.reshape(-1, k), idx, -1).sort(-1).values
    assert torch.equal(kept(idx, group, cap, experts), want)
    assert (want == -1).any() and (want != -1).any()
