"""The operation and byte counts against the published shapes and the
kernel bounds the port's PERF.md table uses."""
import json

import pytest

from portbench import counts
from portbench.spec import PACKAGE


def _cfg(dtype="f32"):
    with open(PACKAGE / "configs" / f"dt4ir-csmri-{dtype}.json") as f:
        return json.load(f)


def test_unet_is_9_68_gflop_a_slice():
    assert counts.unet_flops(_cfg()) == pytest.approx(9.684e9, rel=1e-3)


@pytest.mark.parametrize("block,ms", [("inc", 0.238), ("up4", 0.577)])
def test_k1_bounds_at_b63_match_the_kernel_table(block, ms):
    flops = 63 * counts.unet_block_flops(_cfg())[block]
    assert 1e3 * flops / counts.PEAK_FLOPS["float32"] == pytest.approx(
        ms, abs=5e-4)


def test_unet_bound_is_set_by_ops_at_both_dtypes():
    for dtype, ms in (("f32", 3.70), ("bf16", 0.617)):
        cfg = _cfg(dtype)
        t, by = counts.bound_s(63 * counts.unet_flops(cfg),
                               counts.unet_bytes(cfg, 63), cfg["dtype"])
        assert by == "ops" and 1e3 * t == pytest.approx(ms, abs=0.01)
        assert counts.unet_bound_s(cfg, 63) == t


def test_unet_params_match_the_weights_made():
    import torch
    from portbench.weights import unet_state_dict
    cfg = _cfg()
    sd = unet_state_dict(cfg, torch.Generator().manual_seed(0), "cpu")
    assert counts.unet_params(cfg) == sum(t.numel() for t in sd.values())


def test_slice_flops_are_30_unet_forwards_and_the_policy():
    cfg = _cfg()
    per_slice = counts.slice_flops(cfg)
    assert per_slice == pytest.approx(292.8e9, rel=2e-3)
    policy = per_slice - 30 * counts.unet_flops(cfg)
    # 60 policy forwards at 18 tokens (and one at 12) plus 31 encodings.
    assert 59 * counts.dt_stack_flops(cfg, 18) < policy \
        < 62 * counts.dt_stack_flops(cfg, 18) + 31 * \
        counts.state_encoder_flops(cfg)
