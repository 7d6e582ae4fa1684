"""DRUNet as the benchmark's second prior (``priors/drunet.py``) and its
cell ``eval_b63_drunet_bf16``: the prior file's functions and counts, its
reference against the port's plain forward, and ``correct`` coming out
false when the timed path is broken, on the CPU at a cut image side, and
on the card at the cell's own size.

    python -m pytest -p no:cacheprovider portbench/tests/test_bench_drunet.py
    python -m pytest -m cuda -p no:cacheprovider \\
        portbench/tests/test_bench_drunet.py
"""
import json
import time

import pytest
import torch

from portbench import counts
from portbench.run import execute
from portbench.spec import PRIOR_FUNCTIONS, load_cell, load_prior
from portbench.tests.test_bench_faults import altered_answer
from portbench.weights import make_weights

CELL = "eval_b63_drunet_bf16"
SMALL = {"nc": [8, 16, 32, 64], "nb": 2, "image_size": 32,
         "in_channels": 2, "out_channels": 1, "dtype": "float32"}


def test_the_cell_loads_the_drunet_prior_file():
    cell = load_cell(CELL)
    assert cell.prior.__file__ == load_prior("drunet").__file__
    assert all(callable(getattr(cell.prior, f)) for f in PRIOR_FUNCTIONS)
    assert cell.config["prior"] == "drunet" and cell.chips == 1
    assert [m.name for m in cell.end_to_end] == ["slices_per_s.bf16", "setup_s"]
    assert [m.name for m in cell.per_layer] == [
        "unet_roofline.bf16", "mfu.bf16", "device.idle_share.bf16",
        "device.idle_share_in_steps.bf16", "drunet_conv_roofline.drunet",
        "models.drunet_issue_ms.drunet"]


def test_counts_and_size_are_the_published_ones():
    """69.3 GFLOP a 128^2 call (68.5 of them in the forward convs, 67.7 in
    the 58 3x3 ones) and 32,638,656 parameters, from DPIR's drunet_gray
    shapes."""
    cfg = load_cell(CELL).config
    prior = load_prior("drunet")
    assert prior.flops(cfg) == 69312970752.0
    assert prior.fprop_flops(cfg) == 67702358016.0 + 3 * 2 * 134217728
    sd = prior.state_dict(cfg, torch.Generator().manual_seed(0), "cpu")
    assert len(sd) == 64
    assert sum(t.numel() for t in sd.values()) == 32638656
    # Bound by the operations at B = 63: 4.41 ms at 989 TFLOP/s.
    assert counts.prior_bound_s(cfg, 63, prior) == pytest.approx(
        63 * 69312970752.0 / 989e12, rel=1e-12)
    assert prior.bytes(cfg, 63) / counts.PEAK_BYTES_PER_S \
        < counts.prior_bound_s(cfg, 63, prior)


@pytest.mark.parametrize("seed", [0, 3700000001])
def test_the_reference_is_the_ports_plain_forward(seed):
    """In float32 on the CPU, at small widths: the harness's copy equals
    ``utils/torch_reference.py:torch_drunet_denoise``; in bfloat16 it
    rounds, and stays near."""
    from dt4image_restoration_tpu_torch.utils.torch_reference import \
        torch_drunet_denoise
    prior = load_prior("drunet")
    sd = prior.state_dict(SMALL, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(3, 1, 32, 32, generator=g)
    sigma = torch.tensor([0.02, 0.1, 0.25])
    want = torch_drunet_denoise(sd, img, sigma)
    torch.testing.assert_close(prior.reference(sd, img, sigma, "float32"),
                               want, rtol=0, atol=1e-6)
    low = prior.reference(sd, img, sigma, "bfloat16")
    assert 0 < float((low - want).abs().max()) < 0.05


def test_the_port_builds_from_the_prior_file():
    from dt4image_restoration_tpu_torch.models import DRUNetDenoiser
    cfg = dict(SMALL, dtype="bfloat16")
    prior = load_prior("drunet")
    sd = prior.state_dict(cfg, torch.Generator().manual_seed(1), "cpu")
    den = prior.system(cfg, sd, "cpu")
    assert isinstance(den, DRUNetDenoiser) and not den.training
    assert den.net.dtype == torch.bfloat16
    img, sigma = torch.rand(2, 1, 32, 32), torch.tensor([0.05, 0.2])
    with torch.no_grad():
        gap = den(img, sigma) - prior.reference(sd, img, sigma, "float32")
    assert float(gap.abs().max()) < 0.05


def body_returns_input(monkeypatch):
    """DRUNet's body (the four 512-channel ResBlocks) returns its input."""
    from dt4image_restoration_tpu_torch.models import drunet
    real = drunet.DRUNetDenoiser.__init__

    def init(self, *args, **kw):
        real(self, *args, **kw)
        self.net.m_body.register_forward_hook(lambda m, a, out: a[0])
    monkeypatch.setattr(drunet.DRUNetDenoiser, "__init__", init)


@pytest.mark.parametrize("fault", [None, altered_answer, body_returns_input],
                         ids=["sound", "altered_answer",
                              "body_returns_input"])
def test_a_fault_makes_the_drunet_run_incorrect(fault, tiny_cell,
                                                monkeypatch):
    """The tiny cell at the published widths on 64^2 slices (the image
    side cut in this test alone, for the CPU's time): the random prior's
    deep path is large enough that the body left out shows."""
    cell = tiny_cell(CELL)
    cell.config["image_size"] = 64
    cell.traffic["check_sample"] = 64      # every answer of the window
    if fault is not None:
        fault(monkeypatch)
    res = execute(cell, 4242, 0.1, False, "cpu", time.perf_counter())
    assert res["correct"] is (fault is None), res["checks"]


def test_drunet_weights_follow_the_policys_draws():
    """The policy's draws come first and equal the U-Net cells'."""
    drunet_cfg = load_cell(CELL).config
    unet_cell = load_cell("eval_b63_bf16")
    dt_a, sd = make_weights(drunet_cfg, 9, "cpu", load_prior("drunet"))
    dt_b, _ = make_weights(unet_cell.config, 9, "cpu", unet_cell.prior)
    assert all(torch.equal(dt_a[k], dt_b[k]) for k in dt_b)
    assert set(sd) == set(load_prior("drunet").state_dict(
        drunet_cfg, torch.Generator().manual_seed(9), "cpu"))


@pytest.mark.cuda
def test_the_control_fails_where_the_port_passes_on_card(card):
    cell = load_cell(CELL)
    res = execute(cell, 77, 1.0, False, card, time.perf_counter(),
                  control=cell.config["control_precision"])
    assert res["correct"], res["checks"]
    from portbench import correct
    ok, checks = correct.judge(res["_control_numbers"], cell.limits)
    assert not ok, checks


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3800000001, 3800000002])
def test_one_altered_answer_of_63_fails_on_card(seed, card, monkeypatch):
    """One answer of a 63-slice call shifted by 0.25 where it is produced,
    in a window of that one call, all 63 answers compared."""
    cell = load_cell(CELL)
    altered_answer(monkeypatch)
    res = execute(cell, seed, 0.01, False, card, time.perf_counter())
    numbers = res["_numbers"]
    print(json.dumps({"seed": seed, "attempted": res["attempted"],
                      "numbers": numbers}))
    assert res["attempted"] == 63 and not res["correct"]
    limit = cell.limits["image_rms_ratio_max"]["limit"]
    assert numbers["image_rms_ratio_max"] > limit, res["checks"]
