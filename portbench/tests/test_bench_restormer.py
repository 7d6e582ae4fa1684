"""Restormer as the benchmark's third prior (``priors/restormer.py``) and its
cell ``eval_b63_restormer_bf16``: the prior file's functions and counts
against the published ones, its reference against the port's plain
forward and the port itself, the random prior's first-step correction,
and ``correct`` coming out false when the timed path is broken, on the
CPU at a cut image side, and on the card at the cell's own size.

    python -m pytest -p no:cacheprovider \\
        portbench/tests/test_bench_restormer.py
    python -m pytest -m cuda -p no:cacheprovider \\
        portbench/tests/test_bench_restormer.py
"""
import json
import time

import numpy as np
import pytest
import torch

from portbench import counts
from portbench.records import make_pool
from portbench.run import execute
from portbench.spec import PRIOR_FUNCTIONS, load_cell, load_prior
from portbench.tests.test_bench_faults import altered_answer
from portbench.weights import make_weights

CELL = "eval_b63_restormer_bf16"
SMALL = {"dim": 16, "num_blocks": [1, 1, 1, 2], "num_refinement_blocks": 1,
         "heads": [1, 2, 2, 4], "ffn_expansion_factor": 2.66,
         "bias": False, "LayerNorm_type": "BiasFree", "image_size": 32,
         "in_channels": 2, "out_channels": 1, "dtype": "float32"}


def test_the_cell_loads_the_restormer_prior_file():
    cell = load_cell(CELL)
    assert cell.prior.__file__ == load_prior("restormer").__file__
    assert all(callable(getattr(cell.prior, f)) for f in PRIOR_FUNCTIONS)
    assert cell.config["prior"] == "restormer" and cell.chips == 1
    assert cell.config["reduced"] == []
    assert [m.name for m in cell.end_to_end] == ["slices_per_s.bf16",
                                                 "setup_s"]
    assert [m.name for m in cell.per_layer] == [
        "unet_roofline.bf16", "mfu.bf16", "device.idle_share.bf16",
        "device.idle_share_in_steps.bf16",
        "models.restormer_issue_ms.restormer",
        "restormer_gram_roofline.restormer"]


def test_counts_and_size_are_the_published_ones():
    """At the published 256^2 with 3 channels in and out, the convs alone
    (the attention's two products left out) are the paper's 140.99 G
    multiply-adds and the parameters 26.11 M; at 128^2 with 2 in and 1
    out, 77.4 GFLOP a slice, about 108 GB a B=63 call in bfloat16, so the
    call is bound by its bytes."""
    prior = load_prior("restormer")
    cfg = dict(load_cell(CELL).config)
    published = dict(cfg, image_size=256, in_channels=3, out_channels=3)
    macs = (prior.flops(published) - prior.attention_flops(published)) / 2
    assert macs == pytest.approx(140.99e9, abs=0.01e9)
    sd = prior.state_dict(published, torch.Generator().manual_seed(0),
                          "cpu")
    assert sum(t.numel() for t in sd.values()) == pytest.approx(26.11e6,
                                                                abs=5e3)
    assert prior.flops(cfg) == pytest.approx(77.37e9, abs=0.01e9)
    assert prior.bytes(cfg, 63) == pytest.approx(107.9e9, abs=0.1e9)
    bound = counts.prior_bound_s(cfg, 63, prior)
    assert bound == pytest.approx(prior.bytes(cfg, 63) / 3.35e12)
    assert 63 * prior.flops(cfg) / 989e12 < bound / 6
    # K7: q and k of every block read once over the bandwidth.
    assert prior.gram_bound_s(cfg, 63) == pytest.approx(1.8046e-3,
                                                        rel=1e-3)


def test_the_weights_load_into_the_port_strictly():
    """The prior file's state dict is the port's layout key for key."""
    from dt4image_restoration_tpu_torch.models import RestormerDenoiser
    cfg = load_cell(CELL).config
    sd = load_prior("restormer").state_dict(
        cfg, torch.Generator().manual_seed(2), "cpu")
    want = RestormerDenoiser().state_dict()
    assert {"net." + k for k in sd} == set(want)
    assert all(sd[k.removeprefix("net.")].shape == v.shape
               for k, v in want.items())


@pytest.mark.parametrize("seed", [0, 3700000001])
def test_the_reference_is_the_ports_plain_forward(seed):
    """In float32 on the CPU, at small widths: the harness's copy equals
    ``utils/torch_reference.py:torch_restormer_denoise`` to 1e-5 (the same
    operations, whose library kernels may sum in another order with
    another number of threads); in bfloat16 it rounds, and stays near."""
    from dt4image_restoration_tpu_torch.utils.torch_reference import \
        torch_restormer_denoise
    prior = load_prior("restormer")
    sd = prior.state_dict(SMALL, torch.Generator().manual_seed(seed), "cpu")
    g = torch.Generator().manual_seed(seed)
    img = torch.rand(3, 1, 32, 32, generator=g)
    sigma = torch.tensor([0.02, 0.1, 0.25])
    want = torch_restormer_denoise(sd, img, sigma)
    torch.testing.assert_close(prior.reference(sd, img, sigma, "float32"),
                               want, rtol=0, atol=1e-5)
    low = prior.reference(sd, img, sigma, "bfloat16")
    assert 0 < float((low - want).abs().max()) < 0.05


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_port_builds_from_the_prior_file(dtype):
    from dt4image_restoration_tpu_torch.models import RestormerDenoiser
    cfg = dict(SMALL, dtype=dtype)
    prior = load_prior("restormer")
    sd = prior.state_dict(cfg, torch.Generator().manual_seed(1), "cpu")
    den = prior.system(cfg, sd, "cpu")
    assert isinstance(den, RestormerDenoiser) and not den.training
    assert den.net.dtype == getattr(torch, dtype)
    img, sigma = torch.rand(2, 1, 32, 32), torch.tensor([0.05, 0.2])
    with torch.no_grad():
        gap = den(img, sigma) - prior.reference(sd, img, sigma, "float32")
    assert float(gap.abs().max()) < (1e-5 if dtype == "float32" else 0.05)


def test_the_random_prior_corrects_a_modest_share_at_the_first_step():
    """At the published widths on the cell's first-step inputs (zero-filled
    128^2 slices, sigma 0.1): the output conv's correction is 10-20 % of
    the image's RMS, once the clamp's own share is taken out."""
    cfg = dict(load_cell(CELL).config, dtype="float32")
    prior = load_prior("restormer")
    pool = make_pool(dict(cfg, tasks=cfg["tasks"][:2]), 1, 5)
    x = torch.stack([torch.as_tensor(np.asarray(r["x0"], np.float32)[0, ...,
                                                                      0])
                     for r in pool.records])[:, None]
    sigma = torch.full((x.shape[0],), 0.1)
    shares = []
    for seed in (1, 2):
        sd = prior.state_dict(cfg, torch.Generator().manual_seed(seed),
                              "cpu")
        with torch.no_grad():
            y = prior.reference(sd, x, sigma, "float32")
        total = float((y - x).pow(2).mean().sqrt())
        clamp = float((x.clamp(0, 1) - x).pow(2).mean().sqrt())
        shares.append((total ** 2 - clamp ** 2) ** 0.5
                      / float(x.pow(2).mean().sqrt()))
    print(f"first-step correction over the image's RMS: {shares}")
    assert all(0.10 <= s <= 0.20 for s in shares), shares


def stage_left_out(stage):
    """The port's Restormer with one level of blocks returning its input."""
    def fault(monkeypatch):
        from dt4image_restoration_tpu_torch.models import restormer
        real = restormer.RestormerDenoiser.__init__

        def init(self, *args, **kw):
            real(self, *args, **kw)
            getattr(self.net, stage).register_forward_hook(
                lambda m, a, out: a[0])
        monkeypatch.setattr(restormer.RestormerDenoiser, "__init__", init)
    fault.__name__ = f"{stage}_left_out"
    return fault


@pytest.mark.parametrize(
    "fault", [None, altered_answer, stage_left_out("refinement"),
              stage_left_out("latent")],
    ids=["sound", "altered_answer", "refinement_left_out",
         "latent_left_out"])
def test_a_fault_makes_the_restormer_run_incorrect(fault, tiny_cell,
                                                   monkeypatch):
    """The tiny cell at the published widths on 64^2 slices (the image
    side cut in this test alone, for the CPU's time): the random prior's
    correction passes through every stage, so a stage left out shows."""
    cell = tiny_cell(CELL)
    cell.config["image_size"] = 64
    cell.traffic["check_sample"] = 64      # every answer of the window
    if fault is not None:
        fault(monkeypatch)
    res = execute(cell, 4242, 0.1, False, "cpu", time.perf_counter())
    print(json.dumps({"fault": getattr(fault, "__name__", None),
                      "numbers": res["_numbers"]}))
    assert res["correct"] is (fault is None), res["checks"]


def test_restormer_weights_follow_the_policys_draws():
    """The policy's draws come first and equal the U-Net cells'."""
    cfg = load_cell(CELL).config
    unet_cell = load_cell("eval_b63_bf16")
    dt_a, sd = make_weights(cfg, 9, "cpu", load_prior("restormer"))
    dt_b, _ = make_weights(unet_cell.config, 9, "cpu", unet_cell.prior)
    assert all(torch.equal(dt_a[k], dt_b[k]) for k in dt_b)
    assert set(sd) == set(load_prior("restormer").state_dict(
        cfg, torch.Generator().manual_seed(9), "cpu"))


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


@pytest.mark.cuda
@pytest.mark.parametrize("stage", ["refinement", "latent"])
def test_a_stage_left_out_fails_on_card(stage, card, monkeypatch):
    """At the cell's own size (63 slices of 128^2, 30 steps), in a window
    of one call: the refinement or the latent level returning its input
    reads past the limits."""
    cell = load_cell(CELL)
    stage_left_out(stage)(monkeypatch)
    res = execute(cell, 3800000011, 0.01, False, card, time.perf_counter())
    print(json.dumps({"stage": stage, "numbers": res["_numbers"]}))
    assert res["attempted"] == 63 and not res["correct"], res["checks"]
