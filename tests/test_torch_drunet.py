"""DRUNet, DPIR's deep residual U-Net, as the port's second plug-in prior
(models/drunet.py): the port against the plain forward of
utils/torch_reference.py on seeded random weights, DPIR's checkpoint
layout, the loader and the command line, the evaluator and the service
driving it, and its span.

Small widths (nc 8-64, nb 2) on 32^2 and 48^2 slices; the command line
runs the published widths at 128^2. Tolerances: float32 to 1e-5 (the
same products in another order); bfloat16 within 0.02 of the largest
pixel and 0.005 RMS, from 8-bit mantissas over the ~20 layers a pixel
passes (the readings are 0.007 and 0.0018), while the body's blocks left
out read 0.066 and 0.017, and the bfloat16 output must differ from the
float32 one by 1e-4 RMS or more, so that a path that computes float32
under ``dtype="bfloat16"`` fails too."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.inference import Evaluator
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   DRUNetDenoiser,
                                                   UNetDenoiser,
                                                   random_drunet_state_dict)
from dt4image_restoration_tpu_torch.serving import (RestorationRequest,
                                                    RestorationService)
from dt4image_restoration_tpu_torch.utils.convert import (
    drunet_from_reference, load_strict)
from dt4image_restoration_tpu_torch.utils.loaders import load_denoiser
from dt4image_restoration_tpu_torch.utils.profiling import DRUNET, UNET
from dt4image_restoration_tpu_torch.utils.torch_reference import (
    torch_drunet_denoise)
from torch_port_common import one_torch_thread  # noqa: F401

NC = (8, 16, 32, 64)
NB = 2
SIZE = 48          # the policy's state encoder needs 48 or more
MAXT = 6
WAIT = 120         # seconds a service may take
CFG = ModelConfig(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
                  n_blocks=2, image_size=SIZE)
BF16_MAX, BF16_RMS, BF16_MOVES = 0.02, 0.005, 1e-4


def dpir_layout(sd):
    """A port state dict in DPIR's ``UNetRes`` layout."""
    return {k.removeprefix("net."): v.clone() for k, v in sd.items()}


def drunet(seed=1, dtype="float32"):
    den = DRUNetDenoiser(nc=NC, nb=NB, dtype=dtype)
    load_strict(den, random_drunet_state_dict(seed, nc=NC, nb=NB), "DRUNet")
    return den.eval().requires_grad_(False)


def _rms(t):
    return float(t.pow(2).mean().sqrt())


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_drunet_matches_the_plain_forward(dtype, seed):
    den = drunet(seed, dtype)
    ref_sd = dpir_layout(random_drunet_state_dict(seed, nc=NC, nb=NB))
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(3, 1, 32, 40, generator=g)
    sigma = torch.tensor([0.02, 0.1, 0.25])
    with torch.no_grad():
        got = den(x, sigma)
        want = torch_drunet_denoise(ref_sd, x, sigma)
    assert got.shape == x.shape and got.dtype == torch.float32
    assert got.is_contiguous()
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
        return
    assert float((got - want).abs().max()) <= BF16_MAX
    assert _rms(got - want) <= BF16_RMS
    with torch.no_grad():
        f32 = drunet(seed)(x, sigma)
    assert _rms(got - f32) >= BF16_MOVES


def test_bfloat16_tolerance_catches_a_block_left_out():
    """The bfloat16 band above is narrow enough to see the body's blocks
    left out (the deep path is a modest, not a negligible, part of the
    random prior's output)."""
    den = drunet(1, "bfloat16")
    den.net.m_body = torch.nn.Identity()
    ref_sd = dpir_layout(random_drunet_state_dict(1, nc=NC, nb=NB))
    x = torch.rand(2, 1, 32, 32, generator=torch.Generator().manual_seed(1))
    sigma = torch.tensor([0.05, 0.2])
    with torch.no_grad():
        gap = den(x, sigma) - torch_drunet_denoise(ref_sd, x, sigma)
    assert float(gap.abs().max()) > BF16_MAX and _rms(gap) > BF16_RMS


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_every_conv_runs_on_channels_last_tensors(dtype, monkeypatch):
    """All 2 + 6 + 14 * nb convolutions (head and tail, the resampling, the
    ResBlocks) take channels-last inputs and weights in the compute
    dtype, so cuDNN needs no layout transform around any of them."""
    cl = torch.channels_last
    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        def spy(x, w, *args, _real=getattr(F, name), **kw):
            seen.append((x.is_contiguous(memory_format=cl),
                         w.is_contiguous(memory_format=cl), x.dtype,
                         w.dtype))
            return _real(x, w, *args, **kw)
        monkeypatch.setattr(F, name, spy)
    with torch.no_grad():
        drunet(1, dtype)(torch.rand(2, 1, 32, 32), 0.1)
    want = getattr(torch, dtype)
    assert len(seen) == 2 + 6 + 14 * NB
    assert set(seen) == {(True, True, want, want)}


@pytest.mark.parametrize("side", [(36, 32), (32, 44), (12, 16)])
def test_a_side_not_divisible_by_8_is_refused(side):
    with pytest.raises(ValueError, match="divisible by 8"):
        drunet()(torch.rand(1, 1, *side), 0.1)


@pytest.mark.parametrize("fault", [None, "missing", "extra_leaf",
                                   "extra_block", "bias"])
def test_drunet_from_reference_is_strict(fault):
    """A DPIR-layout state dict (an optional ``net.`` or ``module.``
    prefix) loads; a key missing, a leaf or block DPIR's layout lacks, or
    a bias is refused."""
    sd = dpir_layout(random_drunet_state_dict(3, nc=NC, nb=NB))
    if fault is None:
        sd = {"module." + k: v for k, v in sd.items()}
    elif fault == "missing":
        del sd["m_up2.1.res.2.weight"]
    elif fault == "extra_leaf":
        sd["m_down1.0.res.1.weight"] = torch.zeros(1)
    elif fault == "extra_block":
        sd[f"m_body.{NB}.res.0.weight"] = sd["m_body.0.res.0.weight"]
    else:
        sd["m_head.bias"] = torch.zeros(NC[0])
    den = DRUNetDenoiser(nc=NC, nb=NB)
    if fault is None:
        load_strict(den, drunet_from_reference(sd), "DRUNet")
        want = random_drunet_state_dict(3, nc=NC, nb=NB)
        assert all(torch.equal(v, want[k])
                   for k, v in den.state_dict().items())
        return
    with pytest.raises(ValueError, match="key"):
        load_strict(den, drunet_from_reference(sd), "DRUNet")


@pytest.mark.parametrize("arch,cls", [("unet_nm", UNetDenoiser),
                                      ("drunet", DRUNetDenoiser)])
def test_load_denoiser_without_a_file_warns_and_draws(arch, cls, tmp_path,
                                                      capsys):
    den = load_denoiser(str(tmp_path / "none.pt"), device="cpu", arch=arch)
    assert type(den) is cls and not den.training
    assert "not found; using random weights" in capsys.readouterr().err
    if arch == "drunet":
        want = random_drunet_state_dict(0)
        assert all(torch.equal(v, want[k])
                   for k, v in den.state_dict().items())


def test_load_denoiser_reads_a_dpir_checkpoint(tmp_path, monkeypatch):
    import dt4image_restoration_tpu_torch.utils.loaders as loaders
    monkeypatch.setattr(loaders, "DRUNetDenoiser",
                        lambda dtype: DRUNetDenoiser(nc=NC, nb=NB,
                                                     dtype=dtype))
    path = tmp_path / "drunet_gray.pth"
    torch.save(dpir_layout(random_drunet_state_dict(4, nc=NC, nb=NB)), path)
    den = load_denoiser(str(path), device="cpu", dtype="bfloat16",
                        arch="drunet")
    assert den.net.dtype == torch.bfloat16
    want = random_drunet_state_dict(4, nc=NC, nb=NB)
    assert all(torch.equal(v, want[k]) for k, v in den.state_dict().items())
    with pytest.raises(ValueError, match="arch"):
        load_denoiser(str(path), device="cpu", arch="restormer")


@pytest.fixture(scope="module")
def policy():
    torch.manual_seed(0)
    dt = DecisionTransformer(CFG).eval().requires_grad_(False)
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0   # norm mode: T is column 0
    return dt


def _plain(seed=1):
    """The plain forward as a prior callable."""
    sd = dpir_layout(random_drunet_state_dict(seed, nc=NC, nb=NB))
    return lambda img, sigma: torch_drunet_denoise(sd, img, sigma)


def _records(n):
    out = []
    for i in range(n):
        mat = make_mat_record(size=SIZE, seed=i)
        states = np.asarray(mat["x0"], np.float32)[..., 0].reshape(1, -1)
        out.append(((states, np.full((1, 1), 0.6, np.float32),
                     np.zeros(3, np.float32), np.asarray([2], np.int32)),
                    mat))
    return out


def test_the_evaluator_drives_drunet(policy):
    """``Evaluator.evaluate_records`` with DRUNet equals it with the plain
    forward in its place."""
    def run(denoise):
        return Evaluator(dt=policy, denoise=denoise, cfg=CFG,
                         max_timesteps=MAXT, rtg_target=10.0,
                         device="cpu").evaluate_records(_records(3))
    got, want = run(drunet()), run(_plain())
    np.testing.assert_array_equal(got["episode_len"], want["episode_len"])
    assert np.all(got["episode_len"] == MAXT)
    np.testing.assert_allclose(got["final_state"].x.real.numpy(),
                               want["final_state"].x.real.numpy(),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["reward"], want["reward"], atol=1e-4)


def test_the_service_drives_drunet(policy):
    """A ``RestorationService`` batch with DRUNet equals one with the plain
    forward in its place, request by request."""
    def run(denoise):
        svc = RestorationService(denoise=denoise, dt=policy, mode="policy",
                                 batch_size=4, max_timesteps=MAXT,
                                 device="cpu")
        try:
            return svc.restore([RestorationRequest(
                mat=make_mat_record(size=SIZE, seed=i), rtg=0.6, task=2)
                for i in range(3)], timeout=WAIT)
        finally:
            svc.close(timeout=WAIT)
    got, want = run(drunet()), run(_plain())
    assert [r.episode_len for r in got] == [r.episode_len for r in want] \
        == [MAXT] * 3
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.image, b.image, rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_forward_records_one_drunet_span(dtype):
    den = drunet(1, dtype)
    x = torch.rand(2, 1, 32, 32)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        den(x, torch.tensor([0.1, 0.2]))
    names = [e.name for e in prof.events()]
    assert names.count(DRUNET) == 1 and UNET not in names


def test_the_eval_verb_runs_drunet_in_bfloat16(tmp_path, capsys):
    """``eval --denoiser_arch drunet --dtype bfloat16`` builds DRUNet at the
    published widths through ``load_denoiser`` and evaluates with it."""
    from dt4image_restoration_tpu_torch import __main__ as cli
    from dt4image_restoration_tpu_torch.data import write_eval_dir
    d = write_eval_dir(str(tmp_path / "4_10"), "4_10", n=1, size=128)
    cli.main(["--block_size", "18", "--device", "cpu", "eval", "--rtg", "10",
              "--max_timesteps", "6", "--denoiser_arch", "drunet",
              "--dtype", "bfloat16",
              "--checkpoint", str(tmp_path / "none.pt"), "--data_dirs", d])
    out, err = capsys.readouterr()
    assert "dtype bfloat16, prior drunet" in err
    assert "model_zoo/drunet_gray.pth' not found" in err
    assert "Average reward" in out
