"""The plug-in prior as a file of its own: a configuration names it
(``"prior"``), ``priors/<name>.py`` defines it, and weights, the system,
the reference and the counts all come from there."""
import functools
import hashlib
import json
import shutil
import time

import pytest
import torch

from portbench import correct, counts
from portbench.records import make_pool
from portbench.reference import greedy_episodes
from portbench.reference.model import denoise
from portbench.run import execute
from portbench.spec import PACKAGE, ROOT, load_cell, load_prior
from portbench.weights import make_weights

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
UNET = load_prior("unet_nm")
CONFIGS = ("dt4ir-csmri-f32", "dt4ir-csmri-bf16")

TOY = '''"""A toy prior: one bias-free 3x3 convolution, image and noise map in."""
import torch

from portbench.reference import conv2d


def state_dict(cfg, gen, device):
    return {"conv.weight": 0.1 * torch.randn(1, 2, 3, 3, generator=gen,
                                             device=device)}


def reference(sd, img, sigma, precision):
    b, _, h, w = img.shape
    x = torch.cat([img, sigma.reshape(b, 1, 1, 1).expand(b, 1, h, w)], 1)
    return torch.clamp(img + conv2d(x, sd, "conv", precision, padding=1),
                       0, 1)


def system(cfg, sd, device):
    return lambda x, sigma: reference(sd, x, sigma, "float32")


def flops(cfg):
    return 2.0 * cfg["image_size"] ** 2 * 2 * 9


def bytes(cfg, batch):
    return batch * cfg["image_size"] ** 2 * 3 * 4 + 18 * 4
'''


def _cfg(name):
    return json.loads((PACKAGE / "configs" / f"{name}.json").read_text())


def _files(root):
    return {p.relative_to(root).as_posix():
            hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def _package(tmp_path, prior, limits_of="eval_b63_f32"):
    """A copy of the harness's data with one more configuration, naming
    ``prior``, and a cell ``eval_new`` of it; the BENCHMARK dict."""
    pkg = tmp_path / "portbench"
    for sub in ("configs", "priors", "traffic", "limits", "metrics"):
        shutil.copytree(PACKAGE / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    cfg = dict(_cfg("dt4ir-csmri-f32"), name="new-csmri", prior=prior)
    (pkg / "configs" / "new-csmri.json").write_text(json.dumps(cfg))
    shutil.copy(PACKAGE / "limits" / f"{limits_of}.json",
                pkg / "limits" / "eval_new.json")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "eval_new", "config": "new-csmri",
                               "traffic": "closed_b63", "chips": 1,
                               "why": "a test"})
    return pkg, bench


def test_a_new_prior_is_new_files_and_entries_alone(tmp_path):
    """(a) A configuration naming a toy prior and ``priors/toy.py``, both
    new files: the cell loads it, and weights, the reference, the counts
    and a whole run on the CPU take it, with no file of the harness
    touched."""
    before = _files(PACKAGE)
    pkg, bench = _package(tmp_path, "toy")
    (pkg / "priors" / "toy.py").write_text(TOY)
    cell = load_cell("eval_new", root=tmp_path, package=pkg, bench=bench)
    toy = cell.prior
    assert toy.__file__ == str(pkg / "priors" / "toy.py")

    cfg = dict(cell.config, max_timesteps=6, tasks=cell.config["tasks"][:2])
    dt_sd, prior_sd = make_weights(cfg, 5, "cpu", toy)
    assert set(prior_sd) == {"conv.weight"}
    # The policy's draws come first and are the U-Net configuration's.
    dt_unet, _ = make_weights(_cfg("dt4ir-csmri-f32"), 5, "cpu", UNET)
    assert all(torch.equal(dt_sd[k], dt_unet[k]) for k in dt_unet)

    calls = []

    def reference(img, sigma, precision):
        calls.append(img.shape)
        return toy.reference(prior_sd, img, sigma, precision)
    pool = make_pool(cfg, 1, 5)
    images, psnrs, lens = correct.reference_answers(
        cfg, dt_sd, reference, pool, [0, 1], "cpu", 2)
    assert images.shape == (2, 128, 128) and lens.tolist() == [6, 6]
    assert calls == [(2, 1, 128, 128)] * 6

    unet = _cfg("dt4ir-csmri-f32")
    assert counts.slice_flops(cell.config, toy) == pytest.approx(
        counts.slice_flops(unet, UNET) - 30 * counts.unet_flops(unet)
        + 30 * toy.flops(unet), rel=1e-12)
    assert counts.prior_bound_s(cell.config, 63, toy) > 0

    cell.config.update(cfg)
    cell.traffic.update(pool_per_task=2, check_sample=64, check_block=4,
                        trace_calls=1, warmup_calls=1, batch=2)
    res = execute(cell, 4242, 0.1, False, "cpu", time.perf_counter())
    assert res["correct"], res["checks"]
    assert _files(PACKAGE) == before


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("seed,want", [
    (0, ("67db63972d75cdc4e47e3815cce1766bffda046c376fdaa514f9bdb8ba2e832f",
         "8dcc86a31c19e2f92b5089240c4b87bab5b2aa9757de2ad5238a48ef3652d3c2")),
    (1001,
     ("703b3ae8e73b605d58fbc58cd06beb6c660d5ac4e24b9eba3b3242d35e1874dc",
      "a72d2098d526b64a19070333bba8c97b7574f3c6b5888d231610feb224169efc")),
])
def test_unet_nm_weights_are_the_parents_to_the_bit(config, seed, want):
    """(b) The (policy, prior) state dicts, drawn through the prior, hash
    as they did when ``make_weights`` drew the U-Net itself (SHA-256 of
    the sorted names, shapes, dtypes and bytes, computed on the CPU
    before the prior moved behind its module)."""
    def digest(sd):
        h = hashlib.sha256()
        for name in sorted(sd):
            t = sd[name].detach().cpu().contiguous()
            h.update(f"{name}{tuple(t.shape)}{t.dtype}".encode())
            h.update(t.numpy().tobytes())
        return h.hexdigest()
    cfg = _cfg(config)
    assert cfg["prior"] == "unet_nm"
    sds = make_weights(cfg, seed, "cpu", load_cell("eval_b63_f32").prior)
    assert tuple(digest(sd) for sd in sds) == want


@pytest.mark.parametrize("config,bounds", [
    ("dt4ir-csmri-f32", (5.868848096969697e-05, 0.0009390156955151515,
                         0.003697374301090909)),
    ("dt4ir-csmri-bf16", (9.791303700707786e-06, 0.00015666085921132457,
                          0.0006168521331445905)),
])
def test_unet_nm_counts_are_the_parents(config, bounds):
    """(c) The counts through the prior: 9.68359936 GFLOP a call, 292.74
    GFLOP a slice, and the bound at B = 1, 16, 63, to the last bit."""
    cfg = _cfg(config)
    prior = load_cell("eval_b63_f32").prior
    assert prior.flops(cfg) == 9683599360.0
    assert counts.slice_flops(cfg) == 292739826176.0
    assert counts.slice_flops(cfg, prior) == 292739826176.0
    for batch, want in zip((1, 16, 63), bounds):
        assert counts.prior_bound_s(cfg, batch, prior) == want
        assert counts.unet_bound_s(cfg, batch) == want


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_reference_through_the_registry_is_the_direct_unet(precision):
    """(d) Greedy episodes with the prior's reference equal those with
    the U-Net's ``denoise`` called directly, also under a control."""
    cfg = dict(_cfg("dt4ir-csmri-f32"), tasks=["4x_15", "8x_5"],
               max_timesteps=6)
    prior = load_cell("eval_b63_f32").prior
    dt_sd, unet_sd = make_weights(cfg, 11, "cpu", prior)
    inputs = make_pool(cfg, 1, 11).reference_inputs([0, 1], "cpu")
    outs = [greedy_episodes(dt_sd, den, inputs, 6, 6, cfg["n_heads"],
                            precision=precision)
            for den in (functools.partial(prior.reference, unet_sd),
                        lambda img, sigma, p: denoise(unet_sd, img, sigma,
                                                      p))]
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


def test_an_unknown_prior_fails_in_load_cell(tmp_path):
    """(e) With the priors that exist in the message."""
    pkg, bench = _package(tmp_path, "no_such_prior")
    with pytest.raises(KeyError, match="no_such_prior.*unet_nm"):
        load_cell("eval_new", root=tmp_path, package=pkg, bench=bench)


def test_a_prior_lacking_a_function_fails_in_load_cell(tmp_path):
    pkg, bench = _package(tmp_path, "toy")
    (pkg / "priors" / "toy.py").write_text(
        TOY.split("def flops")[0])
    with pytest.raises(AttributeError, match="flops.*bytes|bytes.*flops"):
        load_cell("eval_new", root=tmp_path, package=pkg, bench=bench)
