"""The port's headline benchmark (``dt4image_restoration_tpu_torch/bench.py``)
against the JAX package's ``bench.py`` inputs and loop: the same weights and
record, the same rollout PSNR in every variant, and its JSON line, gates and
refusals on the CPU (the kernels' plain versions).

Bands: a float32 rollout within 0.05 dB of the JAX one (PARITY.md's
rollout band; it reads under 1e-3 dB), a bfloat16 one within 0.15 dB
(tests/test_eval.py's bfloat16 band)."""
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.data import make_mat_record as j_make_record
from dt4image_restoration_tpu.env import pnp as jpnp
from dt4image_restoration_tpu.models import UNetDenoiser as JUNetDenoiser
from dt4image_restoration_tpu.utils.checkpoint import convert_unet_state_dict
from dt4image_restoration_tpu.utils.torch_reference import (
    random_unet_state_dict as j_random_unet_state_dict)
from dt4image_restoration_tpu_torch import bench
from dt4image_restoration_tpu_torch.env import reset_from_mat
from dt4image_restoration_tpu_torch.utils.convert import unet_from_jax
from torch_port_common import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, ITERS = 32, 3
F32_DB, BF16_DB = 0.05, 0.15
SMALL = ["--device", "cpu", "--size", str(SIZE), "--iters", str(ITERS),
         "--repeats", "2", "--batch", "2", "--knee", "none"]
J_PACKED = {"none": False, "s2d": True, "pallas": "pallas",
            "winograd": "winograd", "winograd_deep": "winograd_deep"}


def _last_json(out):
    return json.loads(out.strip().splitlines()[-1])


def test_bench_weights_equal_jax_converted():
    """What the bench loads equals, tensor for tensor, the JAX bench's
    ``convert_unet_state_dict(random_unet_state_dict(0))`` brought over by
    ``unet_from_jax``, in every variant's denoiser."""
    want = unet_from_jax(convert_unet_state_dict(
        j_random_unet_state_dict(seed=0)))
    sd = bench.random_unet_state_dict(seed=0)
    for name in ("direct", "pallas_bf16"):
        got = bench.make_denoiser(name, sd, "cpu").state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert torch.equal(got[k], v), k


def test_bench_records_equal_jax():
    """The bench's record and batches equal the JAX bench's."""
    assert bench.IMAGE_SEED == 0
    b = bench.Bench("cpu", size=SIZE, iters=1, batch=3,
                    variants=("direct",))
    for got, seed in [(b.mat, 0)] + [(m, s) for s, m in enumerate(b.mats)]:
        want = j_make_record(size=SIZE, seed=seed)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    big = bench.batch_record(b.mats, 5)
    np.testing.assert_array_equal(big["gt"][3], b.mats[0]["gt"][0])
    assert big["mask"].shape == (5, SIZE, SIZE)


@pytest.mark.parametrize("name", ["direct", "packed", "pallas", "winograd",
                                  "winograd_deep", "bf16_direct",
                                  "pallas_bf16"])
def test_bench_rollout_psnr_matches_jax(name):
    """One variant's rollout (fixed_param_rollout + compute_reward, 3
    iterations on a 32x32 record) against the JAX bench's, with the JAX
    U-Net in the same mode and dtype (Pallas in interpret mode, and K2's
    Pallas twin under the pallas modes)."""
    mode, dtype = bench.VARIANTS[name]
    mat = j_make_record(size=SIZE, seed=bench.IMAGE_SEED)
    sd = bench.random_unet_state_dict(seed=0)
    den = bench.make_denoiser(name, sd, "cpu")
    ours = bench.make_roll(den, ITERS)(reset_from_mat(mat, device="cpu"))

    params = convert_unet_state_dict(j_random_unet_state_dict(seed=0))
    j_dtype = jnp.float32 if dtype == "float32" else jnp.bfloat16
    model = JUNetDenoiser(dtype=j_dtype, packed=J_PACKED[mode])

    def denoise(img, sigma):   # bench.py's denoise_* functions
        out = model.apply({"params": params}, img.astype(j_dtype), sigma)
        return out.astype(jnp.float32)

    def roll(s):
        final, _ = jpnp.fixed_param_rollout(
            denoise, s, bench.MU, bench.SIGMA_D, ITERS,
            use_pallas=mode == "pallas")
        return jpnp.compute_reward(final)

    theirs = np.asarray(jax.jit(roll)(jpnp.reset_from_mat(mat)))
    assert ours.shape == theirs.shape == (1, 1)
    assert np.isfinite(ours.numpy()).all()
    band = F32_DB if dtype == "float32" else BF16_DB
    np.testing.assert_allclose(ours.numpy(), theirs, rtol=0, atol=band)


def test_bench_main_prints_one_json_line(capsys):
    rc = bench.main(SMALL)
    out = capsys.readouterr().out
    assert rc == 0
    line = _last_json(out)
    assert line["metric"] == "pnp_admm_iters_per_sec_per_chip"
    assert line["unit"] == "iters/s"
    for k in ("value", "vs_baseline"):
        assert math.isfinite(line[k]) and line[k] > 0
    ex = line["extras"]
    oks = {k: v for k, v in ex.items() if k.endswith("_ok")}
    # Every variant but direct is gated at B=1 and at B=2.
    assert len(oks) == 2 * (len(bench.VARIANTS) - 1)
    assert all(oks.values()), oks
    assert set(ex["launches"]) == set(bench.VARIANTS)
    assert all(n == 0 for counts in ex["launches"].values()
               for n in counts.values())
    for k in ["unet_variant_adopted", "unet_packed_adopted",
              "single_slice_ms_per_iter", "batched_slices_per_sec",
              "batched_iters_per_sec", "bf16_iters_per_sec",
              "bf16_batched_slices_per_sec", "cpu_reference_iters_per_sec",
              "psnr_f32_db", "psnr_torch_cpu_db", "psnr_parity_delta_db",
              "psnr_bf16_delta_db", "single_iters_per_sec_median",
              "single_iters_per_sec_q1", "single_iters_per_sec_q3",
              "device", "torch", "cuda"] + [
            f"{n}_iters_per_sec" for n in bench.VARIANTS] + [
            f"{n}_batched_slices_per_sec" for n in bench.VARIANTS]:
        assert k in ex, k
    assert ex["platform"] == "cpu" and ex["device"] == "cpu"
    assert ex["psnr_parity_delta_db"] <= bench.PARITY_DB
    assert ex["single_iters_per_sec_q1"] <= ex["single_iters_per_sec_q3"]
    assert not any(k.endswith("_b64") for k in ex)     # --knee none


def test_bench_knee_times_each_point_and_the_candidates(monkeypatch, capsys):
    """The knee at stand-in batches (2, 3, 4; candidates at 3): the knee
    variants at every point, the candidates at one, each point gated."""
    monkeypatch.setattr(bench, "SCALING_BATCHES", (2, 3, 4))
    monkeypatch.setattr(bench, "PALLAS_KNEE_BATCH", 3)
    monkeypatch.setattr(bench, "KNEE_REP_BUDGET", 4)
    argv = SMALL[:-2] + ["--size", "16", "--iters", "1", "--variants",
                         "direct,packed,bf16_direct,pallas,pallas_bf16"]
    assert bench.main(argv) == 0
    ex = _last_json(capsys.readouterr().out)["extras"]
    for b in (2, 3, 4):
        for k in ("direct", "packed", "bf16", "batched"):
            assert ex[f"{k}_slices_per_sec_b{b}"] > 0, (k, b)
        assert ex[f"packed_b{b}_ok"] and ex[f"bf16_direct_b{b}_ok"]
        assert ("pallas_slices_per_sec_b%d" % b in ex) == (b == 3)
    assert ex["pallas_b3_ok"] and ex["pallas_bf16_b3_ok"]


def test_bench_refuses_missing_cuda(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main(["--size", "16", "--iters", "1"]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "pass device='cpu'" in err


def test_bench_variant_off_the_gate_exits_1(monkeypatch, capsys):
    """A float32 variant whose denoiser is 1e-2 off is recorded and fails
    the run; the rest of the line is still printed."""
    make = bench.make_denoiser

    def off(name, sd, device):
        den = make(name, sd, device)
        return (lambda x, s: den(x, s) + 1e-2) if name == "packed" else den

    monkeypatch.setattr(bench, "make_denoiser", off)
    rc = bench.main(SMALL + ["--variants", "direct,packed"])
    out, err = capsys.readouterr()
    assert rc == 1 and "packed" in err
    ex = _last_json(out)["extras"]
    assert ex["packed_ok"] is False and ex["packed_batched_ok"] is False
    assert ex["packed_psnr_delta_db"] > bench.GATE_DB
    assert ex["unet_variant_adopted"] == "direct"


def test_bench_parity_off_the_reference_exits_1(monkeypatch, capsys):
    ref = bench.torch_admm_rollout

    def shifted(*args):
        x, psnr = ref(*args)
        return x, psnr + 0.1

    monkeypatch.setattr(bench, "torch_admm_rollout", shifted)
    assert bench.main(SMALL + ["--variants", "direct"]) == 1
    ex = _last_json(capsys.readouterr().out)["extras"]
    assert ex["psnr_parity_delta_db"] > bench.PARITY_DB


@pytest.mark.parametrize("variants", ["packed,pallas", "direct,unknown"])
def test_bench_variants_flag_refuses_bad_lists(variants, capsys):
    with pytest.raises(SystemExit):
        bench.build_parser().parse_args(["--variants", variants])
    assert "--variants" in capsys.readouterr().err


def test_bench_imports_nothing_of_jax():
    """The bench module pulls in neither JAX nor the JAX package nor the
    root bench.py."""
    code = ("import sys, dt4image_restoration_tpu_torch.bench\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
            "             ('jax', 'jaxlib', 'flax', 'bench',\n"
            "              'dt4image_restoration_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"
