"""Checkpoint export of the port (``utils/convert.py:unet_to_reference``,
``dt_to_reference``, ``tools/export_checkpoint.py``) against the JAX
package's exporters and loaders, and the record -> train -> eval -> export
loop of the port's command lines on the CPU.

Bands (PARITY.md): the U-Net forward 1e-3 relative / 2e-4 absolute; the DT
forward 2e-3 relative (1e-6 absolute on actions, 1e-5 on RTG). The key
layouts and the exported values are held bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu.models.unet import (
    UNetDenoiser as JUNetDenoiser)
from dt4image_restoration_tpu.utils.checkpoint import (
    export_dt_state_dict, export_unet_state_dict, load_dt_checkpoint,
    load_unet_checkpoint)
from dt4image_restoration_tpu_torch.__main__ import main as port_main
from dt4image_restoration_tpu_torch.config import ModelConfig, TrainerConfig
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   UNetDenoiser,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.tools import export_checkpoint
from dt4image_restoration_tpu_torch.training import init_train_state
from dt4image_restoration_tpu_torch.utils.checkpoint import (
    restore_checkpoint, save_checkpoint)
from dt4image_restoration_tpu_torch.utils.convert import (
    dt_from_jax, dt_from_reference, dt_to_reference, load_strict,
    unet_from_jax, unet_from_reference, unet_to_reference)
from torch_port_common import one_torch_thread  # noqa: F401
from torch_port_common import jax_unet_params

# 128x128 states: the JAX package's DT loader assumes the published
# geometry (a 12x12 state-encoder map).
DT_KW = dict(block_size=18, n_embeds=9, embed_dim=32, n_heads=4, n_blocks=2,
             image_size=128)


def _jax_unet(base, seed=1):
    """JAX ``UNetDenoiser`` params ``{'net': ...}`` of a random U-Net."""
    return {"net": jax_unet_params(random_unet_state_dict(seed, base))}


def _jax_dt(seed=3):
    jcfg = JModelConfig(**DT_KW)
    return jcfg, jax.tree.map(np.asarray, j_init_dt_params(jcfg, seed))


def _port_dt(params):
    cfg = ModelConfig(**DT_KW)
    return cfg, load_strict(DecisionTransformer(cfg),
                            dt_from_jax(params, cfg), "DT").eval()


def _dt_inputs(cfg, seed=0, b=2):
    rng = np.random.default_rng(seed)
    t = cfg.context_length
    return [rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
            rng.uniform(0, 1, (b, t, cfg.image_size ** 2)).astype(np.float32),
            np.tile(np.arange(t), (b, 1)), rng.integers(0, 9, (b, t)),
            rng.uniform(0, 1, (b, t, 3)).astype(np.float32)]


# --- converters ----------------------------------------------------------------

@pytest.mark.parametrize("base", [8, 32])
def test_unet_to_reference_matches_jax_export(base):
    params = _jax_unet(base)
    ours = unet_to_reference(unet_from_jax(params))
    theirs = export_unet_state_dict(params)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        assert ours[k].dtype == torch.float32 and ours[k].device.type == "cpu"
        np.testing.assert_array_equal(ours[k].numpy(), v)


def test_unet_reference_round_trip_is_identity():
    sd = random_unet_state_dict(2, 8)
    back = unet_from_reference(unet_to_reference(sd))
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    with pytest.raises(ValueError, match="unrecognized port U-Net key"):
        unet_to_reference({"net.inc.bogus": torch.zeros(1)})


@pytest.mark.parametrize("block_size", [None, 18])
def test_dt_to_reference_matches_jax_export(block_size):
    """Key for key and bit for bit JAX's export_dt_state_dict: masking
    buffers with a block size and none without."""
    jcfg, params = _jax_dt()
    cfg, model = _port_dt(params)
    ours = dt_to_reference(model.state_dict(), block_size=block_size)
    theirs = export_dt_state_dict(params, block_size=block_size)
    assert sorted(ours) == sorted(theirs)
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), v)
    masks = [k for k in ours if k.endswith(".masking")]
    assert len(masks) == (0 if block_size is None else cfg.n_blocks)
    back = dt_from_reference(ours)
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k


# --- the tool, read by the JAX loaders -----------------------------------------

def test_exported_unet_loads_in_jax(tmp_path, capsys):
    sd = random_unet_state_dict(5)
    src, out = str(tmp_path / "unet_port.pt"), str(tmp_path / "unet.pt")
    save_checkpoint(src, sd)
    assert export_checkpoint.main(["--model", "unet", "--in", src,
                                   "--out", out]) == 0
    assert capsys.readouterr().out.strip() == f"wrote {len(sd)} tensors " \
                                              f"to {out}"
    params = load_unet_checkpoint(out)
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 1, 32, 32)).astype(np.float32)
    sigma = np.asarray([0.05, 0.1], np.float32)
    ref = JUNetDenoiser().apply({"params": params},
                                jnp.asarray(img.transpose(0, 2, 3, 1)),
                                jnp.asarray(sigma))
    model = load_strict(UNetDenoiser(packed="none"), sd, "U-Net").eval()
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(sigma))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(ref).transpose(0, 3, 1, 2),
                               rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("block_size", [None, 18])
def test_exported_dt_loads_in_jax(tmp_path, block_size):
    jcfg, params = _jax_dt()
    cfg, model = _port_dt(params)
    src, out = str(tmp_path / "dt_port.pt"), str(tmp_path / "dt.pt")
    save_checkpoint(src, model.state_dict())
    argv = ["--model", "dt", "--in", src, "--out", out]
    if block_size is not None:
        argv += ["--block_size", str(block_size)]
    assert export_checkpoint.main(argv) == 0
    written = torch.load(out)
    assert any(k.endswith(".masking") for k in written) \
        == (block_size is not None)
    loaded = load_dt_checkpoint(out)
    args = _dt_inputs(cfg)
    ref = j_make_dt_apply(jcfg)(loaded, *map(jnp.asarray, args))
    with torch.no_grad():
        got = model(*map(torch.from_numpy, args))
    np.testing.assert_allclose(got.pred_actions.numpy(),
                               np.asarray(ref.pred_actions), rtol=2e-3,
                               atol=1e-6)
    np.testing.assert_allclose(got.pred_rtg.numpy(),
                               np.asarray(ref.pred_rtg), rtol=2e-3,
                               atol=1e-5)


def test_export_takes_trainer_state(tmp_path):
    """A state_latest.pt: its model weights are taken out."""
    _, params = _jax_dt()
    cfg, model = _port_dt(params)
    state = init_train_state(model.train(), TrainerConfig(), 4)
    src, out = str(tmp_path / "state_latest.pt"), str(tmp_path / "dt.pt")
    save_checkpoint(src, state.state_dict(np.random.default_rng(0)))
    assert export_checkpoint.main(["--model", "dt", "--in", src, "--out",
                                   out, "--block_size", "18"]) == 0
    want = dt_to_reference(model.state_dict(), block_size=18)
    got = restore_checkpoint(out)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


# --- the loop --------------------------------------------------------------------

def test_record_train_eval_export_loop_on_cpu(tmp_path, capsys):
    """make_dataset -> train -> eval -> export_checkpoint, every step
    through the port's command lines on the CPU; the export loads in the
    JAX package's load_dt_checkpoint."""
    from dt4image_restoration_tpu_torch.tools import make_dataset
    data, ckpts = tmp_path / "synth", tmp_path / "ckpts"
    assert make_dataset.main(["--out", str(data), "--device", "cpu",
                              "--n_traj", "4", "--ep_len", "3", "--eval",
                              "--per_dir", "1"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert len(stats["eval_dirs"]) == 9

    port_main(["--block_size", "18", "--platform", "cpu", "train",
               "--batch_size", "2", "--save_every", "1", "--max_epochs",
               "1", "--data_dir", stats["traj_dir"], "--state_file",
               stats["h5_path"], "--checkpoint_dir", str(ckpts)])
    assert "Training complete" in capsys.readouterr().out

    model_0 = str(ckpts / "model_0.pt")
    port_main(["--block_size", "18", "--n_embeds", "9", "--device", "cpu",
               "eval", "--rtg", "10", "--max_timesteps", "6",
               "--checkpoint", model_0,
               "--denoiser_ckpt", str(tmp_path / "none.pt"),
               "--data_dirs", stats["eval_dirs"][0]])
    r = capsys.readouterr()
    assert "DT checkpoint" not in r.err      # the trained model was read
    lines = dict(ln.rsplit(",", 1) for ln in r.out.splitlines() if "," in ln)
    assert np.isfinite(float(lines["Average reward"]))

    out = str(tmp_path / "dt_export.pt")
    assert export_checkpoint.main(["--model", "dt", "--in",
                                   str(ckpts / "state_latest.pt"),
                                   "--out", out, "--block_size", "18"]) == 0
    params = load_dt_checkpoint(out)
    assert params["block4"]["fc"]["kernel"].shape == (128, 512)
    for k, v in torch.load(model_0).items():
        assert torch.equal(torch.load(out)[k], v), k
