"""The port's U-Net denoiser and Decision Transformer against the JAX
models on the same weights (carried over by utils/convert.py) and inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params, make_dt_apply as j_make_dt_apply)
from dt4image_restoration_tpu.models.unet import (
    UNet as JUNet, UNetDenoiser as JUNetDenoiser)
from dt4image_restoration_tpu.utils.checkpoint import (
    export_dt_state_dict, export_unet_state_dict)
from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.models import (
    DecisionTransformer, UNetDenoiser, make_dt_apply, make_dt_embed_apply,
    make_state_encode)
from dt4image_restoration_tpu_torch.utils.convert import (
    dt_from_jax, dt_from_reference, load_strict, unet_from_jax,
    unet_from_reference)
from torch_port_common import one_torch_thread  # noqa: F401

CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
              n_blocks=2, image_size=48)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _port_unet(params, base):
    model = UNetDenoiser(base)
    return load_strict(model, unet_from_jax(params), "unet").eval()


@pytest.mark.parametrize("size", [48, 50])
def test_unet_denoiser_matches_jax(rng, size):
    x = rng.uniform(0, 1, (2, size, size, 1)).astype(np.float32)
    sigma = np.asarray([0.05, 0.1], np.float32)
    jmodel = JUNetDenoiser()
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                  jnp.asarray(sigma))["params"])
    ref = np.asarray(jax.jit(jmodel.apply)({"params": params},
                                           jnp.asarray(x),
                                           jnp.asarray(sigma)))
    with torch.no_grad():
        got = _port_unet(params, 32)(
            torch.from_numpy(x.transpose(0, 3, 1, 2)),
            torch.from_numpy(sigma)).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("size", [32, 37])
def test_unet_base8_matches_jax(rng, size):
    """Narrow U-Net, including an odd size where every block, inc and up4
    too, takes the plain conv chain and the decoder pads to match."""
    x = rng.uniform(0, 1, (1, size, size, 2)).astype(np.float32)
    x[..., 1] = 0.07  # the constant sigma noise-map channel
    jnet = JUNet(base_channels=8)
    params = _np_tree(jnet.init(jax.random.PRNGKey(1), jnp.asarray(x)))
    ref = np.clip(np.asarray(jax.jit(jnet.apply)(params, jnp.asarray(x))),
                  0, 1)
    model = _port_unet({"net": params["params"]}, 8)
    with torch.no_grad():
        got = model(torch.from_numpy(x[..., :1].transpose(0, 3, 1, 2)),
                    0.07).numpy()
    np.testing.assert_allclose(got.transpose(0, 2, 3, 1), ref, rtol=1e-3,
                               atol=2e-4)


def test_unet_reference_layout_loads(rng):
    """The reference .pt key layout (as the JAX exporter writes it) loads
    into the same port weights as the direct JAX conversion."""
    jmodel = JUNetDenoiser()
    params = _np_tree(jmodel.init(jax.random.PRNGKey(2),
                                  jnp.zeros((1, 16, 16, 1)),
                                  jnp.zeros((1,)))["params"])
    ref_sd = {"net." + k: v for k, v in
              export_unet_state_dict(params).items()}
    a, b = unet_from_reference(ref_sd), unet_from_jax(params)
    assert set(a) == set(b) == set(UNetDenoiser().state_dict())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="unrecognized"):
        unet_from_reference({"inc.conv.bogus.weight": np.zeros(1)})


@pytest.fixture(scope="module")
def dt_pair():
    jcfg = JModelConfig(**CFG_KW)
    params = _np_tree(j_init_dt_params(jcfg, seed=1))
    # Non-trivial biases and norms, so a transposed or misplaced leaf shows.
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(
            np.float32), params)
    cfg = ModelConfig(**CFG_KW)
    model = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                        "dt").eval().requires_grad_(False)
    return jcfg, params, cfg, model


def _dt_inputs(rng, b=3, t=6):
    return (rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
            rng.uniform(0, 1, (b, t, 48 * 48)).astype(np.float32),
            np.broadcast_to(np.arange(t, dtype=np.int32)[None] + 3, (b, t)),
            rng.integers(0, 9, (b, t)).astype(np.int32),
            rng.uniform(0, 1, (b, t, 3)).astype(np.float32))


@pytest.mark.parametrize("three_token", [True, False])
@pytest.mark.parametrize("mode", ["norm", "flex"])
def test_dt_matches_jax(rng, dt_pair, three_token, mode):
    _, params, _, _ = dt_pair
    cfg = ModelConfig(**CFG_KW, mode=mode)
    jcfg = JModelConfig(**CFG_KW, mode=mode)
    model = load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                        "dt").eval().requires_grad_(False)
    rtg, states, ts, task, actions = _dt_inputs(rng)
    acts = actions if three_token else None
    ref = j_make_dt_apply(jcfg)(
        params, jnp.asarray(rtg), jnp.asarray(states), jnp.asarray(ts),
        jnp.asarray(task), None if acts is None else jnp.asarray(acts))
    got = make_dt_apply(model)(
        torch.from_numpy(rtg), torch.from_numpy(states),
        torch.from_numpy(ts.copy()), torch.from_numpy(task),
        None if acts is None else torch.from_numpy(acts))
    np.testing.assert_allclose(got.pred_actions.numpy(),
                               np.asarray(ref.pred_actions), rtol=2e-3,
                               atol=1e-6)
    for k in ref.action_dict:
        np.testing.assert_allclose(got.action_dict[k].numpy(),
                                   np.asarray(ref.action_dict[k]),
                                   rtol=2e-3, atol=1e-6)
    if three_token:
        np.testing.assert_allclose(got.pred_rtg.numpy(),
                                   np.asarray(ref.pred_rtg), rtol=2e-3,
                                   atol=1e-5)
    else:
        assert got.pred_rtg is None


def test_dt_cached_state_embeddings_match(rng, dt_pair):
    _, _, _, model = dt_pair
    rtg, states, ts, task, actions = _dt_inputs(rng, b=2)
    args = [torch.from_numpy(a.copy()) for a in (rtg, states, ts, task,
                                                 actions)]
    full = make_dt_apply(model)(*args)
    embs = make_state_encode(model)(args[1].reshape(-1, 48 * 48))
    cached = make_dt_embed_apply(model)(args[0], embs.reshape(2, 6, -1),
                                        *args[2:])
    torch.testing.assert_close(cached.pred_actions, full.pred_actions)
    torch.testing.assert_close(cached.pred_rtg, full.pred_rtg)


def test_dt_reference_layout_loads(dt_pair):
    _, params, cfg, _ = dt_pair
    ref_sd = export_dt_state_dict(params, block_size=18, state_conv_hw=2)
    a, b = dt_from_reference(ref_sd), dt_from_jax(params, cfg)
    assert set(a) == set(b) == set(DecisionTransformer(cfg).state_dict())
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="missing keys"):
        load_strict(DecisionTransformer(cfg),
                    {k: v for k, v in a.items() if k != "layer_n.bias"},
                    "DT checkpoint")
