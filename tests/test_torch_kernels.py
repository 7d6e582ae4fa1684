"""The port's kernels (K1 conv_block, K2 kspace, K3 dt_decode).

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the JAX package's Pallas kernel run in interpret mode on the same
numpy inputs, at the tolerances of tests/test_pallas.py. The CUDA kernels
themselves are held against their plain versions on the card by
tests/test_torch_cuda.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.models.decision_transformer import (
    init_dt_params as j_init_dt_params)
from dt4image_restoration_tpu.ops.pallas import (
    fused_conv_block as j_fused_conv_block,
    kspace_consistency_pallas)
from dt4image_restoration_tpu.ops.pallas.transformer import (
    fused_dt_decode as j_fused_dt_decode, pack_dt_weights as j_pack)
from dt4image_restoration_tpu_torch.config import ModelConfig
from dt4image_restoration_tpu_torch.ops import kernels
from dt4image_restoration_tpu_torch.ops.kernels import conv_block as k1
from dt4image_restoration_tpu_torch.ops.kernels import kspace as k2
from dt4image_restoration_tpu_torch.ops.kernels import transformer as k3
from dt4image_restoration_tpu_torch.utils.convert import dt_from_jax
from torch_port_common import one_torch_thread  # noqa: F401


def _block_params(rng, cin, feats, layers):
    ws, bs = [], []
    for _ in range(layers):
        ws.append((rng.standard_normal((3, 3, cin, feats)) * 0.1)
                  .astype(np.float32))
        bs.append((rng.standard_normal((feats,)) * 0.1).astype(np.float32))
        cin = feats
    return ws, bs


def _t(arrays):
    return [torch.from_numpy(a) for a in arrays]


# --- K1 -----------------------------------------------------------------

@pytest.mark.parametrize("shape,feats,layers,row_tile", [
    ((2, 16, 12, 2), 8, 3, None),     # inc-shaped
    ((1, 8, 8, 4), 16, 1, None),      # single layer
    ((3, 10, 24, 16), 8, 2, None),
    ((1, 16, 8, 64), 8, 3, 2),        # JAX row tiles: every seam
    ((1, 34, 20, 3), 8, 3, None),     # beyond one 16x16 CUDA tile
])
def test_conv_block_plain_matches_pallas(rng, shape, feats, layers,
                                         row_tile):
    x = rng.standard_normal(shape).astype(np.float32)
    ws, bs = _block_params(rng, shape[-1], feats, layers)
    ref = j_fused_conv_block(jnp.asarray(x), [jnp.asarray(w) for w in ws],
                             [jnp.asarray(b) for b in bs],
                             row_tile=row_tile, interpret=True)
    got = k1.fused_conv_block(torch.from_numpy(x), _t(ws), _t(bs))
    assert got.shape == shape[:3] + (feats,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_pack_conv_block_layouts_agree(rng):
    ws, bs = _block_params(rng, 5, 8, 3)
    hwio = k1.pack_conv_block(_t(ws), _t(bs), layout="hwio")
    oihw = k1.pack_conv_block(
        [torch.from_numpy(w.transpose(3, 2, 0, 1)) for w in ws], _t(bs))
    assert (hwio.cin, hwio.features, hwio.layers) == (5, 8, 3)
    torch.testing.assert_close(hwio.weights, oihw.weights, rtol=0, atol=0)
    torch.testing.assert_close(hwio.layer_weight(1),
                               torch.from_numpy(ws[1]).permute(2, 0, 1, 3))
    with pytest.raises(ValueError, match="layer 1"):
        k1.pack_conv_block(_t([ws[0], ws[0]]), _t(bs[:2]), layout="hwio")


# --- K2 -----------------------------------------------------------------

@pytest.mark.parametrize("b,h,w", [(3, 16, 16), (1, 128, 128)])
def test_kspace_plain_matches_pallas(rng, b, h, w):
    z = rng.standard_normal((b, 1, h, w, 2)).astype(np.float32)
    y0 = rng.standard_normal((b, 1, h, w, 2)).astype(np.float32)
    mask = rng.uniform(size=(b, 1, h, w)) < 0.3
    mu = rng.uniform(0.1, 2.0, (b,)).astype(np.float32)
    ref = np.asarray(kspace_consistency_pallas(
        jnp.asarray(z), jnp.asarray(y0), jnp.asarray(mask), jnp.asarray(mu),
        interpret=True))
    got = k2.kspace_consistency_kernel(
        torch.view_as_complex(torch.from_numpy(z)),
        torch.view_as_complex(torch.from_numpy(y0)),
        torch.from_numpy(mask), torch.from_numpy(mu))
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(torch.view_as_real(got).numpy(), ref,
                               rtol=1e-6, atol=1e-6)


def test_wrappers_refuse_other_devices():
    z = torch.zeros((1, 1, 4, 4), dtype=torch.complex64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        k2.kspace_consistency_kernel(
            z, z, torch.zeros(z.shape, dtype=torch.bool, device="meta"),
            torch.zeros(1, device="meta"))


# --- K3 -----------------------------------------------------------------

JCFG = JModelConfig(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
                    n_blocks=2, image_size=48)


@pytest.fixture(scope="module")
def dt_params():
    return jax.tree.map(np.asarray, j_init_dt_params(JCFG, seed=3))


@pytest.mark.parametrize("t", [12, 18])
def test_dt_decode_plain_matches_pallas(rng, dt_params, t):
    packed = {k: np.array(v) for k, v in j_pack(dt_params, 2).items()}
    tokens = rng.standard_normal((3, t, 64)).astype(np.float32)
    ref = np.asarray(j_fused_dt_decode(
        jnp.asarray(tokens), {k: jnp.asarray(v) for k, v in packed.items()},
        n_blocks=2, n_heads=4, interpret=True))
    got = k3.fused_dt_decode(torch.from_numpy(tokens),
                             {k: torch.from_numpy(v)
                              for k, v in packed.items()},
                             n_blocks=2, n_heads=4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_pack_dt_weights_matches_jax(dt_params):
    cfg = ModelConfig(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
                      n_blocks=2, image_size=48)
    ours = k3.pack_dt_weights(dt_from_jax(dt_params, cfg), 2)
    theirs = j_pack(dt_params, 2)
    assert set(ours) == set(k3.PACK_KEYS) == set(theirs)
    for k in k3.PACK_KEYS:
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]))


# --- launch counts --------------------------------------------------------

def test_plain_path_counts_no_launches(rng):
    kernels.reset_launch_counts()
    ws, bs = _block_params(rng, 2, 8, 3)
    k1.fused_conv_block(torch.zeros((1, 8, 8, 2)), _t(ws), _t(bs))
    assert kernels.launch_counts() == {"conv_block": 0, "kspace": 0,
                                       "dt_decode": 0}
