"""The port's ARNIQA value model and proxy scorer against the JAX package's,
on the same weights (a hub-layout random state dict, converted to Flax by
the JAX package and carried back by utils/convert.py) and images."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.models.arniqa import (
    ARNIQA as JARNIQA, convert_arniqa_state_dict,
    make_value_fn as j_make_value_fn,
    make_value_fn_jax as j_make_value_fn_batched,
    proxy_value_fn as j_proxy_value_fn)
from dt4image_restoration_tpu.utils.torch_reference import (
    random_arniqa_state_dict as j_random_arniqa_state_dict)
from dt4image_restoration_tpu_torch.models import (ARNIQA, make_value_fn,
                                                   make_value_fn_batched,
                                                   proxy_value_fn,
                                                   random_arniqa_state_dict,
                                                   score_images)
from dt4image_restoration_tpu_torch.utils.convert import (arniqa_from_hub,
                                                          arniqa_from_jax,
                                                          load_strict)
from dt4image_restoration_tpu_torch.utils.loaders import load_arniqa
from torch_port_common import one_torch_thread  # noqa: F401

SIZE = 64


@pytest.fixture(scope="module")
def shared():
    """(hub state dict, JAX variables, port ARNIQA) on the same weights."""
    hub = j_random_arniqa_state_dict(0)
    variables = jax.tree.map(np.asarray, convert_arniqa_state_dict(hub))
    model = load_strict(ARNIQA(), arniqa_from_jax(variables), "arniqa")
    return hub, variables, model.eval().requires_grad_(False)


def test_arniqa_matches_jax(shared):
    _, variables, model = shared
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (2, 3, SIZE, SIZE)).astype(np.float32)
    half = rng.uniform(0, 1, (2, 3, SIZE // 2, SIZE // 2)).astype(np.float32)
    ref = jax.jit(JARNIQA().apply)(variables,
                                   jnp.asarray(img.transpose(0, 2, 3, 1)),
                                   jnp.asarray(half.transpose(0, 2, 3, 1)))
    with torch.no_grad():
        got = model(torch.from_numpy(img), torch.from_numpy(half))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                               atol=1e-5)


def test_value_fn_matches_jax(shared):
    """Zero-padded "RGB" and the antialiased half scale, end to end."""
    _, variables, model = shared
    x = np.random.default_rng(1).uniform(0, 1, (1, SIZE, SIZE)).astype(
        np.float32)
    ref = j_make_value_fn(variables, image_size=SIZE)(x)
    got = make_value_fn(model, image_size=SIZE)(x)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    batch = np.concatenate([x, x[:, ::-1]])
    scores = score_images(model, torch.from_numpy(batch.copy()), SIZE)
    np.testing.assert_allclose(scores[0].item(), got, rtol=1e-5, atol=1e-6)


def test_batched_value_fn_matches_jax(shared):
    """The device search's scorer: a (B, H, W) batch in, (B,) scores out,
    against the JAX package's batched twin and the port's own per-image
    scorer."""
    _, variables, model = shared
    x = np.random.default_rng(2).uniform(0, 1, (2, SIZE, SIZE)).astype(
        np.float32)
    ref = np.asarray(jax.jit(j_make_value_fn_batched(
        variables, image_size=SIZE))(jnp.asarray(x)))
    got = make_value_fn_batched(model, image_size=SIZE)(torch.from_numpy(x))
    assert got.shape == (2,)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5)
    one = make_value_fn(model, image_size=SIZE)
    np.testing.assert_allclose(got.numpy(), [one(v[None]) for v in x],
                               rtol=1e-5, atol=1e-6)


def test_value_fn_bf16_matches_jax(shared):
    """Scoring in bfloat16 (``--dtype bfloat16``: the ResNet-50's convs in
    bfloat16, its BatchNorms computed in float32 and rounded) against the
    JAX scorer in bfloat16 and in float32, within the band of the JAX
    package's own bfloat16 test (tests/test_arniqa.py), 0.05 max(1, |a|);
    the batched scorer agrees with the per-image one."""
    _, variables, model = shared
    x = np.random.default_rng(3).uniform(0, 1, (2, SIZE, SIZE)).astype(
        np.float32)
    j16 = j_make_value_fn(variables, image_size=SIZE, dtype=jnp.bfloat16)
    j32 = j_make_value_fn(variables, image_size=SIZE)
    one = make_value_fn(model, image_size=SIZE, dtype="bfloat16")
    batched = make_value_fn_batched(model, image_size=SIZE, dtype="bfloat16")
    got = batched(torch.from_numpy(x))
    assert got.dtype == torch.float32
    for i in range(2):
        a16, a32, b = j16(x[i:i + 1]), j32(x[i:i + 1]), one(x[i:i + 1])
        assert abs(b - a16) < 0.05 * max(1.0, abs(a16))
        assert abs(b - a32) < 0.05 * max(1.0, abs(a32))
        np.testing.assert_allclose(float(got[i]), b, rtol=1e-5, atol=1e-6)


def test_hub_state_dict_loads_strictly(shared, tmp_path):
    """A torchvision-named hub dict, with the classification head and the
    BatchNorm counters, loads strictly into the same weights as the JAX
    conversion."""
    hub, variables, model = shared
    sd = dict(hub)
    sd["encoder.model.fc.weight"] = torch.zeros(1000, 2048)
    sd["encoder.model.fc.bias"] = torch.zeros(1000)
    for k in list(hub):
        if k.endswith("running_var"):
            sd[k.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(7)
    path = tmp_path / "arniqa.pt"
    torch.save(sd, path)
    loaded = load_arniqa(str(path), device="cpu")
    want = model.state_dict()
    got = loaded.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == 7
        else:
            torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unexpected keys"):
        load_strict(ARNIQA(), {**arniqa_from_hub(sd), "bogus": torch.ones(1)},
                    "ARNIQA checkpoint")


def test_random_arniqa_state_dict_loads():
    model = load_strict(ARNIQA(), random_arniqa_state_dict(3), "arniqa")
    x = torch.rand(2, SIZE, SIZE, generator=torch.Generator().manual_seed(0))
    s = score_images(model.eval(), x, SIZE)
    assert s.shape == (2,) and torch.isfinite(s).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_proxy_value_fn_matches_jax(seed):
    x = np.random.default_rng(seed).uniform(0, 1, (1, 48, 48)).astype(
        np.float32)
    assert proxy_value_fn(x) == j_proxy_value_fn(x)
