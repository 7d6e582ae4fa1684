"""The frozen reference against the port's oracle, and its precisions."""
import json

import numpy as np
import pytest
import torch

from portbench.records import make_pool
from portbench.reference import greedy_episodes
from portbench.reference.model import _round, precision_scope
from portbench.spec import PACKAGE
from portbench.weights import make_weights


def _cfg(**kw):
    with open(PACKAGE / "configs" / "dt4ir-csmri-f32.json") as f:
        cfg = json.load(f)
    cfg.update(kw)
    return cfg


@pytest.mark.parametrize("stop_bias,want_stops", [(-3.0, False),
                                                  (0.05, True)])
def test_batched_reference_matches_the_ports_oracle(stop_bias, want_stops):
    """Two slices of two tasks, 8 steps: the batched episodes give the
    oracle's images and episode lengths, slice by slice (also where a
    stop action ends an episode early)."""
    from dt4image_restoration_tpu_torch.utils.torch_oracle import \
        torch_eval_episode
    cfg = _cfg(stop_bias=stop_bias, tasks=["4x_15", "8x_5"], max_timesteps=8)
    dt_sd, unet_sd = make_weights(cfg, 7, "cpu")
    pool = make_pool(cfg, 1, 7)
    x, ep = greedy_episodes(dt_sd, unet_sd, pool.reference_inputs([0, 1],
                                                                  "cpu"),
                            8, 6, cfg["n_heads"])
    for i in range(2):
        ref_x, ref_len = torch_eval_episode(
            dt_sd, unet_sd, {k: v[0] for k, v in pool.records[i].items()},
            pool.rtg, pool.tasks[i], max_timesteps=8)
        assert int(ep[i]) == ref_len
        np.testing.assert_allclose(x[i].numpy(), ref_x.reshape(128, 128),
                                   rtol=1e-4, atol=1e-5)
    assert (ep < 8).any() == want_stops


def test_fp8_rounds_operands_to_three_mantissa_bits():
    t = torch.tensor([1.0, 1.06, 0.5, -448.0])   # scale 1
    q = _round(t, "fp8")
    assert q[0] == 1.0 and q[2] == 0.5 and q[1] != t[1]
    assert torch.allclose(q, t, rtol=2 ** -4)
    assert _round(t, "float32") is t


def test_precision_scope_sets_and_restores_tf32():
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.backends.cudnn.allow_tf32)
    with precision_scope("tf32"):
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    with precision_scope("float32"):
        assert not torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == before
    with pytest.raises(ValueError):
        with precision_scope("int8"):
            pass
