"""The priors' graph cache (``models/prior_graphs.py``) on the CPU: where it
engages and what it keys on. Capture and replay need a card; their tests
are in ``test_torch_cuda.py`` and ``test_torch_tracing.py``.

The policy's stop output T is biased to -3, so every episode runs to
``MAXT`` and an evaluation calls the prior once an ADMM step, ``MAXT``
times."""
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu_torch.config import MCTSConfig, ModelConfig
from dt4image_restoration_tpu_torch.data import make_mat_record
from dt4image_restoration_tpu_torch.inference import (MCTS, DeviceMCTS,
                                                      Evaluator)
from dt4image_restoration_tpu_torch.models import (DecisionTransformer,
                                                   DRUNetDenoiser,
                                                   PriorGraphs, UNetDenoiser,
                                                   proxy_value_fn,
                                                   proxy_value_fn_batched,
                                                   random_unet_state_dict)
from dt4image_restoration_tpu_torch.models.prior_graphs import (
    current_prior_graphs, graph_key, per_image_sigma)
from dt4image_restoration_tpu_torch.serving import (RestorationRequest,
                                                    RestorationService)
from torch_port_common import one_torch_thread  # noqa: F401

SIZE = 48
MAXT = 6
BATCH = 2
WAIT = 120   # seconds any one future may take
CFG = ModelConfig(block_size=18, n_embeds=9, embed_dim=32, n_heads=4,
                  n_blocks=2, image_size=SIZE, use_pallas=True)


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    dt = DecisionTransformer(CFG).eval().requires_grad_(False)
    with torch.no_grad():
        dt.predict_action.bias[0] = -3.0   # norm mode: T is column 0
    den = UNetDenoiser(8)
    den.load_state_dict(random_unet_state_dict(seed=3, base_channels=8))
    return dt, den.eval().requires_grad_(False)


def _record(seed):
    rec = make_mat_record(size=SIZE, seed=seed)
    states = rec["x0"][..., 0].reshape(1, -1).astype(np.float32)
    rec["x0"] = np.clip(rec["x0"], 0, None)
    return ((states, np.full((1, 1), 0.6, np.float32),
             np.zeros(3, np.float32), np.full((1, 1), 2)), rec)


class Spy:
    """The prior as a caller hands it over: records each call's inputs,
    answer and the calling thread's graph cache."""

    def __init__(self, den):
        self.den, self.calls = den, []

    def __call__(self, x, sigma):
        out = self.den(x, sigma)
        self.calls.append((x.clone(), torch.as_tensor(sigma).clone(), out,
                           current_prior_graphs()))
        return out


def test_cpu_evaluator_runs_the_prior_eagerly_in_its_scope(models):
    """Inside an evaluator's rollout on the CPU every prior call sees the
    evaluator's cache, runs eagerly and is counted as such; each answer is
    bit-equal to a direct forward outside any scope."""
    dt, den = models
    spy = Spy(den)
    ev = Evaluator(dt=dt, denoise=spy, cfg=CFG, max_timesteps=MAXT,
                   device="cpu")
    m = ev.evaluate_records([_record(i) for i in range(BATCH)])
    assert m["episode_len"].tolist() == [MAXT] * BATCH
    assert len(spy.calls) == MAXT
    assert ev.prior_graph_stats() == {"captures": 0, "replays": 0,
                                      "eager_prior_calls": MAXT}
    scopes = {id(scope) for *_, scope in spy.calls}
    assert len(scopes) == 1 and None not in [c[3] for c in spy.calls]
    assert current_prior_graphs() is None      # closed after the rollout
    with torch.no_grad():
        for x, sigma, out, _ in spy.calls:
            assert torch.equal(den(x, sigma), out)
    ev.evaluate_records([_record(0)])
    assert ev.prior_graph_stats()["eager_prior_calls"] == 2 * MAXT


def test_a_scope_counts_its_eager_calls_and_nothing_outside_it(models):
    """With grad on, or without CUDA, a call in the scope runs eagerly and
    counts; a call outside counts nowhere; scopes nest and restore."""
    _, den = models
    x, graphs, inner = torch.rand(2, 1, 16, 16), PriorGraphs(), PriorGraphs()
    with torch.no_grad():
        want = den(x, 0.1)
        with graphs.scope():
            assert torch.equal(den(x, 0.1), want)
            with inner.scope():
                assert current_prior_graphs() is inner
                den(x, 0.1)
            assert current_prior_graphs() is graphs
            with torch.enable_grad():
                assert torch.equal(den(x, 0.1), want)
    assert current_prior_graphs() is None
    assert graphs.stats() == {"captures": 0, "replays": 0,
                              "eager_prior_calls": 2}
    assert inner.stats()["eager_prior_calls"] == 1
    assert graphs.graphs == {}


def test_drunet_runs_its_forward_through_the_scope():
    den = DRUNetDenoiser(nc=(8, 8, 8, 8), nb=1).eval().requires_grad_(False)
    x, graphs = torch.rand(1, 1, 16, 16), PriorGraphs()
    with torch.no_grad():
        want = den(x, torch.full((1,), 0.05))
        with graphs.scope():
            assert torch.equal(den(x, 0.05), want)
    assert graphs.stats()["eager_prior_calls"] == 1


def test_the_service_and_the_searches_never_enter_the_scope(models):
    """The service's threads see no cache, even while the caller's thread
    holds one open; the host and device tree searches call the prior
    outside any scope."""
    dt, den = models
    spy, graphs = Spy(den), PriorGraphs()
    svc = RestorationService(denoise=spy, dt=dt, mode="policy", batch_size=2,
                             max_timesteps=MAXT, pipeline_depth=2,
                             device="cpu")
    reqs = [RestorationRequest(mat=_record(i)[1], rtg=0.6, task=2)
            for i in range(3)]
    try:
        with graphs.scope():
            results = svc.restore(reqs, timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)
    assert [r.episode_len for r in results] == [MAXT] * 3
    assert spy.calls and all(c[3] is None for c in spy.calls)
    assert graphs.stats() == {"captures": 0, "replays": 0,
                              "eager_prior_calls": 0}
    for search in (MCTS, DeviceMCTS):
        spy.calls.clear()
        kw = dict(dt=dt, denoise=spy, model_cfg=CFG,
                  cfg=MCTSConfig(iterations=2, max_timesteps=MAXT),
                  value_fn=proxy_value_fn, device="cpu")
        if search is DeviceMCTS:
            kw["value_fn_batched"] = proxy_value_fn_batched
        search(**kw).run_batch([_record(0)], seeds=[0])
        assert spy.calls and all(c[3] is None for c in spy.calls), search


@pytest.mark.parametrize("sigma", [
    0.05, torch.tensor(0.05), torch.full((1,), 0.05),
    torch.full((3,), 0.05), torch.full((3, 1), 0.05, dtype=torch.float64)],
    ids=["float", "0-d", "one", "per-image", "column-f64"])
def test_a_float_sigma_and_a_per_image_sigma_give_the_same_static_input(
        sigma):
    x = torch.rand(3, 1, 8, 8)
    got = per_image_sigma(sigma, x)
    assert got.shape == (3,) and got.dtype == x.dtype
    assert torch.equal(got, torch.full((3,), 0.05))
    # What the forward broadcasts: the same map from either form.
    for form in (sigma, got):
        assert torch.equal(
            torch.as_tensor(form, dtype=x.dtype).reshape(-1, 1, 1, 1)
            .expand(3, 1, 8, 8), torch.full((3, 1, 8, 8), 0.05))


def test_a_change_of_batch_shape_dtype_prior_or_weights_re_keys_the_entry(
        models):
    """The key changes with the batch shape, the dtype, the prior and (read
    once a scope) its weights."""
    _, den = models
    x, read = torch.rand(2, 1, 16, 16), {}
    key = graph_key(den, x, read)
    assert graph_key(den, torch.rand(2, 1, 16, 16), read) == key
    assert graph_key(den, torch.rand(3, 1, 16, 16), read) != key
    assert graph_key(den, torch.rand(2, 1, 24, 24), read) != key
    assert graph_key(den, x.double(), read) != key
    twin = UNetDenoiser(8)
    twin.load_state_dict(den.state_dict())
    assert graph_key(twin, x, read) != key
    assert list(read) == [den, twin]
    with torch.no_grad():
        den.net.up2.conv1.weight.mul_(1.0)   # in place: a new version
    assert graph_key(den, x, read) == key    # read once in a scope
    assert graph_key(den, x, {}) != key      # the next scope reads anew
    assert graph_key(den, x, {}) == graph_key(den, x, {})
