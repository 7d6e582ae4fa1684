"""bfloat16 inference in the port (``--dtype bfloat16``) against the JAX
package's, on shared weights and inputs: the Decision Transformer (per-op
forward, with and without the kernels' plain versions, and the fused
forward), greedy evaluation, the tree search, the service and the command
line; and the trainer's refusal of a bfloat16 model config.

Bands. The DT's actions: within 2e-2 of the JAX bfloat16 model's, and on
average no further from the JAX float32 model's than 1.5x the JAX bfloat16
model's distance, plus 1e-4. Greedy evaluation: within 0.15 dB of the
port's float32 evaluation and of the JAX bfloat16 one, the band of
tests/test_eval.py's bfloat16 test (8 steps, 3 records)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dt4image_restoration_tpu.config import ModelConfig as JModelConfig
from dt4image_restoration_tpu.data.datasets import (
    EvaluationDataset as JEvaluationDataset)
from dt4image_restoration_tpu.inference import Evaluator as JEvaluator
from dt4image_restoration_tpu.models import decision_transformer as jdt
from dt4image_restoration_tpu.models.unet import UNet as JUNet
from dt4image_restoration_tpu_torch import __main__ as cli
from dt4image_restoration_tpu_torch.config import (MCTSConfig, ModelConfig,
                                                   TrainerConfig)
from dt4image_restoration_tpu_torch.data import (EvaluationDataset,
                                                 make_mat_record,
                                                 write_eval_dir)
from dt4image_restoration_tpu_torch.env import reset_from_mat
from dt4image_restoration_tpu_torch.inference import (
    DeviceMCTS, Evaluator, greedy_rollout, initial_policy_setup)
from dt4image_restoration_tpu_torch.inference.evaluator import policy_forward
from dt4image_restoration_tpu_torch.models import (
    DecisionTransformer, UNetDenoiser, make_dt_apply, make_dt_embed_apply,
    make_fused_dt_apply, make_state_encode, proxy_value_fn,
    proxy_value_fn_batched, random_unet_state_dict)
from dt4image_restoration_tpu_torch.serving import (RestorationRequest,
                                                    RestorationService)
from dt4image_restoration_tpu_torch.training import init_train_state
from dt4image_restoration_tpu_torch.utils.convert import (dt_from_jax,
                                                          load_strict)
from dt4image_restoration_tpu_torch.utils.loaders import (load_denoiser,
                                                          load_dt)
from torch_port_common import jax_unet_params
from torch_port_common import one_torch_thread  # noqa: F401

SIZE = 48
CFG_KW = dict(block_size=18, n_embeds=9, embed_dim=64, n_heads=4,
              n_blocks=2, image_size=SIZE)
MAXT = 8
WAIT = 120   # seconds a service wait may take


@pytest.fixture(scope="module")
def dt_params():
    """JAX DT params with non-trivial biases and norms, and the stop
    output T pinned low (norm mode: column 0), so no episode stops."""
    params = jax.tree.map(np.asarray, jdt.init_dt_params(
        JModelConfig(**CFG_KW), seed=1))
    rng = np.random.default_rng(5)
    params = jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(
        a.shape)).astype(np.float32), params)
    params["predict_action"]["kernel"][:, 0] = 0.0
    params["predict_action"]["bias"][0] = -8.0
    return params


@pytest.fixture(scope="module")
def unet_sd():
    return random_unet_state_dict(seed=4, base_channels=8)


def _port_dt(params, **kw):
    cfg = ModelConfig(**CFG_KW, **kw)
    return load_strict(DecisionTransformer(cfg), dt_from_jax(params, cfg),
                       "dt").eval().requires_grad_(False)


def _port_unet(sd, dtype, mode="pallas"):
    model = UNetDenoiser(8, dtype=dtype, packed=mode)
    model.load_state_dict(sd)
    return model.eval().requires_grad_(False)


def _j_denoise(sd, dtype):
    net = jax_unet_params(sd)
    jnet = JUNet(base_channels=8, dtype=dtype)

    def denoise(img, sigma):
        smap = jnp.broadcast_to(sigma.reshape(-1, 1, 1, 1), img.shape)
        out = jnet.apply({"params": net}, jnp.concatenate([img, smap], -1))
        return jnp.clip(out, 0.0, 1.0)
    return denoise


def _dt_inputs(seed, b=3, t=6):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (b, t, 1)).astype(np.float32),
            rng.uniform(0, 1, (b, t, SIZE * SIZE)).astype(np.float32),
            np.broadcast_to(np.arange(t, dtype=np.int32)[None] + 3, (b, t)),
            rng.integers(0, 9, (b, t)).astype(np.int32),
            rng.uniform(0, 1, (b, t, 3)).astype(np.float32))


_J_APPLY = {}


def _j_apply(kind, dtype, use_pallas=False):
    key = (kind, dtype, use_pallas)
    if key not in _J_APPLY:
        jcfg = JModelConfig(**CFG_KW, dtype=dtype, use_pallas=use_pallas)
        fn = jdt.make_fused_dt_apply(jcfg) if kind == "fused" \
            else jdt.make_dt_apply(jcfg)
        _J_APPLY[key] = jax.jit(fn)
    return _J_APPLY[key]


@pytest.mark.parametrize("three_token", [True, False])
@pytest.mark.parametrize("forward", ["per_op", "per_op_kernels", "fused"])
def test_bf16_dt_matches_jax(dt_params, forward, three_token):
    """The bfloat16 DT against the JAX one in the same forward: the
    projections and the state encoder in bfloat16, LayerNorms, attention
    (K4, K5 with ``use_pallas``; the fused forward's stack, K3) and heads
    in float32."""
    rtg, states, ts, task, actions = _dt_inputs(11)
    if not three_token:
        actions = None
    use_pallas = forward == "per_op_kernels"
    kind = "fused" if forward == "fused" else "per_op"
    args = (rtg, states, ts, task, actions)
    j16 = _j_apply(kind, "bfloat16", use_pallas)(dt_params, *args)
    j32 = _j_apply("per_op", "float32")(dt_params, *args)
    model = _port_dt(dt_params, dtype="bfloat16", use_pallas=use_pallas)
    apply = make_fused_dt_apply(model) if forward == "fused" \
        else make_dt_apply(model)
    with torch.no_grad():
        out = apply(*(None if a is None else torch.from_numpy(
            np.ascontiguousarray(a)) for a in args))
    heads = [("pred_actions", out.pred_actions)]
    if three_token:
        heads.append(("pred_rtg", out.pred_rtg))
    for name, got in heads:
        got = got.numpy()
        a16 = np.asarray(getattr(j16, name))
        a32 = np.asarray(getattr(j32, name))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, a16, rtol=0, atol=2e-2)
        assert np.abs(got - a32).mean() \
            <= 1.5 * np.abs(a16 - a32).mean() + 1e-4, name


def test_bf16_state_encoder_and_cached_embeddings(dt_params):
    """The state encoder computes in bfloat16; the cached-embedding forward
    (the evaluator's) equals the uncached one."""
    rtg, states, ts, task, actions = (torch.from_numpy(np.ascontiguousarray(
        a)) for a in _dt_inputs(12))
    model = _port_dt(dt_params, dtype="bfloat16")
    with torch.no_grad():
        embs = model.state_encoder(states)
        assert embs.dtype == torch.bfloat16
        direct = make_dt_apply(model)(rtg, states, ts, task, actions)
        cached = make_dt_embed_apply(make_dt_apply(model))(
            rtg, embs, ts, task, actions)
    torch.testing.assert_close(cached.pred_actions, direct.pred_actions,
                               rtol=0, atol=0)


def _records(tmp_path, n=3):
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=n, size=SIZE,
                       seed=21)
    return [JEvaluationDataset(d, rtg_target=10.0)[i] for i in range(n)]


def test_bf16_greedy_eval_within_band(tmp_path, dt_params, unet_sd):
    """A bfloat16 greedy evaluation (8 steps, 3 records; the bfloat16 K1's
    plain version in the U-Net) lands within 0.15 dB of the port's float32
    one and of the JAX package's bfloat16 one."""
    records = _records(tmp_path)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(**CFG_KW, dtype=dtype)
        dt = _port_dt(dt_params, dtype=dtype)
        runs[dtype] = Evaluator(
            dt=dt, denoise=_port_unet(unet_sd, dtype), cfg=cfg,
            max_timesteps=MAXT, device="cpu").evaluate_records(records)
    jcfg = JModelConfig(**CFG_KW, dtype="bfloat16")
    jm = JEvaluator(dt_apply=jdt.make_dt_apply(jcfg), dt_params=dt_params,
                    denoise=_j_denoise(unet_sd, jnp.bfloat16), cfg=jcfg,
                    max_timesteps=MAXT).evaluate_records(records)
    got = runs["bfloat16"]
    assert np.all(got["episode_len"] == MAXT)
    np.testing.assert_array_equal(got["episode_len"],
                                  runs["float32"]["episode_len"])
    np.testing.assert_array_equal(got["episode_len"],
                                  np.asarray(jm["episode_len"]))
    np.testing.assert_allclose(got["reward"], runs["float32"]["reward"],
                               rtol=0, atol=0.15)
    np.testing.assert_allclose(got["reward"], np.asarray(jm["reward"]),
                               rtol=0, atol=0.15)
    assert got["final_state"].x.dtype == torch.float32


def test_bf16_search_runs_like_float32(tmp_path, dt_params, unet_sd):
    """The device search with bfloat16 models on the CPU runs and finishes
    with traces of the float32 search's shape."""
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=2, size=SIZE,
                       seed=31)
    records = [EvaluationDataset(d, rtg_target=5.0, kind="optimal",
                                 image_size=SIZE)[i] for i in range(2)]
    traces, rewards = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = ModelConfig(**CFG_KW, dtype=dtype, use_pallas=True)
        m = DeviceMCTS(dt=_port_dt(dt_params, dtype=dtype, use_pallas=True),
                       denoise=_port_unet(unet_sd, dtype), model_cfg=cfg,
                       cfg=MCTSConfig(iterations=3, max_timesteps=MAXT),
                       value_fn=proxy_value_fn,
                       value_fn_batched=proxy_value_fn_batched,
                       record_trace=True, device="cpu")
        rewards[dtype] = m.run_batch(records, seeds=[0, 1])
        traces[dtype] = m.traces
    assert all(np.isfinite(rewards["bfloat16"]))
    assert len(traces["bfloat16"]) == len(traces["float32"]) == 2
    for a, b in zip(traces["bfloat16"], traces["float32"]):
        assert len(a) == len(b)
        assert [sorted(e) for e in a] == [sorted(e) for e in b]
    np.testing.assert_allclose(rewards["bfloat16"], rewards["float32"],
                               rtol=0, atol=1.0)


def test_bf16_service_matches_greedy_rollout(dt_params, unet_sd):
    """A service built on bfloat16 models serves bfloat16: a full batch
    equals greedy_rollout of the same models, with the forward the service
    picks (the fused one here), on the same batch."""
    dt = _port_dt(dt_params, dtype="bfloat16", use_pallas=True)
    unet = _port_unet(unet_sd, "bfloat16")
    reqs = [RestorationRequest(mat=make_mat_record(size=SIZE, seed=i),
                               rtg=0.6, task=2) for i in range(4)]
    svc = RestorationService(denoise=unet, dt=dt, mode="policy",
                             batch_size=4, max_timesteps=MAXT, device="cpu")
    try:
        results = svc.restore(reqs, timeout=WAIT)
    finally:
        svc.close(timeout=WAIT)
    mats = {k: np.concatenate([np.asarray(r.mat[k]) for r in reqs])
            for k in ("x0", "y0", "mask", "gt")}
    mats["x0"] = np.clip(mats["x0"], 0, None)
    apply, encode = policy_forward(dt, dt.cfg), make_state_encode(dt)
    policy_x0 = torch.from_numpy(np.stack(
        [np.asarray(r.mat["x0"], np.float32)[..., 0].reshape(-1)
         for r in reqs]))
    bufs, _, action_dict, pred_rtg = initial_policy_setup(
        apply, dt.cfg, policy_x0, torch.full((4,), 0.6),
        torch.full((4,), 2), MAXT, encode=encode)
    final, reward, ep_len, _ = greedy_rollout(
        apply, unet, dt.cfg, reset_from_mat(mats, device="cpu"), bufs,
        action_dict, pred_rtg, MAXT, encode=encode,
        dt_embed_apply=make_dt_embed_apply(apply))
    np.testing.assert_array_equal([r.episode_len for r in results],
                                  ep_len.numpy())
    for i, r in enumerate(results):
        np.testing.assert_allclose(r.image, np.clip(final.x[i, 0].numpy(),
                                                    0, 1), rtol=0, atol=1e-5)
    np.testing.assert_allclose([r.psnr_db for r in results],
                               reward[:, 0].numpy(), rtol=1e-5)


@pytest.mark.parametrize("mode", ["none", "s2d", "winograd"])
def test_cli_eval_bfloat16_on_cpu(tmp_path, capsys, mode):
    """eval --dtype bfloat16 --unet_packed <mode> at the published widths
    says which forward, dtype and U-Net mode it runs and prints the
    evaluator's lines."""
    d = write_eval_dir(str(tmp_path / "4_15"), "4_15", n=1, size=128)
    cli.main(["--block_size", "18", "--n_embeds", "9", "--device", "cpu",
              "eval", "--rtg", "10", "--max_timesteps", "6",
              "--checkpoint", str(tmp_path / "n.pt"),
              "--denoiser_ckpt", str(tmp_path / "n.pt"),
              "--dtype", "bfloat16", "--unet_packed", mode,
              "--data_dirs", d])
    r = capsys.readouterr()
    assert f"policy forward: fused (kernel K3); dtype bfloat16, U-Net " \
        f"mode {mode}" in r.err
    lines = dict(ln.rsplit(",", 1) for ln in r.out.splitlines() if "," in ln)
    assert 1 <= float(lines["Average iter"]) <= 6
    assert np.isfinite(float(lines["Average reward"]))


def test_cli_flex_bfloat16_on_cpu(tmp_path, capsys):
    d = write_eval_dir(str(tmp_path / "8_5"), "8_5", n=1, size=128)
    cli.main(["--block_size", "18", "--n_embeds", "6", "--device", "cpu",
              "flex", "--max_timesteps", "6",
              "--checkpoint", str(tmp_path / "n.pt"),
              "--denoiser_ckpt", str(tmp_path / "n.pt"),
              "--dtype", "bfloat16", "--data_dirs", d])
    out = capsys.readouterr().out.splitlines()
    totals = [float(ln.split(":", 1)[1]) for ln in out
              if ln.startswith("Average increment:")]
    assert len(totals) == 5 and all(map(np.isfinite, totals))


def test_loaders_build_dtype_and_mode(tmp_path):
    den = load_denoiser(str(tmp_path / "none.pt"), device="cpu",
                        dtype="bfloat16", packed="s2d")
    assert den.net.dtype == torch.bfloat16 and den.net.packed == "s2d"
    assert den.net.inc.packed == "dense" and den.net.up4.packed is None
    dt = load_dt(ModelConfig(dtype="bfloat16"), str(tmp_path / "none.pt"),
                 device="cpu")
    assert dt.blocks[0].attn.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in dt.parameters())


def test_trainer_refuses_bfloat16_model_config():
    """Training runs the float32 model (under autocast for --dtype
    bfloat16); a model built for bfloat16 inference is refused."""
    model = DecisionTransformer(ModelConfig(**CFG_KW, dtype="bfloat16"))
    with pytest.raises(ValueError, match="dtype='float32'"):
        init_train_state(model, TrainerConfig(), 10)
