"""Plain PyTorch restatements of the reference's inference pipelines, the
yardstick of the real-checkpoint parity harness
(``tools/validate_parity.py``).

These are functional restatements of the documented behaviour of the
reference (eval.py:62-220, mcts.py:212-258,
decision_transformer.py:106-275, env.py:74-100) as pure functions over
explicit state dicts in the reference checkpoint's layout. They share no
code with the port's models and inference loops, so the harness holds
the port to the reference semantics and not to itself. They run on the
CPU in float32.

Counterpart of the JAX package's ``utils/torch_oracle.py``: the same
functions on the same inputs give the same tensors, bit for bit. The U-Net
and ADMM restatements are in :mod:`.torch_reference`.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .torch_reference import torch_denoise

E, HEADS, BLOCKS, ADIM, MAX_TIMESTEP = 128, 4, 5, 3, 30

# Column -> action-key mapping per mode (decision_transformer.py:147-154).
MODE_COLS = {"norm": ("T", "sigma_d", "mu"), "flex": ("mu", "sigma_d", "T")}


def make_dt_state_dict(gen, n_embeds: int = 9) -> Dict[str, torch.Tensor]:
    """A random DT state dict in the reference's parameter layout
    (decision_transformer.py:106-164) — the converter-shaped fixture for
    self-validation when real checkpoints are unavailable."""
    sd = {}

    def lin(name, n_in, n_out):
        sd[name + ".weight"] = 0.05 * torch.randn(n_out, n_in, generator=gen)
        sd[name + ".bias"] = 0.05 * torch.randn(n_out, generator=gen)

    sd["time_embed.weight"] = 0.05 * torch.randn(MAX_TIMESTEP, E,
                                                 generator=gen)
    sd["task_embed.weight"] = 0.05 * torch.randn(n_embeds, E, generator=gen)
    lin("embed_action.0", ADIM, E)
    lin("embed_return.0", 1, E)
    sd["state_encoder.0.weight"] = 0.05 * torch.randn(8, 1, 8, 8,
                                                      generator=gen)
    sd["state_encoder.0.bias"] = 0.05 * torch.randn(8, generator=gen)
    sd["state_encoder.2.weight"] = 0.05 * torch.randn(16, 8, 4, 4,
                                                      generator=gen)
    sd["state_encoder.2.bias"] = 0.05 * torch.randn(16, generator=gen)
    sd["state_encoder.4.weight"] = 0.05 * torch.randn(16, 16, 3, 3,
                                                      generator=gen)
    sd["state_encoder.4.bias"] = 0.05 * torch.randn(16, generator=gen)
    lin("state_encoder.7", 2304, E)
    for i in range(BLOCKS):
        for ln in ("ln1", "ln2"):
            sd[f"transformer.{i}.{ln}.weight"] = 1 + 0.05 * torch.randn(
                E, generator=gen)
            sd[f"transformer.{i}.{ln}.bias"] = 0.05 * torch.randn(
                E, generator=gen)
        lin(f"transformer.{i}.c_att.qkv_proj", E, 3 * E)
        lin(f"transformer.{i}.c_att.o_proj", E, E)
        lin(f"transformer.{i}.mlp.fc", E, 4 * E)
        lin(f"transformer.{i}.mlp.fc_proj", 4 * E, E)
    sd["layer_n.weight"] = 1 + 0.05 * torch.randn(E, generator=gen)
    sd["layer_n.bias"] = 0.05 * torch.randn(E, generator=gen)
    lin("predict_action.0", E, ADIM)
    lin("predict_rtg", E, 1)
    return sd


def torch_dt_forward(sd, rtg, states, timesteps, task, actions, mode):
    """decision_transformer.py:212-275 data flow via torch.nn.functional,
    including the no-MLP-residual quirk (:99-102) and the two-token
    inference mode (actions=None, :233-237)."""
    B, T, _ = states.shape

    def linear(x, name):
        return x @ sd[name + ".weight"].T + sd[name + ".bias"]

    rtg_emb = torch.tanh(linear(rtg, "embed_return.0"))
    x = states.reshape(-1, 1, 128, 128)
    x = F.relu(F.conv2d(x, sd["state_encoder.0.weight"],
                        sd["state_encoder.0.bias"], stride=4))
    x = F.relu(F.conv2d(x, sd["state_encoder.2.weight"],
                        sd["state_encoder.2.bias"], stride=2))
    x = F.relu(F.conv2d(x, sd["state_encoder.4.weight"],
                        sd["state_encoder.4.bias"], stride=1))
    state_emb = torch.tanh(linear(x.flatten(1), "state_encoder.7"))
    state_emb = state_emb.reshape(B, T, E)

    ts = timesteps.to(torch.int64).reshape(B, -1)
    time_emb = sd["time_embed.weight"][ts]
    state_emb = state_emb + sd["task_embed.weight"][task]

    if actions is not None:
        act_emb = torch.tanh(linear(actions, "embed_action.0"))
        tok = torch.zeros(B, 3 * T, E)
        tok[:, ::3] = rtg_emb
        tok[:, 1::3] = state_emb
        tok[:, 2::3] = act_emb
        time_int = torch.repeat_interleave(time_emb, 3, dim=1)
    else:
        tok = torch.zeros(B, 2 * T, E)
        tok[:, ::2] = rtg_emb
        tok[:, 1::2] = state_emb
        time_int = torch.repeat_interleave(time_emb, 2, dim=1)

    x = tok + time_int
    S = x.shape[1]
    mask = torch.tril(torch.ones(S, S)).view(1, 1, S, S)
    for i in range(BLOCKS):
        p = f"transformer.{i}."
        h = F.layer_norm(x, (E,), sd[p + "ln1.weight"], sd[p + "ln1.bias"])
        q, k, v = linear(h, p + "c_att.qkv_proj").split(E, dim=2)
        q = q.view(B, S, HEADS, E // HEADS).transpose(1, 2)
        k = k.view(B, S, HEADS, E // HEADS).transpose(1, 2)
        v = v.view(B, S, HEADS, E // HEADS).transpose(1, 2)
        att = (q @ k.transpose(-1, -2)) / math.sqrt(E // HEADS)
        att = att.masked_fill(mask == 0, float("-inf"))
        att = F.softmax(att, dim=-1)
        y = (att @ v).transpose(1, 2).contiguous().view(B, S, E)
        x = x + linear(y, p + "c_att.o_proj")
        # NOTE: no residual around the MLP (reference quirk, :99-102).
        h = F.layer_norm(x, (E,), sd[p + "ln2.weight"], sd[p + "ln2.bias"])
        x = linear(F.gelu(linear(h, p + "mlp.fc")), p + "mlp.fc_proj")

    x = F.layer_norm(x, (E,), sd["layer_n.weight"], sd["layer_n.bias"])
    stride = 3 if actions is not None else 2
    pred_actions = torch.sigmoid(linear(x[:, 1::stride], "predict_action.0"))
    pred_rtg = linear(x[:, 2::3], "predict_rtg") \
        if actions is not None else None

    # _transform_actions (:266-275): scale sigma_d (column 1 in both
    # modes) by 70/255.
    pred_actions = pred_actions.clone()
    pred_actions[..., 1] *= 70.0 / 255.0
    return pred_actions, pred_rtg


# --- greedy evaluation episode (eval.py:62-220) ---------------------------

def _fft2c(t):
    t = torch.fft.ifftshift(t, dim=(-2, -1))
    t = torch.fft.fftn(t, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(t, dim=(-2, -1))


def _ifft2c(t):
    t = torch.fft.ifftshift(t, dim=(-2, -1))
    t = torch.fft.ifftn(t, dim=(-2, -1), norm="ortho")
    return torch.fft.fftshift(t, dim=(-2, -1))


def torch_psnr(x: np.ndarray, gt: np.ndarray) -> float:
    """torch_psnr semantics (env.py:120-125): clamp to [0,1], scalar
    10*log10(1/mse)."""
    a = np.clip(np.asarray(x, np.float32).reshape(128, 128), 0, 1)
    b = np.clip(np.asarray(gt, np.float32).reshape(128, 128), 0, 1)
    mse = float(np.mean((a - b) ** 2))
    return 10.0 * float(np.log10(1.0 / mse))


def torch_eval_episode(dt_sd, unet_sd, mat, rtg0, task_id,
                       max_timesteps: int = 30, mode: str = "norm",
                       ctx: int = 6) -> Tuple[np.ndarray, int]:
    """The reference's full greedy evaluation for one image, in torch
    (eval.py:62-220 + env.py:74-100). Returns (final real image, episode
    length).

    Takes the RAW mat record: the env consumes x0 clipped at 0 (the
    dataset's record clip, datasets.py:160), while the policy's initial
    observation reads the UNCLIPPED x0 (datasets.py:163 reads mat['x0'],
    untouched by the clip's rebinding).
    """
    # loadmat arrays are F-ordered; view_as_complex needs stride-1 pairs.
    x0 = torch.view_as_complex(
        torch.from_numpy(np.ascontiguousarray(
            np.clip(np.asarray(mat["x0"], np.float32), 0, None)))).reshape(
        1, 1, 128, 128)
    y0 = torch.view_as_complex(
        torch.from_numpy(np.ascontiguousarray(
            np.asarray(mat["y0"], np.float32)))).reshape(
        1, 1, 128, 128)
    mask = torch.from_numpy(np.ascontiguousarray(mat["mask"])).reshape(
        1, 1, 128, 128).bool()
    x, z, u = x0.clone(), x0.clone(), torch.zeros_like(x0)

    def env_step(x, z, u, action):
        if float(action["T"]) > 0.5:
            return x, z, u, True
        xn = torch_denoise(unet_sd, (z - u).real,
                           float(action["sigma_d"])).to(torch.complex64)
        zn = _fft2c(xn + u)
        mu = float(action["mu"])
        temp = (mu * zn + y0) / (1 + mu)
        zn = torch.where(mask, temp, zn)
        zn = _ifft2c(zn)
        un = u + xn - zn
        return xn, zn, un, False

    # Policy buffers (eval.py:62-100).
    states = torch.zeros(1, max_timesteps, 128 * 128)
    actions = torch.zeros(1, max_timesteps, 3)
    rtg = torch.zeros(1, max_timesteps, 1)
    states[0, 0] = torch.from_numpy(
        np.asarray(mat["x0"], np.float32)[..., 0]).reshape(-1)
    rtg[0, 0] = rtg0
    task = torch.full((1, ctx), task_id, dtype=torch.long)
    ts = torch.arange(ctx).reshape(1, ctx, 1)

    cols = MODE_COLS[mode]

    def to_action(vec):
        return {cols[i]: vec[i] for i in range(3)}

    with torch.no_grad():
        pred_actions, _ = torch_dt_forward(
            dt_sd, rtg[:, :ctx], states[:, :ctx], ts, task, None, mode)
        actions[0, 0] = pred_actions[0, 0]
        action = to_action(pred_actions[0, 0])
        _, pred_rtg_all = torch_dt_forward(
            dt_sd, torch.zeros(1, ctx, 1), states[:, :ctx], ts, task,
            torch.zeros(1, ctx, 3), mode)
        pred_rtg = pred_rtg_all[0, 0, 0]

        for t in range(1, max_timesteps + 1):
            x, z, u, done = env_step(x, z, u, action)
            if t == max_timesteps or done:
                return x.real.numpy(), t

            states[0, t] = x.real.reshape(-1)
            rtg[0, t] = pred_rtg

            lo = 0 if t < ctx else t - ctx
            hi = ctx if t < ctx else t
            w_ts = torch.arange(lo, hi).reshape(1, ctx, 1)
            pa, _ = torch_dt_forward(
                dt_sd, rtg[:, lo:hi], states[:, lo:hi], w_ts, task,
                actions[:, lo:hi], mode)
            idx = t if t < ctx else ctx - 1
            actions[0, t] = pa[0, idx]
            action = to_action(pa[0, idx])
            _, pr = torch_dt_forward(
                dt_sd, rtg[:, lo:hi], states[:, lo:hi], w_ts, task,
                actions[:, lo:hi], mode)
            rtg_idx = t if t < ctx else ctx - 2
            pred_rtg = pr[0, rtg_idx, 0]


# --- PUCB tree search (mcts.py:212-258) -----------------------------------

class TEnv:
    def __init__(self, x, z, u, y0, mask, gt):
        self.x, self.z, self.u = x, z, u
        self.y0, self.mask, self.gt = y0, mask, gt


def t_reset(mat) -> TEnv:
    """env.reset on the CLIPPED record (datasets clip x0, env consumes
    it)."""
    def c(arr):
        return torch.view_as_complex(
            torch.from_numpy(np.asarray(arr, np.float32).copy())).reshape(
            1, 1, 128, 128)
    x0 = c(np.clip(np.asarray(mat["x0"], np.float32), 0, None))
    y0 = c(mat["y0"])
    mask = torch.from_numpy(np.asarray(mat["mask"])).reshape(
        1, 1, 128, 128).bool()
    gt = torch.from_numpy(np.asarray(mat["gt"], np.float32)).reshape(
        1, 1, 128, 128)
    return TEnv(x0.clone(), x0.clone(), torch.zeros_like(x0), y0, mask, gt)


def t_step(unet_sd, env: TEnv, action) -> tuple:
    """One reference env.step (env.py:74-100), non-aliasing (the
    reference's D1 state-sharing bug factored out; PARITY.md)."""
    if float(action["T"]) > 0.5:
        return env, True
    xn = torch_denoise(unet_sd, (env.z - env.u).real,
                       float(action["sigma_d"])).to(torch.complex64)
    zn = _fft2c(xn + env.u)
    mu = float(action["mu"])
    temp = (mu * zn + env.y0) / (1 + mu)
    zn = torch.where(env.mask, temp, zn)
    zn = _ifft2c(zn)
    un = env.u + xn - zn
    return TEnv(xn, zn, un, env.y0, env.mask, env.gt), False


def t_sample(loc: float, std: float, z: np.ndarray):
    """sample_action_dict (mcts.py:64-70) with injected raw draws."""
    d = torch.distributions.Normal(float(loc), float(std))
    raw = torch.as_tensor(loc + std * z, dtype=torch.float32)
    action = raw.abs()
    probs = torch.exp(d.log_prob(action))
    probs, idx = torch.sort(probs, descending=True)
    return action[idx].numpy(), probs.numpy()


class TNode:
    def __init__(self, time, prob, parent, edge, index, env, policy_x,
                 policy_rtg):
        self.time, self.prob, self.parent = time, prob, parent
        self.edge, self.index = edge, index
        self.env = env
        self.policy_x = policy_x          # torch (1,1,128,128) real
        self.policy_rtg = float(policy_rtg)
        self.children = []
        self.reward = 0.0
        self.s_visits = 0
        self.action = None

    def __repr__(self):
        return f"Node(time = {self.time}, edge = {self.edge})_{self.index}"

    def backprop(self, reward):
        if reward > self.reward:
            self.reward = reward
            if self.parent is not None:
                self.parent.backprop(reward)


def t_select(parent: TNode) -> TNode:
    """select_p_ucb (mcts.py:74-88)."""
    max_p_ucb, best = -1000.0, parent
    s = parent.s_visits
    for c in parent.children:
        p_ucb = (c.reward - parent.reward) + c.prob * float(
            torch.sqrt(torch.log(torch.Tensor([s])))) / (1 + c.s_visits)
        if not np.isnan(p_ucb) and p_ucb > max_p_ucb:
            best, max_p_ucb = c, p_ucb
    return best


def torch_run_mcts(dt_sd, unet_sd, mat, rtg0, task_id, seed,
                   iterations: int = 30, max_timesteps: int = 30,
                   k: int = 5, ctx: int = 6,
                   value_fn: Optional[Callable[[np.ndarray], float]] = None
                   ) -> Tuple[float, list]:
    """run_mcts (mcts.py:212-258) with D1 factored out; returns
    (final PSNR reward, trace of per-iteration expansion records).

    ``value_fn``: (1, H, W) numpy -> float no-reference score for
    rollouts; defaults to the documented ARNIQA proxy."""
    if value_fn is None:
        from ..models.arniqa import proxy_value_fn
        value_fn = proxy_value_fn
    S = 128 * 128

    def t_build_buffers(node):
        """build_eval/build_action ancestry reconstruction
        (mcts.py:40-59)."""
        states = torch.zeros(1, max_timesteps, S)
        actions = torch.zeros(1, max_timesteps, 3)
        rtg = torch.zeros(1, max_timesteps, 1)
        n = node
        while True:
            states[0, n.time] = n.policy_x.real.reshape(-1)
            rtg[0, n.time, 0] = n.policy_rtg
            if n.time < 1:
                break
            n = n.parent
        n = node.parent
        while n is not None:
            actions[0, n.time] = n.action
            if n.time < 1:
                break
            n = n.parent
        task = torch.full((1, ctx), task_id, dtype=torch.long)
        return states, actions, rtg, task

    cols = MODE_COLS["norm"]

    def t_predict(states, actions, rtg, task, time):
        """predict_action_and_rtg (eval.py:146-186), norm mode; mutates
        ``actions`` at slot ``time`` like the reference."""
        lo, hi = (0, ctx) if time < ctx else (time - ctx, time)
        w_ts = torch.arange(lo, hi).reshape(1, ctx, 1)
        with torch.no_grad():
            pa, _ = torch_dt_forward(dt_sd, rtg[:, lo:hi], states[:, lo:hi],
                                     w_ts, task, actions[:, lo:hi], "norm")
            idx = time if time < ctx else ctx - 1
            actions[0, time] = pa[0, idx]
            _, pr = torch_dt_forward(dt_sd, rtg[:, lo:hi], states[:, lo:hi],
                                     w_ts, task, actions[:, lo:hi], "norm")
        rtg_idx = time if time < ctx else ctx - 2
        vec = pa[0, idx]
        return vec, {cols[i]: float(vec[i]) for i in range(3)}, \
            float(pr[0, rtg_idx, 0])

    rng = np.random.default_rng(seed)
    env = t_reset(mat)
    root = TNode(0, 1.0, None, 0, 0, env, env.x, rtg0)
    root.s_visits = 1
    rewards, states_d, trace = {}, {}, []

    for i in range(iterations):
        root.s_visits += 1
        node = root
        while node.children:
            node = t_select(node)
            node.s_visits += 1

        # EXPAND (expand_tree, mcts.py:103-143).
        states, actions, rtg, task = t_build_buffers(node)
        av, adict, pred_rtg = t_predict(states, actions, rtg, task,
                                        node.time)
        node.action = av
        z = rng.standard_normal(2 * k)
        sigma_d, _ = t_sample(adict["sigma_d"], 0.2, z[:k])
        mu, probs = t_sample(adict["mu"], 0.001, z[k:])
        policy_env, _ = t_step(unet_sd, node.env, adict)
        for c in range(k):
            child_action = {"T": adict["T"], "sigma_d": float(sigma_d[c]),
                            "mu": float(mu[c])}
            child_env, _ = t_step(unet_sd, node.env, child_action)
            node.children.append(TNode(
                node.time + 1, float(probs[c]), node, c, i, child_env,
                policy_env.x, pred_rtg))

        # ROLLOUT (run_beam_search -> run_greedy(no_ref=True)).
        rep = repr(node)
        if rep in rewards:
            reward = rewards[rep]
        else:
            states, actions, rtg, task = t_build_buffers(node)
            _, ad, _ = t_predict(states, actions, rtg, task, node.time)
            env_r, pr = node.env, node.policy_rtg
            for time in range(node.time, max_timesteps + 1):
                env_r, done = t_step(unet_sd, env_r, ad)
                if time == max_timesteps or done:
                    break
                states[0, time] = env_r.x.real.reshape(-1)
                rtg[0, time, 0] = pr
                _, ad, pr = t_predict(states, actions, rtg, task, time)
            x = env_r.x.real.numpy().reshape(1, 128, 128)
            reward = float(value_fn(x))
            rewards[rep] = reward
            states_d[rep] = x
        node.backprop(reward)
        trace.append({"iter": i, "time": node.time, "edge": node.edge,
                      "index": node.index,
                      "probs": [c.prob for c in node.children],
                      "reward": reward})

    best = max(rewards, key=rewards.get)
    x = np.clip(states_d[best], 0, 1)
    gt = np.asarray(mat["gt"], np.float32).reshape(1, 128, 128)
    mse = float(np.mean((np.clip(gt, 0, 1) - x) ** 2))
    return 10.0 * np.log10(1.0 / mse), trace
